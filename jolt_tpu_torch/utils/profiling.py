"""Profiling spans and cumulative timing: the counterpart of
jolt_tpu/utils/profiling.py.

Reference: `#[tracing::instrument]` spans on every significant function and
the `CumulativeTimingLayer` that sums same-name span durations
(jolt-core/src/benches/sum_timer.rs:12-118).

Usage:
    enable()
    with span("InstructionLookupsProof::prove"):
        ...
    print_cumulative()      # span, calls, total seconds, Mmuls/s, %roof

Spans are off by default, and an off span costs one boolean test: no
device sync, no profiler call.  An enabled span calls
`torch.cuda.synchronize()` on entry and on exit when CUDA is initialized,
so its seconds include the device work it queued, and it opens a
`torch.profiler.record_function(name)` range (jolt_tpu's
`jax.named_scope`), so a `trace()` shows the kernels under the span's
name.  Spans nest; each name sums its own calls.  JOLT_SPAN_LOG=1 prints
each span's entry and exit to stderr as it happens.

`trace(log_dir)` is the counterpart of `jax_trace`: a torch.profiler
trace of the region, written as Chrome trace JSON.  jolt_tpu's
`count_programs`/`program_stats` count XLA program loads, which the port
does not have: it compiles its kernels once per source, ahead of time, and
counts their launches instead (`_native.launch_counts`,
`reset_launch_counts`).
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import defaultdict

import torch

_lock = threading.Lock()
_totals: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_ops: dict[str, int] = defaultdict(int)
_enabled = False

# Roofline ceiling for the Mmuls/s column, in field multiplies per second:
# the H100's INT32 multiply rate, 64 per clock per SM x 132 SMs x 1,980 MHz
# = 1.673e13 32-bit multiplies/s, over the 264 32-bit multiplies of one
# CIOS Montgomery product of 8 words (PERF.md's kernel bounds use the same
# constants): 1.673e13 / 264 = 6.34e10 field multiplies/s.  Override per
# card with set_peak_ops().
_peak_ops_per_s = 64 * 132 * 1.98e9 / 264

TRACE_FILE = "trace.json"


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def set_peak_ops(ops_per_s: float) -> None:
    """Set the roofline denominator (field multiplies per second)."""
    global _peak_ops_per_s
    _peak_ops_per_s = ops_per_s


def reset() -> None:
    with _lock:
        _totals.clear()
        _counts.clear()
        _ops.clear()


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Span:
    """One enabled span: synced and timed, under a profiler range."""

    __slots__ = ("name", "ops", "live", "t0", "range")

    def __init__(self, name: str, ops: int):
        self.name, self.ops = name, ops

    def __enter__(self):
        self.live = os.environ.get("JOLT_SPAN_LOG", "") not in ("", "0")
        if self.live:
            print(f"[span] > {self.name}", file=sys.stderr, flush=True)
        _sync()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        if self.live:
            print(f"[span] < {self.name} {dt:.2f}s", file=sys.stderr,
                  flush=True)
        with _lock:
            _totals[self.name] += dt
            _counts[self.name] += 1
            _ops[self.name] += self.ops
        return False


_OFF = contextlib.nullcontext()


def span(name: str, ops: int = 0):
    """A context manager timing a region, cumulative per name.

    ``ops``: the field multiplies the region performs, summed per name and
    reported as achieved Mmuls/s and % of the roofline."""
    if not _enabled:
        return _OFF
    return _Span(name, ops)


def cumulative() -> list[tuple[str, int, float, int]]:
    """(name, calls, total seconds, ops) per span name, slowest first."""
    with _lock:
        rows = [(k, _counts[k], _totals[k], _ops[k]) for k in _totals]
    return sorted(rows, key=lambda r: -r[2])


def print_cumulative() -> None:
    rows = cumulative()
    if not rows:
        return
    width = max(len(r[0]) for r in rows)
    print(f"{'span'.ljust(width)}  calls  total_s  Mmuls/s  %roof")
    for name, calls, total, ops in rows:
        if ops and total > 0:
            rate = ops / total
            print(f"{name.ljust(width)}  {calls:5d}  {total:8.3f}"
                  f"  {rate / 1e6:7.1f}  {100 * rate / _peak_ops_per_s:5.1f}")
        else:
            print(f"{name.ljust(width)}  {calls:5d}  {total:8.3f}"
                  f"  {'-':>7}  {'-':>5}")


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the region (CPU, and CUDA where there is
    a card), written to `<log_dir>/trace.json` in Chrome trace format (the
    reference's tracing-chrome layer, jolt-core/src/main.rs:96).  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
