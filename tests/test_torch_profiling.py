"""The port's profiling spans (jolt_tpu_torch/utils/profiling.py) against
jolt_tpu's span semantics, and its trace.

- A disabled span is a no-op: it records nothing and neither syncs the
  device nor opens a profiler range.
- An enabled span sums seconds, calls and ops per name; spans nest; the
  table has jolt_tpu's columns and turns ops into Mmuls/s and % of the
  roofline; `reset` clears it.  With CUDA initialized, an enabled span
  syncs the device on entry and on exit.
- `trace()` writes a Chrome trace that parses as JSON and holds the span
  and the op under it; `cli.py --trace DIR analyze` writes one.
- The roofline default is the H100's INT32 Montgomery rate, and no port
  source carries jolt_tpu's TPU figure.

The span parity with jolt_tpu on a whole prove is in tests/test_torch_vm.py.
"""
import json
import re
from pathlib import Path

import pytest
import torch

from jolt_tpu_torch import cli
from jolt_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    profiling.enable(False)
    yield
    profiling.reset()
    profiling.enable(False)
    profiling.set_peak_ops(64 * 132 * 1.98e9 / 264)


@pytest.fixture
def syncs(monkeypatch):
    """Counts device syncs, with CUDA reported initialized."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    return calls


def test_a_disabled_span_records_nothing_and_never_syncs(syncs):
    opened = []
    real = torch.profiler.record_function
    torch.profiler.record_function = lambda *a: opened.append(a) or real(*a)
    try:
        with profiling.span("off", ops=5):
            pass
    finally:
        torch.profiler.record_function = real
    assert profiling.cumulative() == []
    assert syncs == [] and opened == []
    assert profiling.span("a") is profiling.span("b")   # one shared no-op


def test_an_enabled_span_syncs_on_entry_and_exit(syncs):
    profiling.enable()
    with profiling.span("x"):
        assert len(syncs) == 1
    assert len(syncs) == 2


def test_spans_nest_and_sum_per_name():
    profiling.enable()
    for _ in range(3):
        with profiling.span("outer", ops=10):
            with profiling.span("inner", ops=2):
                pass
            with profiling.span("inner", ops=2):
                pass
    rows = {name: (calls, secs, ops)
            for name, calls, secs, ops in profiling.cumulative()}
    assert sorted(rows) == ["inner", "outer"]
    assert rows["outer"][0] == 3 and rows["outer"][2] == 30
    assert rows["inner"][0] == 6 and rows["inner"][2] == 12
    assert rows["outer"][1] >= rows["inner"][1] >= 0
    names = [r[0] for r in profiling.cumulative()]
    assert names == ["outer", "inner"]              # slowest first
    profiling.reset()
    assert profiling.cumulative() == []


def test_an_exception_still_closes_the_span():
    profiling.enable()
    with pytest.raises(KeyError):
        with profiling.span("raises", ops=1):
            raise KeyError
    assert [r[:2] for r in profiling.cumulative()] == [("raises", 1)]


def test_the_table_turns_ops_into_mmuls_and_roofline(capsys):
    profiling.enable()
    profiling.set_peak_ops(4e6)
    with profiling.span("counted", ops=2_000_000):
        pass
    with profiling.span("uncounted"):
        pass
    profiling._totals["counted"] = 0.5          # 4e6 muls/s: 100 % of 4e6
    profiling.print_cumulative()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["span", "calls", "total_s", "Mmuls/s",
                                "%roof"]
    row = dict((ln.split()[0], ln.split()[1:]) for ln in lines[1:])
    assert row["counted"] == ["1", "0.500", "4.0", "100.0"]
    assert row["uncounted"][0] == "1" and row["uncounted"][2:] == ["-", "-"]


def test_the_live_log(monkeypatch, capsys):
    monkeypatch.setenv("JOLT_SPAN_LOG", "1")
    profiling.enable()
    with profiling.span("logged"):
        pass
    err = capsys.readouterr().err.splitlines()
    assert err[0] == "[span] > logged"
    assert re.fullmatch(r"\[span\] < logged \d+\.\d\ds", err[1])


def test_the_roofline_is_the_h100s_montgomery_rate():
    assert profiling._peak_ops_per_s == pytest.approx(6.336e10, rel=1e-3)
    tpu_figure = re.compile(r"4\.9e8|490M|v5e")
    offenders = [str(p.relative_to(ROOT)) for p in
                 sorted((ROOT / "jolt_tpu_torch").rglob("*.py"))
                 if tpu_figure.search(p.read_text())]
    assert offenders == []


def _events(path: Path) -> list:
    data = json.loads(path.read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    profiling.enable()
    a = torch.arange(64, dtype=torch.int64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("traced::span"):
            (a * 3).sum()
    assert prof is not None
    names = {e.get("name") for e in _events(tmp_path / profiling.TRACE_FILE)}
    assert "traced::span" in names
    assert any(n and n.startswith("aten::") for n in names)


def test_cli_trace_writes_a_trace(tmp_path, capsys):
    cli.main(["--trace", str(tmp_path / "tr"), "analyze", "--guest",
              "collatz", "--n", "7"])
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1])["guest"] == "collatz"
    assert isinstance(_events(tmp_path / "tr" / profiling.TRACE_FILE), list)
