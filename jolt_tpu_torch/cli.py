"""Command-line entry points of the port.

    python -m jolt_tpu_torch.cli surge-bench --nv 20 [--nv-hi 24]
        [--prover-runs 10] [--verifier-runs 50] [--device cuda|cpu]
    python -m jolt_tpu_torch.cli [--trace DIR] COMMAND ...
    python -m jolt_tpu_torch.cli prove-fib [--n 8] [--pcs mock|hyperkzg]
        [--device cuda|cpu] [--profile]
    python -m jolt_tpu_torch.cli prove-sha2-chain [--iters 1]
        [--pcs mock|hyperkzg] [--device cuda|cpu]
    python -m jolt_tpu_torch.cli prove-guest --guest GUEST [--n 1]
        [--pcs mock|hyperkzg] [--device cuda|cpu]
    python -m jolt_tpu_torch.cli analyze [--guest sha2-chain] [--n 1]
    python -m jolt_tpu_torch.cli pcs-bench [--pcs hyperkzg|zeromorph|hyrax]
        [--logn 12] [--device cuda|cpu]
    python -m jolt_tpu_torch.cli new NAME [--pcs mock|hyperkzg]

`surge-bench` is the fork's headline benchmark (bench.rs:109-210), as
jolt_tpu's `cli.py surge-bench` runs it: Surge XOR lookups with C = 4,
M = 2^16 and a real HyperKZG SRS sized for the largest nv; random operands
from numpy's default_rng(0); `--prover-runs` averaged prove times and
`--verifier-runs` averaged verify times.  One JSON line per nv, with the
JAX CLI's keys and the device's name.  `proof_size_bytes` is the length of
the proof's arkworks bytes (utils/ark_proof.py: `serialize_surge_proof`;
for the VM, `serialize_jolt_hyperkzg_proof`, proof and commitments), the
size the reference's bench prints; it is null for the mock PCS, whose
proofs hold no curve points.  `prove-guest` proves one of GUESTS on
rv32i_vm() and checks its output against the guest's host oracle;
`analyze` prints a guest's trace length and per-opcode histogram.
`prove-sha2-chain` and `prove-guest` (and `prove-fib` with `--profile`)
turn on the profiling spans (utils/profiling.py) and print their table
(span, calls, total seconds, Mmuls/s, % of the roofline) before the JSON
line.  `--trace DIR` runs the command under torch.profiler and writes
DIR/trace.json (Chrome trace format; the spans appear as ranges over the
kernels they launched).
`pcs-bench` times one commitment scheme's setup and commit of a 2^logn
polynomial (benches/pcs_bench.rs; jolt_tpu's cli.py:85-114): values below
2^63 from default_rng(0), one commit with its first-call costs, then a
warm one; its JSON line adds the peak device memory and the SHA-256 of the
commitment's points (x || y, as convert.py writes them).  `new` scaffolds
a guest and host project (the reference's `jolt new`, src/main.rs:48-100;
jolt_tpu's cli.py:327-414): guest.py, host.py and README.md in a new
directory NAME; `python host.py` there proves and verifies the guest
through `sdk.build_provable`, on the card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from ._device import resolve_device
from .commitment.hyperkzg import HyperKZG
from .commitment.hyrax import HyraxScheme
from .commitment.mock import MockCommitmentScheme
from .commitment.zeromorph import Zeromorph
from .convert import points_to_numpy
from .field import device as fd
from .field.spec import fr_spec
from .instructions import AddInstruction, BneInstruction, XorInstruction
from .lasso import SurgePreprocessing, surge_prove, surge_verify
from .subtables.rv32i import (EqSubtable, IdentitySubtable,
                              TruncateOverflowSubtable)
from .utils import profiling
from .utils.ark_proof import jolt_proof_bytes, serialize_surge_proof
from .vm import guests
from .vm.analyze import trace_analyze
from .vm.guests import SHA2_INPUT, sha2_chain_expected, sha2_chain_program
from .vm.host import fibonacci_program, trace_program
from .vm.rv32i_vm import mini_vm, rv32i_vm

SURGE_C = 4
SURGE_M = 1 << 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def surge_inputs(rng: np.random.Generator, nv: int):
    """x, y operands of one nv rung, as cli.py:289-293 draws them."""
    n = 1 << nv
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    return x, y


def surge_setup(max_nv: int, device=None):
    """(preprocessing, pcs) for Surge XOR at C = 4, M = 2^16 with an SRS of
    max(2^max_nv, M) points, on `device` (default: the CUDA card)."""
    dev = resolve_device(device)
    pre = SurgePreprocessing(XorInstruction, SURGE_C, SURGE_M, fr_spec(), dev)
    pcs = HyperKZG.setup(max(1 << max_nv, SURGE_M), device=dev)
    _sync(dev)
    return pre, pcs


def surge_bench(nv_list, prover_runs: int = 10, verifier_runs: int = 50,
                device=None):
    """Yield one result dict per nv (prove and verify averages, seconds)."""
    dev = resolve_device(device)
    pre, pcs = surge_setup(max(nv_list), dev)
    rng = np.random.default_rng(0)
    for nv in nv_list:
        x, y = surge_inputs(rng, nv)
        total = 0.0
        proof = transcript = None
        for _ in range(max(1, prover_runs)):
            t0 = time.perf_counter()
            proof, transcript, _ = surge_prove(pre, pcs, x, y)
            _sync(dev)
            total += time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(max(1, verifier_runs)):
            surge_verify(pre, proof, debug_transcript=transcript)
        verify_avg = (time.perf_counter() - t0) / max(1, verifier_runs)
        yield {
            "surge_xor_nv": nv,
            "prover_runs": prover_runs,
            "prove_seconds_avg": total / max(1, prover_runs),
            "proof_size_bytes": len(serialize_surge_proof(
                proof, pre.num_memories)),
            "verifier_runs": verifier_runs,
            "verify_seconds_avg": verify_avg,
            "device": device_name(dev),
        }


def fib_vm(M: int = 1 << 8):
    """The mini VM that proves fibonacci: ADD and BNE, C = 4, M = M."""
    return mini_vm([AddInstruction, BneInstruction],
                   [TruncateOverflowSubtable(32), IdentitySubtable(),
                    EqSubtable()], M_mini=M)


def _prove_verify(vm, program, pcs_name: str, dev: torch.device,
                  **trace_args) -> tuple[dict, bytes]:
    """Trace `program`, prove it and verify the proof on `dev`; returns the
    trace length, the timings (seconds) and the proof's arkworks size (null
    for the mock PCS), and the program's output bytes."""
    steps, io, rows = trace_program(program, vm, **trace_args)
    if pcs_name == "hyperkzg":
        pcs = HyperKZG.setup(vm.required_srs_len(io, steps, rows), device=dev)
    else:
        pcs = MockCommitmentScheme()
    pre = vm.preprocess(rows, pcs, device=dev)
    t0 = time.perf_counter()
    proof, commitments, _, _ = vm.prove(io, steps, pre)
    _sync(dev)
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vm.verify(pre, proof, commitments)
    verify_s = time.perf_counter() - t0
    size = len(jolt_proof_bytes(vm, pre, proof, commitments)) \
        if pcs_name == "hyperkzg" else None
    return {"trace_length": len(steps), "pcs": pcs_name,
            "prove_seconds": prove_s, "verify_seconds": verify_s,
            "proof_size_bytes": size,
            "device": device_name(dev)}, bytes(io.outputs)


def prove_fib(n: int = 8, pcs_name: str = "mock", M: int = 1 << 8,
              device=None):
    """Trace fibonacci(n), prove it on the mini VM and verify the proof;
    returns the timings (seconds) as a dict."""
    res, _ = _prove_verify(fib_vm(M), fibonacci_program(n), pcs_name,
                           resolve_device(device), max_input_size=32,
                           max_output_size=32)
    return {"fib_n": n, **res}


def prove_sha2_chain(iters: int = 1, pcs_name: str = "mock", device=None):
    """Trace sha2-chain(iters) on the input 0x05 x 32, check its output
    against hashlib, prove it on rv32i_vm() and verify the proof; returns
    the timings (seconds) as a dict."""
    res, outputs = _prove_verify(rv32i_vm(), sha2_chain_program(iters),
                                 pcs_name, resolve_device(device),
                                 inputs=SHA2_INPUT)
    if outputs[:32] != sha2_chain_expected(SHA2_INPUT, iters):
        raise AssertionError("sha2-chain: the guest's output is not hashlib's")
    return {"sha2_chain_iters": iters, **res}


def _le32(v: int) -> bytes:
    return v.to_bytes(4, "little")


# name -> (program of n, inputs, expected output of n); jolt_tpu's
# cli.py:176-259 guests and their output checks
GUESTS = {
    "collatz": (guests.collatz_program, b"",
                lambda n: _le32(guests.collatz_expected(n))),
    "sha3-chain": (guests.sha3_chain_program, SHA2_INPUT,
                   lambda n: guests.sha3_chain_expected(SHA2_INPUT, n)),
    "alloc": (guests.alloc_sum_program, b"",
              lambda n: _le32(guests.alloc_sum_expected(n))),
    "multi-function": (guests.multi_function_program, b"",
                       lambda n: _le32(guests.multi_function_expected(n))),
    "stdlib": (guests.stdlib_program, b"", guests.stdlib_expected),
    "muldiv": (lambda n: guests.muldiv_program(), b"",
               lambda n: _le32(guests.muldiv_expected())),
    "fibonacci": (fibonacci_program, b"", None),
    "sha2-ex": (lambda n: sha2_chain_program(1), SHA2_INPUT,
                lambda n: sha2_chain_expected(SHA2_INPUT, 1)),
    "sha3-ex": (lambda n: guests.sha3_chain_program(1), SHA2_INPUT,
                lambda n: guests.sha3_chain_expected(SHA2_INPUT, 1)),
    "sha2-chain": (sha2_chain_program, SHA2_INPUT,
                   lambda n: sha2_chain_expected(SHA2_INPUT, n)),
}


def prove_guest(guest: str, n: int = 1, pcs_name: str = "mock",
                device=None):
    """Trace one of GUESTS (n iterations, or collatz's start value), prove
    it on rv32i_vm() and verify the proof; raises if the guest's output is
    not its host oracle's.  Returns the timings (seconds) as a dict."""
    build, inputs, expected = GUESTS[guest]
    res, outputs = _prove_verify(rv32i_vm(), build(n), pcs_name,
                                 resolve_device(device), inputs=inputs)
    if expected is not None:
        want = expected(n)
        if outputs[:len(want)] != want:
            raise AssertionError(f"{guest}: the guest's output is not its "
                                 "oracle's")
    return {"guest": guest, "n": n, **res}


def analyze(guest: str = "sha2-chain", n: int = 1) -> dict:
    """A guest's trace length and per-opcode counts (host/analyze.rs:27-44),
    traced by the native tracer."""
    build, inputs, _ = GUESTS[guest]
    summary = trace_analyze(build(n), rv32i_vm(), inputs=inputs)
    return {"guest": guest, "n": n, "trace_length": summary.trace_len(),
            "opcodes": {op.name: k for op, k in summary.analyze()}}


PCS = {"hyperkzg": HyperKZG, "zeromorph": Zeromorph, "hyrax": HyraxScheme}


def pcs_poly(n: int, device, seed: int = 0) -> torch.Tensor:
    """pcs-bench's polynomial: n values in [1, 2^63) from
    default_rng(seed), as jolt_tpu's cli.py:104-105 draws them, in
    Montgomery form on `device`."""
    rng = np.random.default_rng(seed)
    return fd.u64_to_mont_device(
        fr_spec(), rng.integers(1, 1 << 63, size=n, dtype=np.uint64), device)


def pcs_bench(pcs_name: str = "hyperkzg", logn: int = 12, device=None
              ) -> dict:
    """Setup, cold commit and warm commit seconds of one scheme at 2^logn,
    the peak device memory (bytes; null on the CPU) and the commitment's
    SHA-256."""
    dev = resolve_device(device)
    n = 1 << logn
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pcs = PCS[pcs_name].setup(n, device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    poly = pcs_poly(n, dev)
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        com = pcs.commit(poly)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
    pts = com.row_commitments if pcs_name == "hyrax" else [com.point]
    return {"pcs": pcs_name, "logn": logn, "setup_seconds": setup_s,
            "commit_seconds_cold": secs[0], "commit_seconds_warm": secs[1],
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None,
            "commitment_sha256": hashlib.sha256(
                points_to_numpy(pts).tobytes()).hexdigest(),
            "device": device_name(dev)}


_GUEST_TEMPLATE = '''\
"""Guest program for {name} — RV32IM via the jolt_tpu_torch mini-assembler.

The reference's `jolt new` scaffolds a Rust guest crate with a
`#[jolt::provable]` fn (src/main.rs:48-100); here the guest is an
assembled RV32IM program.  Raw ELF bytes (any RV32IM toolchain output)
work too — pass them straight to build_provable.
"""
from jolt_tpu_torch.vm.host import Assembler


def program(n: int = 8):
    """fib(n): result left in x2."""
    asm = Assembler()
    asm.addi(2, 0, 0)   # a = 0
    asm.addi(3, 0, 1)   # b = 1
    asm.addi(1, 0, 0)   # i = 0
    asm.addi(4, 0, n)   # n
    asm.label("loop")
    asm.add(5, 2, 3)    # t = a + b
    asm.add(2, 3, 0)    # a = b
    asm.add(3, 5, 0)    # b = t
    asm.addi(1, 1, 1)   # i += 1
    asm.bne(1, 4, "loop")
    asm.label("halt")
    asm.jal(0, "halt")  # PC repeat => trace termination
    return asm.finish()
'''

_HOST_TEMPLATE = '''\
"""Host for {name}: build, prove, verify (the reference host crate's
main.rs analog — macro output shape per jolt-sdk/macros/src/lib.rs:89-131).
"""
from jolt_tpu_torch.sdk import build_provable

from guest import program


def main():
    prove, verify = build_provable(program(), pcs="{pcs}")
    outputs, artifacts = prove(b"")
    print(f"trace length: {{artifacts.trace_length}}")
    assert verify(artifacts), "proof rejected"
    print("proof verified")


if __name__ == "__main__":
    main()
'''

_README_TEMPLATE = '''\
# {name}

A jolt_tpu_torch guest/host project (scaffolded by `python -m jolt_tpu_torch.cli new`).

- `guest.py` — the RV32IM guest program (mini-assembler; raw ELF bytes from
  any RV32IM toolchain also work).
- `host.py` — proves and verifies one execution:

      python host.py
'''

SCAFFOLD = {"guest.py": _GUEST_TEMPLATE, "host.py": _HOST_TEMPLATE,
            "README.md": _README_TEMPLATE}


def new_project(path: str, pcs: str = "hyperkzg") -> list[str]:
    """Write the guest and host project into the new directory `path`;
    returns the files written.  Refuses a path that exists."""
    if os.path.exists(path):
        raise SystemExit(f"{path!r} already exists")
    os.makedirs(path)
    ctx = {"name": os.path.basename(os.path.normpath(path)), "pcs": pcs}
    for fname, template in SCAFFOLD.items():
        with open(os.path.join(path, fname), "w") as f:
            f.write(template.format(**ctx))
    return list(SCAFFOLD)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m jolt_tpu_torch.cli")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the command to "
                    "DIR/trace.json (Chrome trace format)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sb = sub.add_parser("surge-bench", help="Surge XOR lookups, C=4, M=2^16")
    sb.add_argument("--nv", type=int, default=20)
    sb.add_argument("--nv-hi", type=int, default=None)
    sb.add_argument("--prover-runs", type=int, default=10)
    sb.add_argument("--verifier-runs", type=int, default=50)
    sb.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    pf = sub.add_parser("prove-fib", help="prove + verify fibonacci(n) on "
                        "the mini VM")
    pf.add_argument("--n", type=int, default=8)
    pf.add_argument("--pcs", choices=("mock", "hyperkzg"), default="mock")
    pf.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pf.add_argument("--profile", action="store_true",
                    help="print the cumulative span table")
    ps = sub.add_parser("prove-sha2-chain", help="prove + verify the "
                        "sha2-chain guest on the full RV32I VM")
    ps.add_argument("--iters", type=int, default=1)
    ps.add_argument("--pcs", choices=("mock", "hyperkzg"), default="mock")
    ps.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pg = sub.add_parser("prove-guest", help="prove + verify an example "
                        "guest on the full RV32I VM")
    pg.add_argument("--guest", choices=tuple(GUESTS), default="collatz")
    pg.add_argument("--n", type=int, default=1,
                    help="iterations (chains) or start value (collatz)")
    pg.add_argument("--pcs", choices=("mock", "hyperkzg"), default="mock")
    pg.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    an = sub.add_parser("analyze", help="a guest's per-opcode histogram")
    an.add_argument("--guest", choices=tuple(GUESTS), default="sha2-chain")
    an.add_argument("--n", type=int, default=1)
    pb = sub.add_parser("pcs-bench", help="one commitment scheme's setup "
                        "and commit of a 2^logn polynomial")
    pb.add_argument("--pcs", choices=tuple(PCS), default="hyperkzg")
    pb.add_argument("--logn", type=int, default=12)
    pb.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    nw = sub.add_parser("new", help="scaffold a guest and host project")
    nw.add_argument("name")
    nw.add_argument("--pcs", choices=("mock", "hyperkzg"), default="hyperkzg")
    args = ap.parse_args(argv)
    if args.trace:
        with profiling.trace(args.trace):
            _run(args)
    else:
        _run(args)


def _run(args) -> None:
    """Run one parsed command, printing one JSON line per result; the
    proving commands print the span table before it (prove-fib with
    --profile)."""
    spans = args.cmd in ("prove-sha2-chain", "prove-guest") or \
        getattr(args, "profile", False)
    if args.cmd == "new":
        files = new_project(args.name, args.pcs)
        print(f"created {args.name}/: {' '.join(files)}", flush=True)
        return
    profiling.reset()
    profiling.enable(spans)
    try:
        if args.cmd == "pcs-bench":
            rows = [pcs_bench(args.pcs, args.logn, device=args.device)]
        elif args.cmd == "prove-guest":
            rows = [prove_guest(args.guest, args.n, args.pcs,
                                device=args.device)]
        elif args.cmd == "analyze":
            rows = [analyze(args.guest, args.n)]
        elif args.cmd == "prove-fib":
            rows = [prove_fib(args.n, args.pcs, device=args.device)]
        elif args.cmd == "prove-sha2-chain":
            rows = [prove_sha2_chain(args.iters, args.pcs,
                                     device=args.device)]
        else:
            nv_list = list(range(args.nv, (args.nv_hi or args.nv) + 1))
            rows = surge_bench(nv_list, args.prover_runs,
                               args.verifier_runs, args.device)
    finally:
        profiling.enable(False)
    if spans:
        profiling.print_cumulative()
    for row in rows:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
