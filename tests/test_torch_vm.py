"""The port's Jolt VM prover and verifier against jolt_tpu's.

fibonacci(3) on the mini VM (ADD, BNE over TruncateOverflow(32), Identity,
Eq; C = 4, M = 2^8, 32-byte I/O), proved by the port on the CPU in three
cases: the mock PCS, HyperKZG over a 2^8-point SRS, and the mock PCS under
JOLT_REFERENCE_PARITY=1.  Each transcript's state_history and each
commitment must equal jolt_tpu's, frozen in fixtures/port/fib3_<case>.npz
by scripts/freeze_port_fixtures.py (a live jolt_tpu prove takes minutes of
XLA compiles; the `slow` test recomputes them live).  The port's verifier
must accept each proof and reject it with one opening bumped by one.  The
tolerance is zero.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu_torch import cli
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
from jolt_tpu_torch.vm import fixtures as fx
from jolt_tpu_torch.vm.host import fibonacci_program, trace_program

ROOT = Path(__file__).resolve().parents[1]
CASES = ("mock", "hyperkzg", "parity")


def _freeze_script():
    """scripts/freeze_port_fixtures.py, which drives jolt_tpu."""
    spec = importlib.util.spec_from_file_location(
        "freeze_port_fixtures", ROOT / "scripts" / "freeze_port_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CASES)
def fib3(request):
    case = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("JOLT_REFERENCE_PARITY", "1" if case == "parity" else "0")
    vm = cli.fib_vm(fx.M_MINI)
    steps, io, rows = trace_program(fibonacci_program(fx.FIB_N), vm,
                                    max_input_size=32, max_output_size=32)
    pcs = HyperKZG.setup(fx.SRS_LEN, device="cpu") \
        if case == "hyperkzg" else MockCommitmentScheme()
    pre = vm.preprocess(rows, pcs, device="cpu")
    proof, commitments, transcript, acc = vm.prove(io, steps, pre)
    yield dict(case=case, vm=vm, pre=pre, proof=proof,
               commitments=commitments, transcript=transcript, acc=acc)
    mp.undo()


def test_transcript_and_commitments_match_jolt_tpu(fib3):
    got = fx.proof_arrays(fib3["transcript"], fib3["commitments"])
    with np.load(ROOT / "fixtures" / "port" / f"fib3_{fib3['case']}.npz") as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert (got[k] == want[k]).all(), k


def test_verifier_accepts_and_rejects_a_bumped_opening(fib3):
    vm, pre, proof, com = (fib3[k] for k in ("vm", "pre", "proof",
                                             "commitments"))
    vm.verify(pre, proof, com, debug_transcript=fib3["transcript"],
              debug_accumulator=fib3["acc"])
    ops = proof.read_write_memory.output_proof
    good = ops.opening
    ops.opening = good + FElt(1, fr_spec())
    try:
        with pytest.raises(VerificationError):
            vm.verify(pre, proof, com)
    finally:
        ops.opening = good


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES)
def test_frozen_fixtures_match_a_live_jolt_tpu_prove(case):
    """jolt_tpu proves fib(3) live (minutes of XLA compiles per case)."""
    want = _freeze_script().prove_case(case)
    with np.load(ROOT / "fixtures" / "port" / f"fib3_{case}.npz") as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert (z[k] == want[k]).all(), k
