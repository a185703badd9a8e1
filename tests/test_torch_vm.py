"""The port's Jolt VM prover and verifier against jolt_tpu's.

fibonacci(3) on the mini VM (ADD, BNE over TruncateOverflow(32), Identity,
Eq; C = 4, M = 2^8, 32-byte I/O), proved by the port on the CPU in three
cases: the mock PCS, HyperKZG over a 2^8-point SRS, and the mock PCS under
JOLT_REFERENCE_PARITY=1.  Each transcript's state_history and each
commitment must equal jolt_tpu's, frozen in fixtures/port/fib3_<case>.npz
by scripts/freeze_port_fixtures.py (a live jolt_tpu prove takes minutes of
XLA compiles; the `slow` test recomputes them live).  The port's verifier
must accept each proof and reject it with one opening bumped by one.

Each prove runs with the profiling spans on: every span's name, calls
and ops count must equal jolt_tpu's, frozen in fixtures/port/fib3_spans.json
from the mock case (the transcripts above show that the spans change no
byte).

The proof bytes: each proof's `proof_size_bytes`, and the HyperKZG proof's
canonical bytes (SHA-256 and length), must equal jolt_tpu's, frozen in
fixtures/port/fib3_proof_bytes.json; its arkworks bytes must equal
fixtures/ark/fib_mini.bin (jolt_tpu's tests/test_ark_proof.py freezes
them from the same configuration), and both packages' structure readers
must agree on them; jolt_tpu's reader must read the port's canonical
bytes and write them back unchanged, and the port's verifier must accept
the proof read back from them.  The mock proofs hold no curve points, so
both byte serializers refuse them (jolt_tpu's as well).  The tolerance is
zero.
"""
import hashlib
import importlib.util
import json
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
from jolt_tpu_torch.utils import profiling
from jolt_tpu_torch.utils import serialization as ser
from jolt_tpu_torch.utils.ark_proof import (deserialize_jolt_proof_structure,
                                            jolt_proof_bytes)
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
    profiling.reset()
    profiling.enable()
    try:
        pre = vm.preprocess(rows, pcs, device="cpu")
        proof, commitments, transcript, acc = vm.prove(io, steps, pre)
    finally:
        profiling.enable(False)
    spans = sorted([name, calls, ops]
                   for name, calls, _, ops in profiling.cumulative())
    yield dict(case=case, vm=vm, pre=pre, proof=proof,
               commitments=commitments, transcript=transcript, acc=acc,
               spans=spans)
    mp.undo()


def test_transcript_and_commitments_match_jolt_tpu(fib3):
    got = fx.proof_arrays(fib3["transcript"], fib3["commitments"])
    with np.load(ROOT / "fixtures" / "port" / f"fib3_{fib3['case']}.npz") as z:
        want = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert (got[k] == want[k]).all(), k


def test_spans_match_jolt_tpus(fib3):
    """The prove ran with the profiling spans on (and its transcript still
    equals jolt_tpu's, above): each span's name, calls and ops count equal
    jolt_tpu's for the mock case's preprocessing and prove, frozen in
    fixtures/port/fib3_spans.json.  The three cases prove the same shapes,
    so each gives the same rows."""
    want = json.loads((ROOT / "fixtures" / "port" / "fib3_spans.json")
                      .read_text())["rows"]
    assert len(want) == 12
    assert fib3["spans"] == want


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


# ---------------------------------------------------------------------------
# proof bytes
# ---------------------------------------------------------------------------

def _frozen_bytes(case: str) -> dict:
    return json.loads((ROOT / "fixtures" / "port" / "fib3_proof_bytes.json")
                      .read_text())[f"fib3_{case}"]


def _canonical(fib3) -> bytes:
    return ser.serialize_jolt_proof_with_commitments(fib3["proof"],
                                                     fib3["commitments"])


def _bump_output_opening(proof):
    ops = proof.read_write_memory.output_proof
    ops.opening = ops.opening + FElt(1, fr_spec())


def test_proof_size_bytes_matches_jolt_tpu(fib3):
    assert ser.proof_size_bytes(fib3["proof"]) == \
        _frozen_bytes(fib3["case"])["proof_size_bytes"]


def test_canonical_bytes_match_jolt_tpu(fib3):
    if fib3["case"] != "hyperkzg":
        with pytest.raises(ValueError, match="HyperKZG"):
            _canonical(fib3)
        return
    from jolt_tpu.utils import serialization as jser
    data = _canonical(fib3)
    want = _frozen_bytes("hyperkzg")
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["canonical_sha256"], want["canonical_len"])
    jproof, jcom = jser.deserialize_jolt_proof_with_commitments(data)
    assert jser.serialize_jolt_proof_with_commitments(jproof, jcom) == data


def _plain_structure(x):
    """A structure reader's output with points as (x, y, infinity)."""
    if isinstance(x, dict):
        return {k: _plain_structure(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain_structure(v) for v in x]
    if hasattr(x, "is_infinity"):
        return (x.x, x.y, x.is_infinity)
    return x


def test_ark_bytes_match_jolt_tpus_fixture(fib3):
    vm, pre, proof, com = (fib3[k] for k in ("vm", "pre", "proof",
                                             "commitments"))
    if fib3["case"] != "hyperkzg":
        with pytest.raises(ValueError, match="HyperKZG"):
            jolt_proof_bytes(vm, pre, proof, com)
        return
    from jolt_tpu.utils.ark_proof import \
        deserialize_jolt_proof_structure as j_structure
    data = jolt_proof_bytes(vm, pre, proof, com)
    assert data == (ROOT / "fixtures" / "ark" / "fib_mini.bin").read_bytes()
    want = _frozen_bytes("hyperkzg")
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["ark_sha256"], want["ark_len"])
    il = pre.instruction_lookups
    dims = (il.C, il.num_memories, il.num_instructions)
    got = deserialize_jolt_proof_structure(data, *dims)
    assert _plain_structure(got) == _plain_structure(j_structure(data, *dims))
    assert got["trace_length"] == proof.trace_length
    assert got["outputs"] == bytes(proof.program_io.outputs)
    hk = proof.opening_proof.joint_opening_proof
    assert got["reduced"]["hyperkzg"][2] == [[x.v for x in row]
                                             for row in hk.v]


def test_proof_read_back_verifies_and_rejects_a_bumped_opening(fib3):
    """The port's reader on its canonical bytes: the proof it returns
    writes the same bytes, the verifier accepts it, and rejects it with
    one opening bumped by one."""
    if fib3["case"] != "hyperkzg":
        with pytest.raises(ValueError, match="HyperKZG"):
            _canonical(fib3)
        return
    vm, pre = fib3["vm"], fib3["pre"]
    data = _canonical(fib3)
    proof, com = ser.deserialize_jolt_proof_with_commitments(data)
    assert ser.serialize_jolt_proof_with_commitments(proof, com) == data
    assert ser.proof_size_bytes(proof) == ser.proof_size_bytes(fib3["proof"])
    vm.verify(pre, proof, com)
    _bump_output_opening(proof)
    with pytest.raises(VerificationError):
        vm.verify(pre, proof, com)
    with pytest.raises(ValueError):
        ser.deserialize_jolt_proof_with_commitments(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        ser.deserialize_jolt_proof_with_commitments(data + b"\x00")


@pytest.mark.parametrize("fib3", ["hyperkzg"], indirect=True)
def test_jolt_tpus_verifier_accepts_the_ports_proof(fib3):
    """jolt_tpu's JoltVM.verify (vm/jolt.py:302), with jolt_tpu's own
    preprocessing of the same mini VM (M = 2^8, a 2^8-point SRS), accepts
    the proof it reads from the port's canonical bytes, and rejects it
    with the output opening bumped by one."""
    from jolt_tpu.commitment.hyperkzg import HyperKZG as JHyperKZG
    from jolt_tpu.field import FElt as JFElt
    from jolt_tpu.field import fr_spec as jfr_spec
    from jolt_tpu.instructions import AddInstruction, BneInstruction
    from jolt_tpu.subprotocols.sumcheck import SumcheckError
    from jolt_tpu.subtables.rv32i import (EqSubtable, IdentitySubtable,
                                          TruncateOverflowSubtable)
    from jolt_tpu.utils import serialization as jser
    from jolt_tpu.vm.host import fibonacci_program as j_fibonacci_program
    from jolt_tpu.vm.host import trace_program as j_trace_program
    from jolt_tpu.vm.rv32i_vm import mini_vm

    jvm = mini_vm([AddInstruction, BneInstruction],
                  [TruncateOverflowSubtable(32), IdentitySubtable(),
                   EqSubtable()], M_mini=fx.M_MINI, spec=jfr_spec())
    _, _, jrows = j_trace_program(j_fibonacci_program(fx.FIB_N), jvm,
                                  max_input_size=32, max_output_size=32,
                                  native=False)
    jpre = jvm.preprocess(jrows, JHyperKZG.setup(fx.SRS_LEN))
    jproof, jcom = jser.deserialize_jolt_proof_with_commitments(
        _canonical(fib3))
    jvm.verify(jpre, jproof, jcom)
    ops = jproof.read_write_memory.output_proof
    ops.opening = ops.opening + JFElt(1, jfr_spec())
    with pytest.raises((AssertionError, SumcheckError)):
        jvm.verify(jpre, jproof, jcom)
