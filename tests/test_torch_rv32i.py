"""The port's RV32I instruction and subtable zoo, the full VM's
preprocessing, the sha2-chain and muldiv guests, and the narrow whole path,
against jolt_tpu on the CPU.  The tolerance is zero everywhere.

- each of the 26 subtables, and ZeroLSB (in no instruction): entries at
  M = 2^16, and the MLE at seeded random points (and at Boolean points,
  where it must equal the entry);
- each of the 29 instructions: its subtables at C = 4, M = 2^16, the
  operand chunking and native results on 256 seeded operand pairs, and
  the collation polynomial on host elements and on CPU device tensors;
- the instruction-lookup preprocessing of the full VM (55 memories), its
  R1CS input layout and instruction indices;
- sha2_chain_program(1), muldiv_program() and the fixtures' loadstore
  program (every load and store width): instruction for instruction, their
  traces step for step, and each output against its host oracle;
- the narrow whole path: a mini VM over the 23 instructions that chunk at
  M = 2^8 and all 26 subtables proves jolt_tpu_torch/vm/fixtures.py's
  `narrow_program` with the mock PCS; the transcript and the commitments'
  digests equal jolt_tpu's, frozen in fixtures/port/narrow_mock.npz (after
  jolt_tpu's verifier accepted it), and the port's verifier accepts the
  proof and rejects it with one opening bumped by one.
The `slow` tests prove fibonacci(8), the M-extension program, the
loadstore program and sha2_chain_program(1) on rv32i_vm() at M = 2^16 with
the port on the CPU against their frozen jolt_tpu transcripts, and rerun
jolt_tpu's proofs live.
"""
import dataclasses
import enum
import hashlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu.field import FElt as JFElt
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.instructions import RV32I_INSTRUCTIONS as J_INSTRUCTIONS
from jolt_tpu.subtables.rv32i import ZeroLSBSubtable as JZeroLSBSubtable
from jolt_tpu.vm import guests as jguests
from jolt_tpu.vm import host as jhost
from jolt_tpu.vm.instruction_lookups import \
    InstructionLookupsPreprocessing as JILP
from jolt_tpu.vm.rv32i_vm import RV32I_SUBTABLES as J_SUBTABLES
from jolt_tpu.vm.rv32i_vm import rv32i_vm as j_rv32i_vm
from jolt_tpu.vm.rv_trace import RV32IM as J_RV32IM
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field.generic import DevF
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.instructions import RV32I_INSTRUCTIONS
from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
from jolt_tpu_torch.subtables.rv32i import ZeroLSBSubtable
from jolt_tpu_torch.vm import fixtures as fx
from jolt_tpu_torch.vm import guests
from jolt_tpu_torch.vm.host import trace_program
from jolt_tpu_torch.vm.instruction_lookups import \
    InstructionLookupsPreprocessing
from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES, mini_vm, rv32i_vm

ROOT = Path(__file__).resolve().parents[1]
C, M = 4, 1 << 16
FR, JFR = fr_spec(), jfr_spec()
SHA2_INPUT = guests.SHA2_INPUT
# The 26 subtables of the VM, then ZeroLSB, which no instruction uses.
SUBTABLES = [*zip(RV32I_SUBTABLES, J_SUBTABLES),
             (ZeroLSBSubtable(), JZeroLSBSubtable())]


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


def _rand_ints(seed: int, n: int) -> list[int]:
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64)
    return [sum(int(w) << (64 * k) for k, w in enumerate(row)) % FR.p
            for row in words]


def _plain(x):
    """Dataclasses as dicts and enums as their names, for comparing the
    two packages' host objects."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# subtables
# ---------------------------------------------------------------------------

def test_subtable_order_matches_jolt_tpu():
    assert len(RV32I_SUBTABLES) == 26
    assert [s.key() for s in RV32I_SUBTABLES] == \
        [s.key() for s in J_SUBTABLES]


@pytest.mark.parametrize("k", range(len(SUBTABLES)))
def test_subtable_matches_jolt_tpu(k):
    sub, jsub = SUBTABLES[k]
    entries = sub.materialize_entries(M)
    assert entries.dtype == np.uint64
    assert (entries == jsub.materialize_entries(M)).all()
    log_m = M.bit_length() - 1
    for seed in range(3):
        vals = _rand_ints(100 * k + seed, log_m)
        got = sub.evaluate_mle([FElt(v, FR) for v in vals])
        assert got.v == jsub.evaluate_mle([JFElt(v, JFR) for v in vals]).v
    rng = np.random.default_rng(k)
    for idx in rng.integers(0, M, size=4).tolist() + [0, M - 1]:
        bits = [(idx >> (log_m - 1 - i)) & 1 for i in range(log_m)]
        assert sub.evaluate_mle([FElt(b, FR) for b in bits]).v == \
            int(entries[idx])


# ---------------------------------------------------------------------------
# instructions
# ---------------------------------------------------------------------------

def test_instruction_order_matches_jolt_tpu():
    assert len(RV32I_INSTRUCTIONS) == 29
    assert [c.name for c in RV32I_INSTRUCTIONS] == \
        [c.name for c in J_INSTRUCTIONS]


def _operands(seed: int):
    """256 operand pairs: random 32-bit words, small values, equal pairs
    and the signed edges."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=256, dtype=np.uint64)
    y = rng.integers(0, 1 << 32, size=256, dtype=np.uint64)
    edges = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 31, 32, 7],
                     dtype=np.uint64)
    x[:8], y[:8] = edges, edges[::-1]
    x[8:16] = y[8:16]
    x[16:32] &= np.uint64(0xFF)
    y[16:32] &= np.uint64(0x1F)
    return x, y


@pytest.mark.parametrize("k", range(29))
def test_instruction_matches_jolt_tpu(k):
    cls, jcls = RV32I_INSTRUCTIONS[k], J_INSTRUCTIONS[k]
    inst, jinst = cls(), jcls()
    subs, jsubs = inst.subtables(C, M), jinst.subtables(C, M)
    assert [(s.key(), list(i)) for s, i in subs] == \
        [(s.key(), list(i)) for s, i in jsubs]
    assert inst.g_poly_degree(C) == jinst.g_poly_degree(C)
    x, y = _operands(k)
    log_m = M.bit_length() - 1
    idx = cls.to_indices_vec(x, y, C, log_m)
    assert (idx == jcls.to_indices_vec(x, y, C, log_m)).all()
    assert (cls.lookup_entry_vec(x, y) == jcls.lookup_entry_vec(x, y)).all()

    # the collation polynomial at random points: host, then CPU tensors
    n_vals = sum(len(i) for _, i in subs)
    cols = [_rand_ints(1000 * k + j, 8) for j in range(n_vals)]
    want = [jinst.combine_lookups([JFElt(c[i], JFR) for c in cols], C, M).v
            for i in range(8)]
    got = [inst.combine_lookups([FElt(c[i], FR) for c in cols], C, M).v
           for i in range(8)]
    assert got == want
    dev_vals = [DevF(fd.ints_to_device(FR, c, "cpu"), FR) for c in cols]
    g = inst.combine_lookups(dev_vals, C, M)
    assert [int(v) for v in fd.device_to_ints(FR, g.limbs)] == want


def test_instruction_lookups_preprocessing_matches_jolt_tpu():
    pre = InstructionLookupsPreprocessing(RV32I_INSTRUCTIONS, RV32I_SUBTABLES,
                                          C, M, "cpu", FR)
    jpre = JILP(J_INSTRUCTIONS, J_SUBTABLES, C, M, JFR)
    assert pre.num_memories == jpre.num_memories == 55
    for name in ("subtable_to_memory_indices", "memory_to_subtable_index",
                 "memory_to_dimension_index", "instruction_to_memory_indices",
                 "max_g_degree", "sumcheck_degree"):
        assert getattr(pre, name) == getattr(jpre, name), name
    assert pre.sumcheck_degree == 8
    assert (pre.subtable_entries == jpre.subtable_entries).all()


def test_rv32i_vm_layout_matches_jolt_tpu():
    vm, jvm = rv32i_vm(), j_rv32i_vm(JFR)
    assert vm.layout == jvm.layout
    assert vm.name_to_index == jvm.name_to_index
    assert vm.load_store_indices == jvm.load_store_indices
    assert (vm.C, vm.M) == (jvm.C, jvm.M) == (C, M)


# ---------------------------------------------------------------------------
# guests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("guest", ["sha2_chain", "muldiv", "loadstore"])
def test_guest_program_and_trace_match_jolt_tpu(guest):
    if guest == "sha2_chain":
        prog, jprog = (guests.sha2_chain_program(1),
                       jguests.sha2_chain_program(1))
        inputs = SHA2_INPUT
    elif guest == "muldiv":
        prog, jprog = guests.muldiv_program(), jguests.muldiv_program()
        inputs = b""
    else:
        prog, inputs = fx.case_program("rv32i_loadstore_mock")
        jprog = fx.loadstore_program(jguests._Asm, J_RV32IM)
    assert _plain(prog) == _plain(jprog)
    steps, io, rows = trace_program(prog, rv32i_vm(), inputs=inputs)
    jsteps, jio, jrows = jhost.trace_program(jprog, j_rv32i_vm(JFR),
                                             inputs=inputs, native=False)
    assert len(steps) == len(jsteps)
    assert _plain(steps) == _plain(jsteps)
    assert _plain(rows) == _plain(jrows)
    assert bytes(io.outputs) == bytes(jio.outputs)
    if guest == "sha2_chain":
        assert len(steps) == 5161
        assert bytes(io.outputs)[:32] == \
            guests.sha2_chain_expected(SHA2_INPUT, 1) == \
            hashlib.sha256(SHA2_INPUT).digest()
    elif guest == "muldiv":
        assert int.from_bytes(bytes(io.outputs)[:4], "little") == \
            guests.muldiv_expected()
    else:
        assert {"LB", "LBU", "LH", "LHU", "LW", "SB", "SH", "SW", "LUI"} <= \
            {i.opcode.name for i in prog}
        assert bytes(io.outputs)[:28] == fx.loadstore_expected()


# ---------------------------------------------------------------------------
# the narrow whole path
# ---------------------------------------------------------------------------

def _frozen(name: str) -> dict:
    with np.load(ROOT / "fixtures" / "port" / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def _assert_equal_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert (got[k] == want[k]).all(), k


@pytest.fixture(scope="module")
def narrow():
    vm = mini_vm(fx.narrow_instructions(RV32I_INSTRUCTIONS),
                 RV32I_SUBTABLES, M_mini=fx.M_MINI)
    steps, io, rows = trace_program(fx.narrow_program(), vm,
                                    max_input_size=32, max_output_size=32)
    pre = vm.preprocess(rows, MockCommitmentScheme(), device="cpu")
    proof, commitments, transcript, acc = vm.prove(io, steps, pre)
    return dict(vm=vm, pre=pre, proof=proof, commitments=commitments,
                transcript=transcript, acc=acc)


def test_narrow_vm_carries_23_instructions_and_26_subtables(narrow):
    vm, pre = narrow["vm"], narrow["pre"].instruction_lookups
    assert len(vm.instruction_classes) == 23
    assert len(pre.subtables) == 26
    assert pre.sumcheck_degree == 8


def test_narrow_transcript_and_commitments_match_jolt_tpu(narrow):
    got = fx.proof_arrays(narrow["transcript"], narrow["commitments"],
                          digest=True)
    _assert_equal_arrays(got, _frozen("narrow_mock"))


def test_narrow_verifier_accepts_and_rejects_a_bumped_opening(narrow):
    vm, pre, proof, com = (narrow[k] for k in ("vm", "pre", "proof",
                                               "commitments"))
    vm.verify(pre, proof, com, debug_transcript=narrow["transcript"],
              debug_accumulator=narrow["acc"])
    ops = proof.read_write_memory.output_proof
    good = ops.opening
    ops.opening = good + FElt(1, FR)
    try:
        with pytest.raises(VerificationError):
            vm.verify(pre, proof, com)
    finally:
        ops.opening = good


# ---------------------------------------------------------------------------
# slow: the full VM at M = 2^16 on the CPU, and jolt_tpu live
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("case", fx.RV32I_CASES)
def test_rv32i_mock_proof_matches_jolt_tpu(case):
    """The port proves one of the fixtures' rv32i_vm() cases (C = 4,
    M = 2^16) on the CPU: minutes each."""
    vm = rv32i_vm()
    program, inputs = fx.case_program(case)
    steps, io, rows = trace_program(program, vm, inputs=inputs)
    pre = vm.preprocess(rows, MockCommitmentScheme(), device="cpu")
    proof, commitments, transcript, _ = vm.prove(io, steps, pre)
    _assert_equal_arrays(
        fx.proof_arrays(transcript, commitments, digest=True),
        _frozen(case))


@pytest.mark.slow
@pytest.mark.parametrize("case", fx.RV32I_HYPERKZG_CASES)
def test_rv32i_hyperkzg_proof_matches_jolt_tpu(case):
    """The port proves the load/store program on rv32i_vm() with HyperKZG
    over the 2^16-point SRS fixture on the CPU: its transcript, commitment
    digests and arkworks bytes' SHA-256 against jolt_tpu's."""
    from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
    from jolt_tpu_torch.utils.ark_proof import jolt_proof_bytes
    vm = rv32i_vm()
    program, inputs = fx.case_program(case)
    steps, io, rows = trace_program(program, vm, inputs=inputs)
    pcs = HyperKZG.setup(vm.required_srs_len(io, steps, rows), device="cpu")
    pre = vm.preprocess(rows, pcs)
    proof, commitments, transcript, _ = vm.prove(io, steps, pre)
    vm.verify(pre, proof, commitments)
    _assert_equal_arrays(
        fx.proof_arrays(transcript, commitments, digest=True,
                        ark=jolt_proof_bytes(vm, pre, proof, commitments)),
        _frozen(case))


@pytest.mark.slow
@pytest.mark.parametrize("case", ("narrow_mock",) + fx.RV32I_CASES
                         + fx.RV32I_HYPERKZG_CASES)
def test_frozen_rv32i_fixtures_match_a_live_jolt_tpu_prove(case):
    _assert_equal_arrays(_freeze_script().prove_rv32i_case(case),
                         _frozen(case))
