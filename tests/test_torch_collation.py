"""The primary sumcheck's collation program (vm/collation.py, K13's
function) on the port's CPU path against jolt_tpu.

- each of rv32i_vm()'s 29 instructions alone (C = 4, M = 2^16), all 29
  together in rv32i_vm()'s memory layout (55 memories), and the narrow
  VM's 23 at M = 2^8: the recorded program run on host ints, the plain
  version `collate_plain` and the wrapper `collate` (CPU tensors) all give
  sum_k f_k * g_k(E), which jolt_tpu's `combine_lookups` computes on its
  host `FElt`;
- the program is recorded once per (instructions, memories, C, M, field)
  and its tables uploaded once per device.
Operands are random residues from numpy seeds, with elements whose every
operand is 0, 1 or p - 1.  The tolerance is zero.  (The round's strided
halves and t >= 2 points against jolt_tpu's `_g_term_jit` are in
tests/test_torch_primary_finish.py, beside the round whose programs they
share.)
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.field.host import FElt as JFElt
from jolt_tpu.instructions import RV32I_INSTRUCTIONS as J_INSTRUCTIONS
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field.spec import fq_spec, fr_spec
from jolt_tpu_torch.instructions import RV32I_INSTRUCTIONS
from jolt_tpu_torch.vm import collation
from jolt_tpu_torch.vm import instruction_lookups as il
from jolt_tpu_torch.vm.fixtures import narrow_instructions
from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES

FR, JFR = fr_spec(), jfr_spec()
C, M_FULL, M_NARROW = 4, 1 << 16, 1 << 8
J_BY_NAME = {c.name: c for c in J_INSTRUCTIONS}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pre(classes, M, mems=None, spec=FR):
    """What the program reads of a preprocessing: the classes, their
    memories (rv32i_vm()'s layout by default), C, M and the field."""
    if mems is None:
        mems = il.memory_layout(classes, RV32I_SUBTABLES, C, M)[3]
    return SimpleNamespace(instruction_classes=list(classes),
                           instruction_to_memory_indices=mems, C=C, M=M,
                           spec=spec)


def _values(rng, rows, h, p):
    """Canonical residues [rows][h]: element 0 all 0, 1 all 1, 2 all
    p - 1, 3 drawn from {0, 1, p - 1}, the rest random."""
    words = rng.integers(0, 1 << 64, size=(rows, h, 4), dtype=np.uint64)
    vals = [[sum(int(w) << (64 * k) for k, w in enumerate(ws)) % p
             for ws in row] for row in words]
    for r in range(rows):
        vals[r][0], vals[r][1], vals[r][2] = 0, 1, p - 1
        vals[r][3] = (0, 1, p - 1)[rng.integers(0, 3)]
    return vals


def _mont(spec, vals) -> torch.Tensor:
    """Canonical residues [rows][h] -> Montgomery limbs [16, rows, h]."""
    return torch.from_numpy(fd.pack_ints(
        [[spec.to_mont(v) for v in row] for row in vals]).astype(np.int32))


def _canonical(spec, limbs: torch.Tensor) -> list[int]:
    return [spec.from_mont(int(v)) for v in fd.unpack_ints(limbs.numpy())]


def _run_host(prog, spec, e_vals, f_vals, i) -> int:
    """The program's rows at element i on canonical host ints."""
    p, mask = spec.p, (1 << collation.KIND_SHIFT) - 1
    slots = [None] * prog.n_slots
    src = {collation.E_COL: lambda j: e_vals[j][i],
           collation.F_COL: lambda j: f_vals[j][i],
           collation.CONST: lambda j: prog.consts[j],
           collation.SLOT: lambda j: slots[j]}
    for op, dst, a, b in prog.rows:
        x = src[a >> collation.KIND_SHIFT](a & mask)
        y = src[b >> collation.KIND_SHIFT](b & mask)
        slots[dst] = (x + y if op == collation.ADD else x - y
                      if op == collation.SUB else x * y) % p
    return slots[prog.out_slot]


def _jolt_tpu_inner(pre, e_vals, f_vals, i) -> int:
    """sum_k f_k * combine_lookups_k on jolt_tpu's host FElt."""
    total = JFElt(0, JFR)
    for k, cls in enumerate(pre.instruction_classes):
        ops = [JFElt(e_vals[mi][i], JFR)
               for mi in pre.instruction_to_memory_indices[k]]
        total = total + JFElt(f_vals[k][i], JFR) * \
            J_BY_NAME[cls.name]().combine_lookups(ops, pre.C, pre.M)
    return total.v


def _check_against_jolt_tpu(pre, seed, h=6):
    rng = np.random.default_rng(seed)
    m = 1 + max(mi for mk in pre.instruction_to_memory_indices for mi in mk)
    e_vals = _values(rng, m, h, FR.p)
    f_vals = _values(rng, len(pre.instruction_classes), h, FR.p)
    prog = collation.program(pre)
    host = [_run_host(prog, FR, e_vals, f_vals, i) for i in range(h)]
    assert host == [_jolt_tpu_inner(pre, e_vals, f_vals, i) for i in range(h)]
    e_t, f_t = _mont(FR, e_vals), _mont(FR, f_vals)
    plain = collation.collate_plain(pre, e_t, f_t)
    assert plain.shape == (16, h) and plain.dtype == torch.int32
    assert _canonical(FR, plain) == host
    assert torch.equal(collation.collate(pre, e_t, f_t), plain)
    return prog


@pytest.mark.parametrize("name", [c.name for c in RV32I_INSTRUCTIONS])
def test_each_rv32i_instruction_matches_jolt_tpu(name):
    """One instruction, its operands in columns 0.. in its own order."""
    cls = {c.name: c for c in RV32I_INSTRUCTIONS}[name]
    n_mem = sum(len(idx) for _, idx in cls().subtables(C, M_FULL))
    _check_against_jolt_tpu(_pre([cls], M_FULL, [list(range(n_mem))]),
                            seed=sum(map(ord, name)))


def test_rv32i_vm_program_matches_jolt_tpu():
    """All 29 in rv32i_vm()'s layout (55 memories): the program K13 runs
    on the main path, with the counts its bound is computed from."""
    assert [c.name for c in RV32I_INSTRUCTIONS] == \
        [c.name for c in J_INSTRUCTIONS]
    prog = _check_against_jolt_tpu(_pre(RV32I_INSTRUCTIONS, M_FULL), seed=29)
    assert (len(prog.rows), prog.products, prog.adds) == (267, 150, 117)
    assert len(prog.columns) == 55 and prog.n_flags == 29
    assert prog.n_slots <= collation.MAX_SLOTS


def test_narrow_vm_program_matches_jolt_tpu():
    """The narrow VM's 23 instructions at M = 2^8 in its layout."""
    classes = narrow_instructions(RV32I_INSTRUCTIONS)
    assert len(classes) == 23
    _check_against_jolt_tpu(_pre(classes, M_NARROW), seed=23)


def test_program_recorded_and_uploaded_once(monkeypatch):
    """A second call (another preprocessing of the same instructions
    included) records nothing and uploads nothing; another field or
    another M is another program."""
    classes = narrow_instructions(RV32I_INSTRUCTIONS)[:6]
    pre = _pre(classes, M_NARROW)
    m = 1 + max(max(mk) for mk in pre.instruction_to_memory_indices)
    rng = np.random.default_rng(6)
    e_t = _mont(FR, _values(rng, m, 4, FR.p))
    f_t = _mont(FR, _values(rng, len(classes), 4, FR.p))
    monkeypatch.setattr(collation, "_PROGRAMS", {})
    recorded, packed = [], []
    record, pack_ints = collation.record, fd.pack_ints
    monkeypatch.setattr(collation, "record",
                        lambda *a: recorded.append(a) or record(*a))
    monkeypatch.setattr(fd, "pack_ints",
                        lambda *a: packed.append(a) or pack_ints(*a))
    first = collation.collate(pre, e_t, f_t)
    assert (len(recorded), len(packed)) == (1, 1)
    tables = collation.program(pre).tables(torch.device("cpu"))
    for again in (pre, _pre(classes, M_NARROW)):
        assert torch.equal(collation.collate(again, e_t, f_t), first)
    assert (len(recorded), len(packed)) == (1, 1)
    assert all(a is b for a, b in zip(
        tables, collation.program(pre).tables(torch.device("cpu"))))
    collation.program(_pre(classes, M_NARROW, spec=fq_spec()))
    collation.program(_pre(classes[:3], M_NARROW))
    assert len(recorded) == 3 and len(collation._PROGRAMS) == 3


def test_slots_are_reused_by_liveness():
    """A row may overwrite an operand it reads last; a value read later
    keeps its slot until then; an unread row frees its slot at once."""
    N, S, E, K = collation._NODE, collation.SLOT, collation.E_COL, \
        collation.CONST
    ref = collation._ref
    rows = [(collation.MUL, ref(E, 0), ref(E, 1)),          # n0
            (collation.ADD, ref(N, 0), ref(K, 0)),          # n1 = n0 + c
            (collation.SUB, ref(E, 2), ref(E, 2)),          # n2, unread
            (collation.MUL, ref(N, 1), ref(N, 0)),          # n3: n0, n1 die
            (collation.ADD, ref(N, 3), ref(E, 3))]          # n4 = out
    placed, out, n_slots = collation._allocate(rows, ref(N, 4))
    assert [r[1] for r in placed] == [0, 1, 2, 0, 0]
    assert placed[3][2:] == (ref(S, 1), ref(S, 0))
    assert (out, n_slots) == (0, 3)
