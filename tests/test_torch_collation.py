"""The primary sumcheck's collation programs (vm/collation.py, the round
kernel's collations) on the port's CPU path against jolt_tpu.

- each of rv32i_vm()'s 29 instructions alone (C = 4, M = 2^16), all 29
  together in rv32i_vm()'s memory layout (55 memories), and the narrow
  VM's 23 at M = 2^8: the recorded program run on host ints, its plain
  version `collate_plain` and the group plan's `collate_grouped_plain`
  all give sum_k f_k * g_k(E), which jolt_tpu's `combine_lookups`
  computes on its host `FElt`;
- the group plan of rv32i_vm(), the narrow VM and the mini VM (fib's ADD
  and BNE): every instruction in exactly one group, G = min(8,
  instructions), each group's slots within the kernel's cap, its chain
  levels its rows' products and adds, the groups balanced as the
  longest-first packing leaves them, and its partial sums adding up to
  `collate_plain` on edge residues;
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
    assert torch.equal(collation.collate_grouped_plain(pre, e_t, f_t), plain)
    return prog


@pytest.mark.parametrize("name", [c.name for c in RV32I_INSTRUCTIONS])
def test_each_rv32i_instruction_matches_jolt_tpu(name):
    """One instruction, its operands in columns 0.. in its own order."""
    cls = {c.name: c for c in RV32I_INSTRUCTIONS}[name]
    n_mem = sum(len(idx) for _, idx in cls().subtables(C, M_FULL))
    _check_against_jolt_tpu(_pre([cls], M_FULL, [list(range(n_mem))]),
                            seed=sum(map(ord, name)))


def test_rv32i_vm_program_matches_jolt_tpu():
    """All 29 in rv32i_vm()'s layout (55 memories): the program whose
    group plan the round kernel runs on the main path, with the counts
    its bound is computed from."""
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
    included) records nothing and uploads nothing (the program's
    constants once, the group plan's tables once); another field or
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
    first = collation.collate_plain(pre, e_t, f_t)
    assert (len(recorded), len(packed)) == (1, 1)
    cpu = torch.device("cpu")
    tables = collation.program(pre).plan.tables(FR, cpu)
    assert len(packed) == 2
    for again in (pre, _pre(classes, M_NARROW)):
        assert torch.equal(collation.collate_plain(again, e_t, f_t), first)
        assert torch.equal(collation.collate_grouped_plain(again, e_t, f_t),
                           first)
    assert (len(recorded), len(packed)) == (1, 2)
    assert collation.program(pre).consts_table(cpu) is \
        collation.program(pre).consts_table("cpu")
    assert all(a is b for a, b in zip(
        tables, collation.program(pre).plan.tables(FR, cpu)))
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


def _fib_classes():
    by = {c.name: c for c in RV32I_INSTRUCTIONS}
    return [by["add"], by["bne"]]


VMS = {"rv32i": (lambda: list(RV32I_INSTRUCTIONS), M_FULL, 8),
       "narrow": (lambda: narrow_instructions(RV32I_INSTRUCTIONS), M_NARROW,
                  8),
       "fib": (_fib_classes, M_NARROW, 2)}


@pytest.mark.parametrize("vm", VMS)
def test_group_plan(vm):
    """Every instruction in one group; G as the plan's rule gives it; each
    group's rows read only staged columns, constants and its own slots,
    within the cap; its levels its rows' products and adds; the packing
    leaves no group longer than the shortest plus the largest item."""
    classes_of, M, G = VMS[vm]
    classes = classes_of()
    pre = _pre(classes, M)
    prog = collation.program(pre)
    plan = prog.plan
    assert plan.n_groups == G == min(collation.MAX_GROUPS, len(classes))
    assert sorted(k for g in plan.groups for k in g) == \
        list(range(len(classes)))
    assert all(list(g) == sorted(g) and g for g in plan.groups)
    assert plan.stage[:2] == ((collation.EQ, 0), (collation.OUT, 0))
    assert [c for t, c in plan.stage if t == collation.MEMS] == \
        list(prog.columns)
    mask = (1 << collation.KIND_SHIFT) - 1
    for rows, n_slots, out, levels in zip(plan.group_rows, plan.group_slots,
                                          plan.group_outs, plan.levels):
        assert 1 <= n_slots <= collation.MAX_SLOTS and 0 <= out < n_slots
        for op, dst, a, b in rows:
            assert op in (collation.ADD, collation.SUB, collation.MUL)
            assert 0 <= dst < n_slots
            for r in (a, b):
                kind, idx = r >> collation.KIND_SHIFT, r & mask
                assert kind in (collation.STAGE, collation.CONST,
                                collation.SLOT)
                assert idx < {collation.STAGE: len(plan.stage),
                              collation.CONST: len(plan.consts),
                              collation.SLOT: n_slots}[kind]
        products = sum(op == collation.MUL for op, _, _, _ in rows)
        assert levels == products * collation.PRODUCT_LEVELS + \
            (len(rows) - products) * collation.ADD_LEVELS
    # the groups hold the program's rows, and a running add per extra
    # instruction of a group in place of the program's sum
    assert sum(map(len, plan.group_rows)) == len(prog.rows) - G + 1
    assert sum(plan.products) == prog.products
    assert plan.slot_bases == tuple(sum(plan.group_slots[:g])
                                    for g in range(G))
    assert plan.n_slots == sum(plan.group_slots)
    # each group's levels: its instructions' own (each recorded alone)
    # and an add per extra instruction; longest first leaves no group
    # longer than the shortest by more than the largest instruction
    own = []
    for cls in classes:
        n_mem = sum(len(idx) for _, idx in cls().subtables(C, M))
        alone = collation.program(_pre([cls], M, [list(range(n_mem))]))
        own.append(alone.products * collation.PRODUCT_LEVELS
                   + alone.adds * collation.ADD_LEVELS)
    for ks, levels in zip(plan.groups, plan.levels):
        assert levels == sum(own[k] for k in ks) + \
            (len(ks) - 1) * collation.ADD_LEVELS
    assert max(plan.levels) <= min(plan.levels) + max(own) + \
        collation.ADD_LEVELS


@pytest.mark.parametrize("vm", VMS)
def test_grouped_program_matches_collate_plain(vm):
    """The groups' partial sums added mod p equal the one program's inner
    bit for bit, on edge residues (0, 1, p - 1 in every operand) and
    random ones."""
    classes_of, M, _ = VMS[vm]
    pre = _pre(classes_of(), M)
    rng = np.random.default_rng(len(vm))
    m = 1 + max(mi for mk in pre.instruction_to_memory_indices for mi in mk)
    e_t = _mont(FR, _values(rng, m, 6, FR.p))
    f_t = _mont(FR, _values(rng, len(pre.instruction_classes), 6, FR.p))
    assert torch.equal(collation.collate_grouped_plain(pre, e_t, f_t),
                       collation.collate_plain(pre, e_t, f_t))
