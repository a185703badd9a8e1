"""The primary sumcheck's collations as straight-line programs.

At each point t of a primary-sumcheck round the prover needs, over the
half-hypercube,

    inner[i] = sum_k f_t[k, i] * g_k(e_t[mems_k, i])

with g_k instruction k's collation polynomial (`combine_lookups`).
`jolt_tpu` runs each term as one `jax.jit` program (`_g_term_jit`) and
sums the terms (jolt_tpu/vm/instruction_lookups.py:257-265, 299-304); run
on `DevF` it is some 267 kernel launches a point for rv32i_vm()'s 29
instructions.  Here each instruction's `combine_lookups` is recorded once
on `_Rec` values (the collations use only +, -, * and Python ints), which
gives rows ADD / SUB / MUL over four kinds of operand:

  - E_COL j: column j of e_t (a memory, pre.instruction_to_memory_indices);
  - F_COL k: column k of f_t (instruction k's flag);
  - CONST j: the program's constant j, in Montgomery form as DevF coerces
    an int (so `1 - x` is SUB(R mod p, x) and `x * 2^48` a Montgomery
    product by 2^48's Montgomery limbs, as fd.fmul does it on DevF);
  - SLOT s: a temporary, one of a few slots reused by liveness.

Each instruction's rows end in its `f_k *` product.  Two programs are made
from the recording, once per (instruction classes, memories, C, M, field):

  - `Program`: all instructions in order with a running sum, whose output
    slot holds inner.  `collate_plain` runs it op by op with
    field/arith.py's plain limb functions, the sequence of field ops that
    the `DevF` loop ran.
  - `GroupPlan` (`Program.plan`): the instructions bin-packed into at most
    MAX_GROUPS groups by their serial chain levels (largest first, each to
    the group with the least so far), each group a program of its own
    (its rows, its slots, its running sum), over operands staged per
    column (kind STAGE: eq, out, every flag and every memory read).  The
    round kernel (csrc/collate.cu, vm/instruction_lookups.py
    `primary_round`) runs one group per warp; `collate_grouped_plain`
    runs the groups in plain limb arithmetic and adds their partial sums.

Residues mod p are unique, so `collate_plain`, `collate_grouped_plain` and
the kernel give the `DevF` path's bits.  The plan's tables are uploaded
once per device: an upload from host memory syncs the stream.
"""
from __future__ import annotations

import torch

from ..field import arith
from ..field import device as fd
from ..field.spec import FieldSpec

ADD, SUB, MUL = 0, 1, 2                   # op codes (csrc/collate.cu)
E_COL, F_COL, CONST, SLOT, _NODE, STAGE = 0, 1, 2, 3, 4, 5  # operand kinds
KIND_SHIFT = 16                           # operand = kind << 16 | index
MAX_SLOTS = 16                            # slots of one group (collate.cu)
MAX_GROUPS = 8                            # warps of a round block (collate.cu)
EQ, OUT, FLAGS, MEMS = 0, 1, 2, 3         # a staged column's tensor
PRODUCT_LEVELS = 8 * 2 * 9                # dependent levels of a Montgomery
#   product (csrc/field.cuh: per word a row and a reduction, each a carry
#   chain of 9 multiply-adds) and of a modular add (the add's and the
#   conditional subtraction's chains): the plan's cost of a row
ADD_LEVELS = 2 * 9
SMEM_LIMIT = 232_448                      # shared memory a block may opt
#   into on the H100 (227 KB)


def _ref(kind: int, idx: int) -> int:
    return (kind << KIND_SHIFT) | idx


class _Tape:
    """The rows recorded so far (operands of kind _NODE name a row) and
    the constants, by canonical value."""

    def __init__(self, p: int):
        self.p = p
        self.rows: list[tuple[int, int, int]] = []
        self.consts: dict[int, int] = {}

    def const(self, v: int) -> int:
        v %= self.p
        return _ref(CONST, self.consts.setdefault(v, len(self.consts)))

    def emit(self, op: int, a: int, b: int) -> int:
        self.rows.append((op, a, b))
        return _ref(_NODE, len(self.rows) - 1)


class _Rec:
    """A value of a collation being recorded: an operand or a row."""

    __slots__ = ("tape", "ref")

    def __init__(self, tape: _Tape, ref: int):
        self.tape = tape
        self.ref = ref

    def _other(self, x):
        if isinstance(x, _Rec):
            return x.ref
        if isinstance(x, int):
            return self.tape.const(x)
        return NotImplemented

    def _emit(self, op, a, b):
        if a is NotImplemented or b is NotImplemented:
            return NotImplemented
        return _Rec(self.tape, self.tape.emit(op, a, b))

    def __add__(self, x):
        return self._emit(ADD, self.ref, self._other(x))

    __radd__ = __add__

    def __sub__(self, x):
        return self._emit(SUB, self.ref, self._other(x))

    def __rsub__(self, x):
        return self._emit(SUB, self._other(x), self.ref)

    def __mul__(self, x):
        return self._emit(MUL, self.ref, self._other(x))

    __rmul__ = __mul__

    def __neg__(self):
        return self._emit(SUB, self.tape.const(0), self.ref)


def _mont_consts(spec: FieldSpec, consts, device) -> torch.Tensor:
    """Canonical constants -> their Montgomery limbs int32 [16, c] on
    `device`."""
    limbs = fd.pack_ints([spec.to_mont(v) for v in consts]).astype("int32")
    return torch.from_numpy(limbs).to(device)


class Program:
    """A recorded collation program over `spec`: `rows` (op, dst slot, a,
    b) with operands as _ref gives them, the constants' canonical values,
    the slot that ends holding inner, the group plan of the same
    recording, and per device the uploaded tables."""

    def __init__(self, spec, rows, consts, out_slot, n_slots, columns,
                 n_flags, plan):
        self.spec = spec
        self.rows = rows
        self.consts = consts
        self.out_slot = out_slot
        self.n_slots = n_slots
        self.columns = columns          # e_t's columns read, sorted
        self.n_flags = n_flags
        self.plan = plan
        self.products = sum(op == MUL for op, _, _, _ in rows)
        self.adds = len(rows) - self.products
        self._tables: dict[torch.device, torch.Tensor] = {}

    def consts_table(self, device: torch.device) -> torch.Tensor:
        """The constants' Montgomery limbs int32 [16, c] on `device`,
        uploaded on the first call for that device."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = _mont_consts(self.spec, self.consts,
                                                device)
        return self._tables[device]


class GroupPlan:
    """The round kernel's plan: `groups` (instruction indices, ascending)
    and for each group its rows (op, dst slot, a, b; operands STAGE, CONST
    or SLOT), its slot count, the slot that ends holding its partial sum,
    its products, adds and serial chain levels; `stage`, the staged
    columns as (tensor, column): eq, out, every flag, every memory read;
    and the constants of the program it was made beside."""

    def __init__(self, program_consts, groups, group_rows, group_outs,
                 group_slots, stage, n_flags, columns):
        self.consts = program_consts
        self.groups = groups
        self.group_rows = group_rows
        self.group_outs = group_outs
        self.group_slots = group_slots
        self.stage = stage
        self.n_flags = n_flags
        self.columns = columns
        self.products = tuple(sum(op == MUL for op, _, _, _ in rows)
                              for rows in group_rows)
        self.adds = tuple(len(rows) - p
                          for rows, p in zip(group_rows, self.products))
        self.levels = tuple(p * PRODUCT_LEVELS + a * ADD_LEVELS
                            for p, a in zip(self.products, self.adds))
        self.slot_bases = tuple(sum(group_slots[:g])
                                for g in range(len(group_slots)))
        self.n_slots = sum(group_slots)   # the groups' slots side by side
        self._tables: dict[torch.device, tuple] = {}

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def smem_bytes(self) -> int:
        """The round kernel's dynamic shared memory: each staged column
        (x_t and its step) and each slot as 8 words x 32 elements, each
        constant as 8 words (csrc/collate.cu `round_smem_bytes`)."""
        return 4 * ((2 * len(self.stage) + self.n_slots) * 256
                    + len(self.consts) * 8)

    def tables(self, spec: FieldSpec, device: torch.device):
        """(rows int32 [n, 4], the groups' row offsets [G + 1], out slots
        [G] and first slots [G] then the staged columns' sources (tensor
        << 16 | column) [n_stage] as int32, the constants' Montgomery limbs
        int32 [16, c]) on `device`, uploaded on the first call for it."""
        device = torch.device(device)
        if device not in self._tables:
            rows = [r for g in self.group_rows for r in g]
            offs = [0]
            for g in self.group_rows:
                offs.append(offs[-1] + len(g))
            meta = offs + list(self.group_outs) + list(self.slot_bases) + [
                (tensor << KIND_SHIFT) | col for tensor, col in self.stage]
            self._tables[device] = (
                torch.tensor(rows, dtype=torch.int32).to(device),
                torch.tensor(meta, dtype=torch.int32).to(device),
                _mont_consts(spec, self.consts, device))
        return self._tables[device]


def _allocate(rows: list, out: int) -> tuple[list, int, int]:
    """Rows whose results are named by row (_NODE) -> rows writing slots,
    each slot reused once its value is read for the last time (a row may
    write the slot of an operand it reads last); (rows, out slot,
    slots)."""
    last = {}
    for i, (_, a, b) in enumerate(rows):
        for r in (a, b):
            if r >> KIND_SHIFT == _NODE:
                last[r] = i
    last[out] = len(rows)
    free, slot_of, n_slots, placed = [], {}, 0, []
    for i, (op, a, b) in enumerate(rows):
        srcs = []
        for r in (a, b):
            if r >> KIND_SHIFT == _NODE:
                s = slot_of[r]
                srcs.append(_ref(SLOT, s))
                if last[r] == i and s not in free:
                    free.append(s)
            else:
                srcs.append(r)
        node = _ref(_NODE, i)
        if free:
            free.sort()
            dst = free.pop(0)
        else:
            dst, n_slots = n_slots, n_slots + 1
        slot_of[node] = dst
        placed.append((op, dst, *srcs))
        if node not in last:            # never read: its slot is free again
            free.append(dst)
    return placed, slot_of[out], n_slots


def _row_levels(rows) -> int:
    return sum(PRODUCT_LEVELS if op == MUL else ADD_LEVELS
               for op, _, _ in rows)


def _pack(weights: list[int], n_groups: int) -> list[list[int]]:
    """Longest processing time first: items by weight, largest first (the
    lower index on a tie), each into the group with the least weight so
    far (the lower group on a tie); each group's items ascending."""
    groups: list[list[int]] = [[] for _ in range(n_groups)]
    load = [0] * n_groups
    for k in sorted(range(len(weights)), key=lambda k: (-weights[k], k)):
        g = min(range(n_groups), key=lambda g: (load[g], g))
        groups[g].append(k)
        load[g] += weights[k]
    return [sorted(g) for g in groups]


def _plan(tape: _Tape, spans, n_flags: int, columns) -> GroupPlan:
    """The group plan of a recording whose instruction k owns the rows
    spans[k] = (first, last), the last its f_k product."""
    stage = [(EQ, 0), (OUT, 0)] + [(FLAGS, k) for k in range(n_flags)] + \
        [(MEMS, j) for j in columns]
    where = {(E_COL if t == MEMS else F_COL, c): _ref(STAGE, i)
             for i, (t, c) in enumerate(stage) if t in (FLAGS, MEMS)}
    weights = [_row_levels(tape.rows[s:e + 1]) + ADD_LEVELS
               for s, e in spans]
    groups = _pack(weights, min(MAX_GROUPS, len(spans)))
    g_rows, g_outs, g_slots = [], [], []
    for g, ks in enumerate(groups):
        rows, remap, acc = [], {}, None

        def fix(r):
            kind = r >> KIND_SHIFT
            idx = r & ((1 << KIND_SHIFT) - 1)
            if kind == _NODE:
                return _ref(_NODE, remap[idx])
            return where.get((kind, idx), r)

        for k in ks:
            s, e = spans[k]
            for i in range(s, e + 1):
                op, a, b = tape.rows[i]
                rows.append((op, fix(a), fix(b)))
                remap[i] = len(rows) - 1
            term = _ref(_NODE, remap[e])
            if acc is None:
                acc = term
            else:
                rows.append((ADD, acc, term))
                acc = _ref(_NODE, len(rows) - 1)
        placed, out, n_slots = _allocate(rows, acc)
        if n_slots > MAX_SLOTS:
            raise ValueError(f"group {g} of the collation plan needs "
                             f"{n_slots} slots, the round kernel holds "
                             f"{MAX_SLOTS}")
        g_rows.append(tuple(placed))
        g_outs.append(out)
        g_slots.append(n_slots)
    consts = tuple(sorted(tape.consts, key=tape.consts.get))
    plan = GroupPlan(consts, tuple(map(tuple, groups)), tuple(g_rows),
                     tuple(g_outs), tuple(g_slots), tuple(stage), n_flags,
                     tuple(columns))
    if plan.smem_bytes() > SMEM_LIMIT:
        raise ValueError(f"the collation plan needs {plan.smem_bytes()} B "
                         f"of shared memory a block, the H100 gives "
                         f"{SMEM_LIMIT}")
    return plan


def record(classes, mems, C: int, M: int, spec: FieldSpec) -> Program:
    """Record sum_k F_COL k * combine_lookups_k(E_COL mems[k]) as one
    program, and its group plan."""
    tape = _Tape(spec.p)
    acc, spans = None, []
    for k, (cls, mk) in enumerate(zip(classes, mems)):
        first = len(tape.rows)
        g = cls().combine_lookups([_Rec(tape, _ref(E_COL, mi)) for mi in mk],
                                  C, M)
        g = g.ref if isinstance(g, _Rec) else tape.const(g)
        term = tape.emit(MUL, _ref(F_COL, k), g)
        spans.append((first, len(tape.rows) - 1))
        acc = term if acc is None else tape.emit(ADD, acc, term)
    rows, out_slot, n_slots = _allocate(tape.rows, acc)
    columns = sorted({mi for mk in mems for mi in mk})
    plan = _plan(tape, spans, len(classes), columns)
    return Program(spec, tuple(rows), plan.consts, out_slot, n_slots,
                   tuple(columns), len(classes), plan)


_PROGRAMS: dict[tuple, Program] = {}


def program(pre) -> Program:
    """`pre`'s program (InstructionLookupsPreprocessing, or anything with
    its instruction_classes, instruction_to_memory_indices, C, M and
    spec), recorded once per (classes, memories, C, M, field)."""
    key = (tuple(pre.instruction_classes),
           tuple(map(tuple, pre.instruction_to_memory_indices)), pre.C,
           pre.M, pre.spec)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = record(*key)
    return prog


def check_operands(name: str, prog: Program, e_t: torch.Tensor,
                   f_t: torch.Tensor) -> None:
    if e_t.dim() != 3 or f_t.dim() != 3 or e_t.shape[0] != fd.L or \
            f_t.shape[0] != fd.L or e_t.shape[2] != f_t.shape[2] or \
            e_t.shape[1] <= prog.columns[-1] or f_t.shape[1] < prog.n_flags:
        raise ValueError(f"{name}: expected e [16, m, n] with m > "
                         f"{prog.columns[-1]} and flags [16, "
                         f"{prog.n_flags}, n], got {tuple(e_t.shape)}, "
                         f"{tuple(f_t.shape)}")


def _run(spec, rows, n_slots, out_slot, src):
    """Rows op by op in plain limb arithmetic; src[kind](index) gives an
    operand that is not a slot."""
    slots: list = [None] * n_slots
    src = {**src, SLOT: lambda j: slots[j]}
    mask = (1 << KIND_SHIFT) - 1
    for op, dst, a, b in rows:
        x = src[a >> KIND_SHIFT](a & mask)
        y = src[b >> KIND_SHIFT](b & mask)
        slots[dst] = (arith.add if op == ADD else arith.sub if op == SUB
                      else arith.mont_mul)(spec, x, y)
    return slots[out_slot]


def collate_plain(pre, e_t: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """inner [16, h] = sum_k f_t[:, k] * g_k(e_t[:, mems_k]): the program's
    rows op by op in plain limb arithmetic (arith.py)."""
    prog = program(pre)
    check_operands("collate_plain", prog, e_t, f_t)
    consts = prog.consts_table(e_t.device)
    return _run(pre.spec, prog.rows, prog.n_slots, prog.out_slot, {
        E_COL: lambda j: e_t[:, j], F_COL: lambda j: f_t[:, j],
        CONST: lambda j: consts[:, j:j + 1]}).contiguous()


def collate_grouped_plain(pre, e_t: torch.Tensor, f_t: torch.Tensor
                          ) -> torch.Tensor:
    """collate_plain's inner through the group plan: each group's rows in
    plain limb arithmetic, the groups' partial sums added mod p in group
    order, as the round kernel adds them."""
    prog = program(pre)
    check_operands("collate_grouped_plain", prog, e_t, f_t)
    plan = prog.plan
    consts = prog.consts_table(e_t.device)
    cols = {FLAGS: f_t, MEMS: e_t}

    def staged(j):
        tensor, col = plan.stage[j]
        return cols[tensor][:, col]

    inner = None
    for rows, out, n_slots in zip(plan.group_rows, plan.group_outs,
                                  plan.group_slots):
        part = _run(pre.spec, rows, n_slots, out, {
            STAGE: staged, CONST: lambda j: consts[:, j:j + 1]})
        inner = part if inner is None else arith.add(pre.spec, inner, part)
    return inner.contiguous()
