"""The primary sumcheck's collations as one straight-line program (K13).

At each point t of a primary-sumcheck round the prover needs, over the
half-hypercube,

    inner[i] = sum_k f_t[k, i] * g_k(e_t[mems_k, i])

with g_k instruction k's collation polynomial (`combine_lookups`).
`jolt_tpu` runs each term as one `jax.jit` program (`_g_term_jit`) and
sums the terms (jolt_tpu/vm/instruction_lookups.py:257-265, 299-304); run
on `DevF` it is some 267 kernel launches a point for rv32i_vm()'s 29
instructions.  Here each instruction's `combine_lookups` is recorded once
on `_Rec` values (the collations use only +, -, * and Python ints), which
gives a program of ADD / SUB / MUL rows over four kinds of operand:

  - E_COL j: column j of e_t (a memory, pre.instruction_to_memory_indices);
  - F_COL k: column k of f_t (instruction k's flag);
  - CONST j: the program's constant j, in Montgomery form as DevF coerces
    an int (so `1 - x` is SUB(R mod p, x) and `x * 2^48` a Montgomery
    product by 2^48's Montgomery limbs, as fd.fmul does it on DevF);
  - SLOT s: a temporary, one of a few slots reused by liveness.

After each instruction's rows come its `f_k *` product and the running
sum, so the program's output slot holds inner.  The program and its
constant table are made once per (instruction classes, memories, C, M,
field) and uploaded once per device: an upload from host memory syncs
the stream.

`collate` runs the program in one K13 launch on CUDA tensors
(csrc/collate.cu, one thread per element); `collate_plain` runs the same
rows op by op with field/arith.py's plain limb functions, the sequence of
field ops that the `DevF` loop ran.  Residues mod p are unique, so both
give the `DevF` path's bits.
"""
from __future__ import annotations

import torch

from .. import _native as nat
from ..field import arith
from ..field import device as fd
from ..field import kernels as fk
from ..field.spec import FieldSpec

ADD, SUB, MUL = 0, 1, 2                   # op codes (csrc/collate.cu)
E_COL, F_COL, CONST, SLOT, _NODE = 0, 1, 2, 3, 4   # operand kinds
KIND_SHIFT = 16                           # operand = kind << 16 | index
MAX_SLOTS = 16                            # csrc/collate.cu MAX_SLOTS

COLLATE = nat.CudaKernel(
    "collate", "collate", "jt_collate",
    [nat.vptr] * 3 + [nat.i64] * 7 + [nat.vptr, nat.i64, nat.vptr, nat.i64,
                                      nat.i64, nat.u32p, nat.vptr],
    "jolt_tpu/vm/instruction_lookups.py:257-265 _g_term_jit (jax.jit) and "
    "the term sum :299-304", "collate_kernel", 256)


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


class Program:
    """A recorded collation program over `spec`: `rows` (op, dst slot, a,
    b) with operands as _ref gives them, the constants' canonical values,
    the slot that ends holding inner, and per device the uploaded
    tables."""

    def __init__(self, spec, rows, consts, out_slot, n_slots, columns,
                 n_flags):
        self.spec = spec
        self.rows = rows
        self.consts = consts
        self.out_slot = out_slot
        self.n_slots = n_slots
        self.columns = columns          # e_t's columns read, sorted
        self.n_flags = n_flags
        self.products = sum(op == MUL for op, _, _, _ in rows)
        self.adds = len(rows) - self.products
        self._tables: dict[torch.device, tuple] = {}

    def tables(self, device: torch.device):
        """(rows int32 [n, 4], constants' Montgomery limbs int32 [16, c])
        on `device`, uploaded on the first call for that device."""
        device = torch.device(device)
        if device not in self._tables:
            rows = torch.tensor(self.rows, dtype=torch.int32)
            consts = fd.pack_ints([self.spec.to_mont(v) for v in self.consts]
                                  ).astype("int32")
            self._tables[device] = (rows.to(device),
                                    torch.from_numpy(consts).to(device))
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


def record(classes, mems, C: int, M: int, spec: FieldSpec) -> Program:
    """Record sum_k F_COL k * combine_lookups_k(E_COL mems[k]) as one
    program."""
    tape = _Tape(spec.p)
    acc = None
    for k, (cls, mk) in enumerate(zip(classes, mems)):
        g = cls().combine_lookups([_Rec(tape, _ref(E_COL, mi)) for mi in mk],
                                  C, M)
        g = g.ref if isinstance(g, _Rec) else tape.const(g)
        term = tape.emit(MUL, _ref(F_COL, k), g)
        acc = term if acc is None else tape.emit(ADD, acc, term)
    rows, out_slot, n_slots = _allocate(tape.rows, acc)
    if n_slots > MAX_SLOTS:
        raise ValueError(f"collation program needs {n_slots} slots, K13 "
                         f"holds {MAX_SLOTS}")
    consts = sorted(tape.consts, key=tape.consts.get)
    columns = sorted({mi for mk in mems for mi in mk})
    return Program(spec, tuple(rows), tuple(consts), out_slot, n_slots,
                   tuple(columns), len(classes))


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


def _check(prog: Program, e_t: torch.Tensor, f_t: torch.Tensor) -> None:
    if e_t.dim() != 3 or f_t.dim() != 3 or e_t.shape[0] != fd.L or \
            f_t.shape[0] != fd.L or e_t.shape[2] != f_t.shape[2] or \
            e_t.shape[1] <= prog.columns[-1] or f_t.shape[1] < prog.n_flags:
        raise ValueError(f"collate: expected e_t [16, m, h] with m > "
                         f"{prog.columns[-1]} and f_t [16, {prog.n_flags}, "
                         f"h], got {tuple(e_t.shape)}, {tuple(f_t.shape)}")


def collate_plain(pre, e_t: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """inner [16, h] = sum_k f_t[:, k] * g_k(e_t[:, mems_k]): the program's
    rows op by op in plain limb arithmetic (arith.py)."""
    spec, prog = pre.spec, program(pre)
    _check(prog, e_t, f_t)
    consts = prog.tables(e_t.device)[1]
    slots: list = [None] * prog.n_slots
    src = {E_COL: lambda j: e_t[:, j], F_COL: lambda j: f_t[:, j],
           CONST: lambda j: consts[:, j:j + 1], SLOT: lambda j: slots[j]}
    mask = (1 << KIND_SHIFT) - 1
    for op, dst, a, b in prog.rows:
        x = src[a >> KIND_SHIFT](a & mask)
        y = src[b >> KIND_SHIFT](b & mask)
        slots[dst] = (arith.add if op == ADD else arith.sub if op == SUB
                      else arith.mont_mul)(spec, x, y)
    return slots[prog.out_slot].contiguous()


def collate(pre, e_t: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """collate_plain's function: one K13 launch on CUDA tensors, the plain
    version on CPU tensors.  e_t [16, m, h] and f_t [16, NI, h] go in as
    they are, any strides (the lo/hi halves of a round's [16, m, 2h] and
    [16, NI, 2h], K10's contiguous outputs); inner [16, h] comes out
    contiguous and reduced."""
    if e_t.device.type == f_t.device.type == "cpu":
        return collate_plain(pre, e_t, f_t)
    nat.require_cuda("collate", e_t, f_t)
    spec, prog = pre.spec, program(pre)
    _check(prog, e_t, f_t)
    h = e_t.shape[2]
    out = torch.empty((fd.L, h), dtype=torch.int32, device=e_t.device)
    if h == 0:
        return out
    rows, consts = prog.tables(e_t.device)
    COLLATE.launch(
        nat.ptr(e_t), nat.ptr(f_t), nat.ptr(out), h, *e_t.stride(),
        *f_t.stride(), nat.ptr(rows), rows.shape[0], nat.ptr(consts),
        consts.shape[1], prog.out_slot, fk.field_words(spec), nat.stream(out),
        device=out.device)
    return out
