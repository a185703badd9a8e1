"""M-extension virtual sequences (reference: jolt/instruction/{div,divu,rem,
remu,mulh,mulhsu}.rs + VirtualInstructionSequence, instruction/mod.rs:128-148).

DIV/DIVU/REM/REMU/MULH/MULHSU are expanded at trace AND bytecode-preprocess
time into sequences of provable instructions over virtual registers 32..63.
Every row in a sequence shares the original ELF address and carries
virtual_sequence_remaining (sequence length - position - 1), which drives
both bytecode virtual addressing and the R1CS DoNotUpdatePC flag.

Note: the reference's signed DIV/REM advice adjusts truncated division so
the remainder's sign matches the divisor's (div.rs:36-58) — replicated
exactly (what is proven must match what the emulator computes).
"""
from __future__ import annotations

from .rv_trace import (ELFInstruction, RegisterState, RV32IM, RVTraceRow,
                       virtual_register_index)

U32 = 0xFFFFFFFF


def _s32(v):
    v &= U32
    return v - (1 << 32) if v & (1 << 31) else v


def _signed_divmod(x: int, y: int) -> tuple[int, int]:
    """Truncated division adjusted so sign(rem) == sign(div) (div.rs:36-58)."""
    xs, ys = _s32(x), _s32(y)
    if ys == 0:
        return U32, x & U32
    q = int(xs / ys)  # truncation toward zero
    r = xs - q * ys
    if (r < 0 < ys) or (r > 0 > ys):
        r += ys
        q -= 1
    return q & U32, r & U32


def _unsigned_divmod(x: int, y: int) -> tuple[int, int]:
    if y == 0:
        return U32, x
    return x // y, x % y


def _row(address, opcode, remaining, rs1=None, rs2=None, rd=None,
         rs1_val=None, rs2_val=None, rd_post=None, advice=None) -> RVTraceRow:
    return RVTraceRow(
        instruction=ELFInstruction(
            address=address, opcode=opcode, rs1=rs1, rs2=rs2, rd=rd,
            imm=None, virtual_sequence_remaining=remaining),
        register_state=RegisterState(rs1_val=rs1_val, rs2_val=rs2_val,
                                     rd_post_val=rd_post),
        memory_state=None, advice_value=advice)


def _movsign(v):
    return U32 if v & (1 << 31) else 0


def expand_m_extension(row: RVTraceRow) -> list[RVTraceRow]:
    """Expand one trace row; identity for non-M-extension opcodes."""
    op = row.instruction.opcode
    if op not in (RV32IM.DIV, RV32IM.DIVU, RV32IM.REM, RV32IM.REMU,
                  RV32IM.MULH, RV32IM.MULHSU):
        return [row]

    a = row.instruction.address
    r_x, r_y = row.instruction.rs1, row.instruction.rs2
    rd = row.instruction.rd
    x = row.register_state.rs1_val or 0
    y = row.register_state.rs2_val or 0
    v = [virtual_register_index(i) for i in range(6)]
    out: list[RVTraceRow] = []

    def push(length, *args, **kwargs):
        out.append(_row(a, *args, remaining=length - len(out) - 1, **kwargs))

    if op in (RV32IM.DIV, RV32IM.REM):
        q, r = _signed_divmod(x, y)
        length = 8 if op == RV32IM.DIV else 7
        v0, vq, vr, vqy = v[0], v[1], v[2], v[3]
        push(length, RV32IM.VIRTUAL_ADVICE, rd=vq, rd_post=q, advice=q)
        push(length, RV32IM.VIRTUAL_ADVICE, rd=vr, rd_post=r, advice=r)
        push(length, RV32IM.VIRTUAL_ASSERT_VALID_SIGNED_REMAINDER,
             rs1=vr, rs2=r_y, rs1_val=r, rs2_val=y)
        if op == RV32IM.DIV:
            push(length, RV32IM.VIRTUAL_ASSERT_VALID_DIV0,
                 rs1=r_y, rs2=vq, rs1_val=y, rs2_val=q)
        qy = (_s32(q) * _s32(y)) & U32
        push(length, RV32IM.MUL, rs1=vq, rs2=r_y, rd=vqy,
             rs1_val=q, rs2_val=y, rd_post=qy)
        add0 = (qy + r) & U32
        push(length, RV32IM.ADD, rs1=vqy, rs2=vr, rd=v0,
             rs1_val=qy, rs2_val=r, rd_post=add0)
        push(length, RV32IM.VIRTUAL_ASSERT_EQ, rs1=v0, rs2=r_x,
             rs1_val=add0, rs2_val=x)
        res_reg, res = (vq, q) if op == RV32IM.DIV else (vr, r)
        push(length, RV32IM.VIRTUAL_MOVE, rs1=res_reg, rd=rd,
             rs1_val=res, rd_post=res)
        assert len(out) == length
        return out

    if op in (RV32IM.DIVU, RV32IM.REMU):
        q, r = _unsigned_divmod(x, y)
        length = 9 if op == RV32IM.DIVU else 8
        v0, vq, vr, vqy = v[0], v[1], v[2], v[3]
        push(length, RV32IM.VIRTUAL_ADVICE, rd=vq, rd_post=q, advice=q)
        push(length, RV32IM.VIRTUAL_ADVICE, rd=vr, rd_post=r, advice=r)
        qy = (q * y) & U32
        push(length, RV32IM.MULU, rs1=vq, rs2=r_y, rd=vqy,
             rs1_val=q, rs2_val=y, rd_post=qy)
        push(length, RV32IM.VIRTUAL_ASSERT_VALID_UNSIGNED_REMAINDER,
             rs1=vr, rs2=r_y, rs1_val=r, rs2_val=y)
        push(length, RV32IM.VIRTUAL_ASSERT_LTE, rs1=vqy, rs2=r_x,
             rs1_val=qy, rs2_val=x)
        if op == RV32IM.DIVU:
            push(length, RV32IM.VIRTUAL_ASSERT_VALID_DIV0,
                 rs1=r_y, rs2=vq, rs1_val=y, rs2_val=q)
        add0 = (qy + r) & U32
        push(length, RV32IM.ADD, rs1=vqy, rs2=vr, rd=v0,
             rs1_val=qy, rs2_val=r, rd_post=add0)
        push(length, RV32IM.VIRTUAL_ASSERT_EQ, rs1=v0, rs2=r_x,
             rs1_val=add0, rs2_val=x)
        res_reg, res = (vq, q) if op == RV32IM.DIVU else (vr, r)
        push(length, RV32IM.VIRTUAL_MOVE, rs1=res_reg, rd=rd,
             rs1_val=res, rd_post=res)
        assert len(out) == length
        return out

    if op == RV32IM.MULH:
        length = 7
        v_sx, v_sy, v0, v1, v2, v3 = v
        sx, sy = _movsign(x), _movsign(y)
        push(length, RV32IM.VIRTUAL_MOVSIGN, rs1=r_x, rd=v_sx,
             rs1_val=x, rd_post=sx)
        push(length, RV32IM.VIRTUAL_MOVSIGN, rs1=r_y, rd=v_sy,
             rs1_val=y, rd_post=sy)
        hi = (x * y) >> 32
        push(length, RV32IM.MULHU, rs1=r_x, rs2=r_y, rd=v0,
             rs1_val=x, rs2_val=y, rd_post=hi)
        sxy = (sx * y) & U32
        push(length, RV32IM.MULU, rs1=v_sx, rs2=r_y, rd=v1,
             rs1_val=sx, rs2_val=y, rd_post=sxy)
        syx = (sy * x) & U32
        push(length, RV32IM.MULU, rs1=v_sy, rs2=r_x, rd=v2,
             rs1_val=sy, rs2_val=x, rd_post=syx)
        partial = (hi + sxy) & U32
        push(length, RV32IM.ADD, rs1=v0, rs2=v1, rd=v3,
             rs1_val=hi, rs2_val=sxy, rd_post=partial)
        result = (partial + syx) & U32
        push(length, RV32IM.ADD, rs1=v3, rs2=v2, rd=rd,
             rs1_val=partial, rs2_val=syx, rd_post=result)
        assert len(out) == length
        return out

    # MULHSU
    length = 4
    v_sx, v1, v2 = v[0], v[1], v[2]
    sx = _movsign(x)
    push(length, RV32IM.VIRTUAL_MOVSIGN, rs1=r_x, rd=v_sx,
         rs1_val=x, rd_post=sx)
    hi = (x * y) >> 32
    push(length, RV32IM.MULHU, rs1=r_x, rs2=r_y, rd=v1,
         rs1_val=x, rs2_val=y, rd_post=hi)
    sxy = (sx * y) & U32
    push(length, RV32IM.MULU, rs1=v_sx, rs2=r_y, rd=v2,
         rs1_val=sx, rs2_val=y, rd_post=sxy)
    result = (hi + sxy) & U32
    push(length, RV32IM.ADD, rs1=v1, rs2=v2, rd=rd,
         rs1_val=hi, rs2_val=sxy, rd_post=result)
    assert len(out) == length
    return out


SEQUENCE_LENGTHS = {RV32IM.DIV: 8, RV32IM.DIVU: 9, RV32IM.REM: 7,
                    RV32IM.REMU: 8, RV32IM.MULH: 7, RV32IM.MULHSU: 4}


def expand_bytecode(instructions: list[ELFInstruction]) -> list[ELFInstruction]:
    """Preprocess-time expansion (vm/mod.rs:283-295): each M-ext instruction
    becomes SEQUENCE_LENGTH rows at the same address with descending
    virtual_sequence_remaining; opcodes chosen by a dummy expansion."""
    out = []
    for instr in instructions:
        if instr.opcode not in SEQUENCE_LENGTHS:
            out.append(instr)
            continue
        dummy = RVTraceRow(instruction=instr,
                           register_state=RegisterState(rs1_val=0, rs2_val=1,
                                                        rd_post_val=0))
        for row in expand_m_extension(dummy):
            out.append(row.instruction)
    return out
