"""Guest programs written against the mini-assembler
(jolt_tpu/vm/guests.py).

The reference ships Rust guest crates (examples/{fibonacci,sha2-chain,...})
built with a RISC-V rustc toolchain (jolt-core/src/host/mod.rs:100-166).
Without that toolchain, the same workloads are hand-assembled RV32I here;
`sha2_chain_program` is the reference's headline benchmark
(jolt-core/src/benches/bench.rs:212-246: sha2-chain end-to-end prove).

The SHA-256 and SHA3-256 guests are real: their outputs equal
hashlib.sha256 and hashlib.sha3_256 iterated over the 32-byte input
(tests/test_torch_rv32i.py, tests/test_torch_guests.py).
"""
from __future__ import annotations

import hashlib

from ..utils.keccak import keccak256
from .host import Assembler
from .rv_trace import (DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE,
                       RAM_START_ADDRESS, RV32IM, MemoryLayout)

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
_H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]


class _Asm(Assembler):
    """Assembler with the extra mnemonics the SHA guest needs."""

    def li(self, rd, v):
        """Load a 32-bit constant (LUI+ADDI pair, or single ADDI)."""
        v &= 0xFFFFFFFF
        lo = v & 0xFFF
        if lo >= 0x800:                 # ADDI sign-extends its 12-bit imm
            hi = (v + 0x1000) & 0xFFFFF000
        else:
            hi = v & 0xFFFFF000
        if hi:
            self.emit(RV32IM.LUI, rd=rd, imm=hi)
            if lo or (v - hi) & 0xFFFFFFFF:
                self.emit(RV32IM.ADDI, rd=rd, rs1=rd, imm=(v - hi) & 0xFFFFFFFF)
        else:
            self.emit(RV32IM.ADDI, rd=rd, rs1=0, imm=v)

    def mv(self, rd, rs):
        self.emit(RV32IM.ADD, rd=rd, rs1=rs, rs2=0)

    def xor(self, rd, rs1, rs2):
        self.emit(RV32IM.XOR, rd=rd, rs1=rs1, rs2=rs2)

    def and_(self, rd, rs1, rs2):
        self.emit(RV32IM.AND, rd=rd, rs1=rs1, rs2=rs2)

    def or_(self, rd, rs1, rs2):
        self.emit(RV32IM.OR, rd=rd, rs1=rs1, rs2=rs2)

    def not_(self, rd, rs):
        self.emit(RV32IM.XORI, rd=rd, rs1=rs, imm=0xFFFFFFFF)

    def srli(self, rd, rs, sh):
        self.emit(RV32IM.SRLI, rd=rd, rs1=rs, imm=sh)

    def slli(self, rd, rs, sh):
        self.emit(RV32IM.SLLI, rd=rd, rs1=rs, imm=sh)

    def lbu(self, rd, rs1, imm):
        self.emit(RV32IM.LBU, rd=rd, rs1=rs1, imm=imm & 0xFFFFFFFF)

    def sb(self, rs1, rs2, imm):
        self.emit(RV32IM.SB, rs1=rs1, rs2=rs2, imm=imm & 0xFFFFFFFF)

    def ror(self, rd, rs, n, t1, t2):
        """rd = rotate-right(rs, n) via SRLI/SLLI/OR (no rotate in RV32I)."""
        self.srli(t1, rs, n)
        self.slli(t2, rs, 32 - n)
        self.or_(rd, t1, t2)


# register allocation for the compression loop
_A, _B, _C, _D, _E, _F, _G, _H = 8, 9, 10, 11, 12, 13, 14, 15
_WP, _KP, _HP = 16, 17, 18          # W / K / H base pointers
_T = 19                              # round counter
_BOUND = 20
_T1, _T2, _T3, _T4, _T5, _T6 = 21, 22, 23, 24, 25, 26
_ITER, _NITER = 29, 30
SHA2_INPUT = b"\x05" * 32           # the input cli.py and the tests hash
#   (jolt_tpu's cli.py:145-173)


def sha2_chain_program(n_iters: int,
                       data_base: int = RAM_START_ADDRESS + 0x2000):
    """hash = input (32 bytes); n_iters times: hash = sha256(hash);
    outputs the final 32-byte digest.

    Mirrors examples/sha2-chain/guest (reference headline workload).
    """
    asm = _Asm()
    # M = current 8-word message (input, then each digest); H0C = the SHA-256
    # initial-state constants (read-only after setup).
    K_base, M_base, W_base, H0C_base = (data_base, data_base + 0x100,
                                        data_base + 0x200, data_base + 0x300)

    # --- one-time setup: K table + H0 constants into RAM ------------------
    asm.li(_KP, K_base)
    for i, k in enumerate(_K):
        asm.li(_T1, k)
        asm.sw(_KP, _T1, 4 * i)
    asm.li(_HP, M_base)
    asm.li(_T6, H0C_base)
    for i, h in enumerate(_H0):
        asm.li(_T1, h)
        asm.sw(_T6, _T1, 4 * i)

    # M <- 8 big-endian words assembled from the 32 input bytes
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    asm.li(_T5, ml.input_start)
    for w in range(8):
        asm.lbu(_T1, _T5, 4 * w)
        asm.slli(_T1, _T1, 24)
        for b, sh in ((1, 16), (2, 8), (3, 0)):
            asm.lbu(_T2, _T5, 4 * w + b)
            if sh:
                asm.slli(_T2, _T2, sh)
            asm.or_(_T1, _T1, _T2)
        asm.sw(_HP, _T1, 4 * w)

    asm.li(_ITER, 0)
    asm.li(_NITER, n_iters)
    asm.li(_WP, W_base)

    # === chain loop =======================================================
    asm.label("chain")

    # --- W[0..15]: W[i] = M[i] for i < 8, then the 32-byte-message padding
    for w in range(8):
        asm.lw(_T1, _HP, 4 * w)
        asm.sw(_WP, _T1, 4 * w)
    asm.li(_T1, 0x80000000)
    asm.sw(_WP, _T1, 4 * 8)
    for w in range(9, 15):
        asm.sw(_WP, 0, 4 * w)
    asm.li(_T1, 256)                 # message length in bits
    asm.sw(_WP, _T1, 4 * 15)

    # --- W[16..63]: sigma expansion loop ----------------------------------
    asm.li(_T, 16)
    asm.li(_BOUND, 64)
    asm.label("schedule")
    asm.slli(_T3, _T, 2)
    asm.add(_T3, _WP, _T3)           # &W[t]
    # s0 = ror(W[t-15],7) ^ ror(W[t-15],18) ^ (W[t-15] >> 3)
    asm.lw(_T4, _T3, -60)
    asm.ror(_T1, _T4, 7, _T5, _T6)
    asm.ror(_T2, _T4, 18, _T5, _T6)
    asm.xor(_T1, _T1, _T2)
    asm.srli(_T2, _T4, 3)
    asm.xor(_T1, _T1, _T2)           # T1 = s0
    # s1 = ror(W[t-2],17) ^ ror(W[t-2],19) ^ (W[t-2] >> 10)
    asm.lw(_T4, _T3, -8)
    asm.ror(_T2, _T4, 17, _T5, _T6)
    asm.ror(_T5, _T4, 19, _T5, _T6)
    asm.xor(_T2, _T2, _T5)
    asm.srli(_T5, _T4, 10)
    asm.xor(_T2, _T2, _T5)           # T2 = s1
    # W[t] = W[t-16] + s0 + W[t-7] + s1
    asm.lw(_T4, _T3, -64)
    asm.add(_T1, _T1, _T4)
    asm.lw(_T4, _T3, -28)
    asm.add(_T1, _T1, _T4)
    asm.add(_T1, _T1, _T2)
    asm.sw(_T3, _T1, 0)
    asm.addi(_T, _T, 1)
    asm.bne(_T, _BOUND, "schedule")

    # --- load working state a..h from the H0 constants --------------------
    asm.li(_T6, H0C_base)
    for k, reg in enumerate((_A, _B, _C, _D, _E, _F, _G, _H)):
        asm.lw(reg, _T6, 4 * k)

    # --- 64 rounds ---------------------------------------------------------
    asm.li(_T, 0)
    asm.label("rounds")
    asm.slli(_T3, _T, 2)
    # S1 = ror(e,6)^ror(e,11)^ror(e,25)
    asm.ror(_T1, _E, 6, _T5, _T6)
    asm.ror(_T2, _E, 11, _T5, _T6)
    asm.xor(_T1, _T1, _T2)
    asm.ror(_T2, _E, 25, _T5, _T6)
    asm.xor(_T1, _T1, _T2)           # T1 = S1
    # ch = (e&f) ^ (~e & g)
    asm.and_(_T2, _E, _F)
    asm.not_(_T5, _E)
    asm.and_(_T5, _T5, _G)
    asm.xor(_T2, _T2, _T5)           # T2 = ch
    # temp1 = h + S1 + ch + K[t] + W[t]
    asm.add(_T1, _T1, _H)
    asm.add(_T1, _T1, _T2)
    asm.add(_T4, _KP, _T3)
    asm.lw(_T5, _T4, 0)
    asm.add(_T1, _T1, _T5)
    asm.add(_T4, _WP, _T3)
    asm.lw(_T5, _T4, 0)
    asm.add(_T1, _T1, _T5)           # T1 = temp1
    # S0 = ror(a,2)^ror(a,13)^ror(a,22)
    asm.ror(_T2, _A, 2, _T5, _T6)
    asm.ror(_T4, _A, 13, _T5, _T6)
    asm.xor(_T2, _T2, _T4)
    asm.ror(_T4, _A, 22, _T5, _T6)
    asm.xor(_T2, _T2, _T4)           # T2 = S0
    # maj = (a&b)^(a&c)^(b&c)
    asm.and_(_T4, _A, _B)
    asm.and_(_T5, _A, _C)
    asm.xor(_T4, _T4, _T5)
    asm.and_(_T5, _B, _C)
    asm.xor(_T4, _T4, _T5)           # T4 = maj
    asm.add(_T2, _T2, _T4)           # T2 = temp2
    # rotate registers
    asm.mv(_H, _G)
    asm.mv(_G, _F)
    asm.mv(_F, _E)
    asm.add(_E, _D, _T1)
    asm.mv(_D, _C)
    asm.mv(_C, _B)
    asm.mv(_B, _A)
    asm.add(_A, _T1, _T2)
    asm.addi(_T, _T, 1)
    asm.bne(_T, _BOUND, "rounds")

    # --- M <- digest = H0 + working state (the next chain message) --------
    asm.li(_T6, H0C_base)
    for k, reg in enumerate((_A, _B, _C, _D, _E, _F, _G, _H)):
        asm.lw(_T1, _T6, 4 * k)
        asm.add(_T1, _T1, reg)
        asm.sw(_HP, _T1, 4 * k)

    asm.addi(_ITER, _ITER, 1)
    asm.bne(_ITER, _NITER, "chain")

    # --- write the digest (big-endian bytes) to the output region ----------
    asm.li(_T5, ml.output_start)
    for w in range(8):
        asm.lw(_T1, _HP, 4 * w)
        for b, sh in ((0, 24), (1, 16), (2, 8), (3, 0)):
            if sh:
                asm.srli(_T2, _T1, sh)
            else:
                asm.mv(_T2, _T1)
            asm.sb(_T5, _T2, 4 * w + b)

    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def sha2_chain_expected(input_bytes: bytes, n_iters: int) -> bytes:
    """Host-side oracle: hashlib.sha256 iterated (what the guest computes)."""
    h = bytes(input_bytes)
    assert len(h) == 32
    for _ in range(n_iters):
        h = hashlib.sha256(h).digest()
    return h


# ---------------------------------------------------------------------------
# collatz (examples/collatz analog)
# ---------------------------------------------------------------------------

def collatz_program(start: int):
    """Counts Collatz steps from `start` to 1; writes the count (LE u32)
    to the output region.  Mirrors examples/collatz/guest."""
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    asm = _Asm()
    N, CNT, T1, T2 = 5, 6, 7, 8
    asm.li(N, start)
    asm.li(CNT, 0)
    asm.li(T2, 1)
    asm.label("loop")
    asm.emit(RV32IM.BEQ, rs1=N, rs2=T2, label="done")
    asm.emit(RV32IM.ANDI, rd=T1, rs1=N, imm=1)
    asm.emit(RV32IM.BNE, rs1=T1, rs2=0, label="odd")
    asm.srli(N, N, 1)                 # n /= 2
    asm.emit(RV32IM.JAL, rd=0, label="next")
    asm.label("odd")
    asm.slli(T1, N, 1)                # 3n + 1
    asm.add(N, N, T1)
    asm.addi(N, N, 1)
    asm.label("next")
    asm.addi(CNT, CNT, 1)
    asm.emit(RV32IM.JAL, rd=0, label="loop")
    asm.label("done")
    asm.li(T1, ml.output_start)
    asm.sw(T1, CNT, 0)
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def collatz_expected(start: int) -> int:
    n, cnt = start, 0
    while n != 1:
        n = n // 2 if n % 2 == 0 else 3 * n + 1
        cnt += 1
    return cnt


# ---------------------------------------------------------------------------
# SHA3-256 chain (examples/sha3-chain analog; hashlib.sha3_256-verified)
# ---------------------------------------------------------------------------

_KECCAK_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_KECCAK_ROT = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
               [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]


def sha3_chain_program(n_iters: int,
                       data_base: int = RAM_START_ADDRESS + 0x2000,
                       pad_byte: int = 0x06):
    """hash = input (32 bytes); n_iters times: hash = sha3_256(hash);
    outputs the final 32-byte digest.  pad_byte 0x06 = NIST SHA3-256
    (hashlib oracle); 0x01 = Ethereum Keccak-256 (transcript oracle).

    Mirrors examples/sha3-chain/guest.  Keccak-f[1600] runs as a JAL/JALR
    subroutine over 64-bit lanes held as RAM word pairs; the generator
    unrolls the x/y lane loops, the round loop stays a real loop over the
    RAM round-constant table.
    """
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    asm = _Asm()

    S, Bb, Cc, RC = (data_base, data_base + 0x100, data_base + 0x200,
                     data_base + 0x300)
    # registers
    SP, BP, CP, RCP, RND = 5, 6, 7, 8, 9
    T0, T1, T2, T3, T4, T5 = 10, 11, 12, 13, 14, 15
    ITER, NITER, MSGP = 28, 29, 30
    RA = 1

    def lane(base, x, y):
        return base + 8 * (x + 5 * y)

    def emit_rot(dst_lo, dst_hi, src_lo, src_hi, r):
        """(dst_lo, dst_hi) = 64-bit rotate-left of (src_lo, src_hi) by r.
        dst regs must differ from src regs; clobbers T4, T5."""
        r &= 63
        if r >= 32:
            src_lo, src_hi = src_hi, src_lo
            r -= 32
        if r == 0:
            asm.mv(dst_lo, src_lo)
            asm.mv(dst_hi, src_hi)
            return
        asm.slli(T4, src_lo, r)
        asm.srli(T5, src_hi, 32 - r)
        asm.or_(dst_lo, T4, T5)
        asm.slli(T4, src_hi, r)
        asm.srli(T5, src_lo, 32 - r)
        asm.or_(dst_hi, T4, T5)

    # --- one-time setup: round constants into RAM -------------------------
    asm.li(RCP, RC)
    for i, rc in enumerate(_KECCAK_RC):
        asm.li(T0, rc & 0xFFFFFFFF)
        asm.sw(RCP, T0, 8 * i)
        asm.li(T0, rc >> 32)
        asm.sw(RCP, T0, 8 * i + 4)
    asm.li(SP, S)
    asm.li(BP, Bb)
    asm.li(CP, Cc)
    asm.li(ITER, 0)
    asm.li(NITER, n_iters)
    asm.li(MSGP, ml.input_start)
    asm.emit(RV32IM.JAL, rd=0, label="chain")

    # === keccak-f[1600] subroutine ========================================
    asm.label("keccakf")
    asm.li(RND, 0)
    asm.label("round")
    # --- theta: C[x] = xor_y S[x,y]; D[x] = C[x-1] ^ rot1(C[x+1]) ---------
    for x in range(5):
        for w in range(2):
            asm.lw(T0, SP, lane(0, x, 0) + 4 * w)
            for y in range(1, 5):
                asm.lw(T1, SP, lane(0, x, y) + 4 * w)
                asm.xor(T0, T0, T1)
            asm.sw(CP, T0, 8 * x + 4 * w)
    for x in range(5):
        # D = C[(x+4)%5] ^ rot1(C[(x+1)%5]); S[x,y] ^= D
        asm.lw(T0, CP, 8 * ((x + 1) % 5))          # c1 lo
        asm.lw(T1, CP, 8 * ((x + 1) % 5) + 4)      # c1 hi
        emit_rot(T2, T3, T0, T1, 1)
        asm.lw(T0, CP, 8 * ((x + 4) % 5))
        asm.lw(T1, CP, 8 * ((x + 4) % 5) + 4)
        asm.xor(T2, T2, T0)                        # D lo
        asm.xor(T3, T3, T1)                        # D hi
        for y in range(5):
            asm.lw(T0, SP, lane(0, x, y))
            asm.xor(T0, T0, T2)
            asm.sw(SP, T0, lane(0, x, y))
            asm.lw(T0, SP, lane(0, x, y) + 4)
            asm.xor(T0, T0, T3)
            asm.sw(SP, T0, lane(0, x, y) + 4)
    # --- rho + pi: B[y, 2x+3y] = rot(S[x,y], r[x,y]) ----------------------
    for x in range(5):
        for y in range(5):
            asm.lw(T0, SP, lane(0, x, y))
            asm.lw(T1, SP, lane(0, x, y) + 4)
            emit_rot(T2, T3, T0, T1, _KECCAK_ROT[x][y])
            dst = lane(0, y, (2 * x + 3 * y) % 5)
            asm.sw(BP, T2, dst)
            asm.sw(BP, T3, dst + 4)
    # --- chi: S[x,y] = B[x,y] ^ (~B[x+1,y] & B[x+2,y]) --------------------
    for y in range(5):
        for x in range(5):
            for w in range(2):
                asm.lw(T0, BP, lane(0, x, y) + 4 * w)
                asm.lw(T1, BP, lane(0, (x + 1) % 5, y) + 4 * w)
                asm.lw(T2, BP, lane(0, (x + 2) % 5, y) + 4 * w)
                asm.not_(T1, T1)
                asm.and_(T1, T1, T2)
                asm.xor(T0, T0, T1)
                asm.sw(SP, T0, lane(0, x, y) + 4 * w)
    # --- iota: S[0,0] ^= RC[round] ----------------------------------------
    asm.slli(T0, RND, 3)
    asm.add(T0, RCP, T0)
    asm.lw(T1, T0, 0)
    asm.lw(T2, SP, 0)
    asm.xor(T2, T2, T1)
    asm.sw(SP, T2, 0)
    asm.lw(T1, T0, 4)
    asm.lw(T2, SP, 4)
    asm.xor(T2, T2, T1)
    asm.sw(SP, T2, 4)
    asm.addi(RND, RND, 1)
    asm.li(T0, 24)
    asm.emit(RV32IM.BNE, rs1=RND, rs2=T0, label="round")
    asm.emit(RV32IM.JALR, rd=0, rs1=RA, imm=0)     # return

    # === chain loop =======================================================
    asm.label("chain")
    # state <- message words 0..7, zeros elsewhere, absorb padding
    for w in range(8):
        asm.lw(T0, MSGP, 4 * w)
        asm.sw(SP, T0, 4 * w)
    for w in range(8, 50):
        asm.sw(SP, 0, 4 * w)
    asm.li(T0, pad_byte)                  # pad byte at offset 32 (word 8)
    asm.sw(SP, T0, 32)
    asm.li(T0, 0x80000000)                # 0x80 at byte 135 (word 33 top)
    asm.lw(T1, SP, 132)
    asm.xor(T1, T1, T0)
    asm.sw(SP, T1, 132)
    asm.emit(RV32IM.JAL, rd=RA, label="keccakf")
    # digest = state words 0..7 -> becomes next message (stash in B area)
    for w in range(8):
        asm.lw(T0, SP, 4 * w)
        asm.sw(BP, T0, 0x80 + 4 * w)      # scratch copy (B unused between perms)
    asm.li(MSGP, Bb + 0x80)               # subsequent iterations read scratch
    asm.addi(ITER, ITER, 1)
    asm.emit(RV32IM.BNE, rs1=ITER, rs2=NITER, label="chain")

    # --- write digest bytes to the output region --------------------------
    asm.li(T5, ml.output_start)
    for w in range(8):
        asm.lw(T0, BP, 0x80 + 4 * w)
        for b in range(4):
            if b:
                asm.srli(T1, T0, 8 * b)
                asm.sb(T5, T1, 4 * w + b)
            else:
                asm.sb(T5, T0, 4 * w + b)
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def sha3_chain_expected(input_bytes: bytes, n_iters: int,
                        pad_byte: int = 0x06) -> bytes:
    """Host oracle: hashlib.sha3_256 (NIST pad 0x06) or the transcript's
    keccak256 (Ethereum pad 0x01) iterated."""
    h = bytes(input_bytes)
    if len(h) != 32:
        raise ValueError("sha3-chain hashes a 32-byte input")
    for _ in range(n_iters):
        if pad_byte == 0x06:
            h = hashlib.sha3_256(h).digest()
        else:
            h = keccak256(h)
    return h


# ---------------------------------------------------------------------------
# alloc (RAM-heavy) — examples/alloc analog
# ---------------------------------------------------------------------------

def alloc_sum_program(n: int, heap_base: int = RAM_START_ADDRESS + 0x2000):
    """Heap workload: "allocate" an n-element u32 vector on a bump heap,
    fill slot i with i*i (via repeated addition — no M extension), then
    re-walk the vector summing it; outputs the LE u32 sum.

    Mirrors examples/alloc/guest (a Vec fill+sum): the point is a RAM
    footprint of 4n bytes far above the I/O region, so read_write_memory's
    remap/v_final paths see real pressure instead of a handful of words.
    """
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    asm = _Asm()
    HP, I, NR, SQ, ACC, T1 = 5, 6, 7, 8, 9, 10
    asm.li(HP, heap_base)      # bump pointer
    asm.li(NR, n)
    asm.li(I, 0)
    asm.li(SQ, 0)              # i*i, maintained incrementally: +2i+1
    asm.label("fill")
    asm.emit(RV32IM.BEQ, rs1=I, rs2=NR, label="sum")
    asm.slli(T1, I, 2)
    asm.add(T1, HP, T1)
    asm.sw(T1, SQ, 0)          # heap[i] = i*i
    asm.slli(T1, I, 1)         # sq += 2i + 1  -> (i+1)^2
    asm.add(SQ, SQ, T1)
    asm.addi(SQ, SQ, 1)
    asm.addi(I, I, 1)
    asm.emit(RV32IM.JAL, rd=0, label="fill")
    asm.label("sum")
    asm.li(I, 0)
    asm.li(ACC, 0)
    asm.label("sloop")
    asm.emit(RV32IM.BEQ, rs1=I, rs2=NR, label="out")
    asm.slli(T1, I, 2)
    asm.add(T1, HP, T1)
    asm.lw(T1, T1, 0)
    asm.add(ACC, ACC, T1)
    asm.addi(I, I, 1)
    asm.emit(RV32IM.JAL, rd=0, label="sloop")
    asm.label("out")
    asm.li(T1, ml.output_start)
    asm.sw(T1, ACC, 0)
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def alloc_sum_expected(n: int) -> int:
    return sum(i * i for i in range(n)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# multi-function — examples/multi-function analog
# ---------------------------------------------------------------------------

def multi_function_program(n: int):
    """Call-graph workload: main loops i=1..n calling square(i) and
    double(i) through real JAL/JALR call+return linkage (ra = x1), summing
    square(i) + double(i); outputs the LE u32 total.

    Mirrors examples/multi-function/guest: many small functions, so the
    bytecode read-set and PC flow (JALR with dynamic ra) dominate instead
    of one straight-line loop body.
    """
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    asm = _Asm()
    RA, A0, A1 = 1, 10, 11     # standard link/arg/ret registers
    I, NR, ACC, T1 = 5, 6, 7, 28
    asm.li(I, 1)
    asm.li(NR, n)
    asm.li(ACC, 0)
    asm.label("loop")
    asm.mv(A0, I)
    asm.emit(RV32IM.JAL, rd=RA, label="square")
    asm.add(ACC, ACC, A1)
    asm.mv(A0, I)
    asm.emit(RV32IM.JAL, rd=RA, label="double")
    asm.add(ACC, ACC, A1)
    asm.addi(I, I, 1)
    asm.emit(RV32IM.BGE, rs1=NR, rs2=I, label="loop")
    asm.li(T1, ml.output_start)
    asm.sw(T1, ACC, 0)
    asm.label("halt")
    asm.jal(0, "halt")
    # square(a0) -> a1 via repeated addition (loop with its own registers)
    asm.label("square")
    asm.li(A1, 0)
    asm.li(T1, 0)
    asm.label("sq_loop")
    asm.emit(RV32IM.BEQ, rs1=T1, rs2=A0, label="sq_done")
    asm.add(A1, A1, A0)
    asm.addi(T1, T1, 1)
    asm.emit(RV32IM.JAL, rd=0, label="sq_loop")
    asm.label("sq_done")
    asm.emit(RV32IM.JALR, rd=0, rs1=RA, imm=0)    # ret
    # double(a0) -> a1
    asm.label("double")
    asm.add(A1, A0, A0)
    asm.emit(RV32IM.JALR, rd=0, rs1=RA, imm=0)    # ret
    return asm.finish()


def multi_function_expected(n: int) -> int:
    return sum(i * i + 2 * i for i in range(1, n + 1)) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# stdlib — examples/stdlib analog (string_concat: decimal formatting onto a
# heap-grown string)
# ---------------------------------------------------------------------------

def stdlib_program(n: int, heap_base: int = RAM_START_ADDRESS + 0x2000):
    """examples/stdlib/guest string_concat(n) analog: builds the
    concatenation of the decimal strings "0".."n-1" in a heap buffer —
    per-i digit extraction via division-by-10 (repeated subtraction; no M
    extension), reversed digit append, byte loads/stores throughout — and
    copies the final string to the output region.  The point, as in the
    reference, is byte-granular heap string growth (Rust String ops
    lowered to RV32I)."""
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    asm = _Asm()
    HP, LEN, I, NR = 5, 6, 7, 8        # string buf, string len, loop i, n
    V, Q, D, TMP, T1, T2, TEN = 9, 10, 11, 12, 13, 14, 15
    asm.li(HP, heap_base)
    asm.li(TMP, heap_base + 0x10000)   # reversed-digit scratch
    asm.li(NR, n)
    asm.li(TEN, 10)
    asm.li(LEN, 0)
    asm.li(I, 0)
    asm.label("iloop")
    asm.emit(RV32IM.BEQ, rs1=I, rs2=NR, label="emit_out")
    asm.mv(V, I)
    asm.li(D, 0)
    asm.label("digits")                # do { extract V%10 } while V
    asm.li(Q, 0)
    asm.label("div10")                 # Q = V/10, V = V%10
    asm.emit(RV32IM.BLTU, rs1=V, rs2=TEN, label="div_done")
    asm.addi(V, V, -10)
    asm.addi(Q, Q, 1)
    asm.emit(RV32IM.JAL, rd=0, label="div10")
    asm.label("div_done")
    asm.addi(V, V, 0x30)               # ASCII digit
    asm.add(T1, TMP, D)
    asm.sb(T1, V, 0)
    asm.addi(D, D, 1)
    asm.mv(V, Q)
    asm.emit(RV32IM.BNE, rs1=V, rs2=0, label="digits")
    asm.label("append")                # append TMP[D-1..0] to string
    asm.emit(RV32IM.BEQ, rs1=D, rs2=0, label="inext")
    asm.addi(D, D, -1)
    asm.add(T1, TMP, D)
    asm.lbu(T2, T1, 0)
    asm.add(T1, HP, LEN)
    asm.sb(T1, T2, 0)
    asm.addi(LEN, LEN, 1)
    asm.emit(RV32IM.JAL, rd=0, label="append")
    asm.label("inext")
    asm.addi(I, I, 1)
    asm.emit(RV32IM.JAL, rd=0, label="iloop")
    asm.label("emit_out")              # copy string to output region
    asm.li(T1, ml.output_start)
    asm.li(D, 0)
    asm.label("copy")
    asm.emit(RV32IM.BEQ, rs1=D, rs2=LEN, label="halt")
    asm.add(T2, HP, D)
    asm.lbu(V, T2, 0)
    asm.add(T2, T1, D)
    asm.sb(T2, V, 0)
    asm.addi(D, D, 1)
    asm.emit(RV32IM.JAL, rd=0, label="copy")
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def stdlib_expected(n: int) -> bytes:
    return "".join(str(i) for i in range(n)).encode()


# ---------------------------------------------------------------------------
# muldiv — examples/muldiv analog (M-extension a*b/c, virtual sequences)
# ---------------------------------------------------------------------------

def muldiv_program(a: int = 123, b: int = 45, c: int = 7):
    """examples/muldiv guest analog: computes a*b/c with real M-extension
    MUL/DIVU (each expanding into its virtual instruction sequence in the
    trace, vm/virtual_sequences.py) and writes the LE u32 quotient to the
    output region."""
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    asm = _Asm()
    asm.li(1, a)
    asm.li(2, b)
    asm.li(3, c)
    asm.emit(RV32IM.MUL, rd=4, rs1=1, rs2=2)
    asm.emit(RV32IM.DIVU, rd=5, rs1=4, rs2=3)
    asm.li(6, ml.output_start)
    asm.sw(6, 5, 0)
    asm.label("halt")
    asm.jal(0, "halt")
    return asm.finish()


def muldiv_expected(a: int = 123, b: int = 45, c: int = 7) -> int:
    return ((a * b) & 0xFFFFFFFF) // c
