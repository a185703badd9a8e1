"""Guest programs written against the mini-assembler
(jolt_tpu/vm/guests.py: sha2-chain and muldiv).

The reference ships Rust guest crates (examples/{fibonacci,sha2-chain,...})
built with a RISC-V rustc toolchain (jolt-core/src/host/mod.rs:100-166).
Without that toolchain, the same workloads are hand-assembled RV32I here;
`sha2_chain_program` is the reference's headline benchmark
(jolt-core/src/benches/bench.rs:212-246: sha2-chain end-to-end prove).

The SHA-256 guest is real: its output equals hashlib.sha256 iterated over
the 32-byte input (tests/test_torch_rv32i.py).
"""
from __future__ import annotations

import hashlib

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
