"""The port's native (C++) host runtime: the RV32IM tracer and Keccak-256
(jolt_tpu/native/).

`tracer.cpp` and `keccak.cpp` are compiled by g++ at first use into
`jolt_tpu_torch/_build/` (`utils/caches.py` `build_dir`; JOLT_TPU_CACHE_DIR
overrides), beside the CUDA libraries; each library's file
name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded.  A failed build or trace
raises: nothing falls back to Python.  The Python versions stay as the
oracles a caller asks for by name (`trace_program(native=False)`,
`utils.keccak.keccak256_py`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..utils.caches import build_dir

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(build_dir())
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

# Must match enum Opc in tracer.cpp.  Keys are RV32IM enum member names.
OPCODE_CODES = {name: k + 1 for k, name in enumerate([
    "ADD", "SUB", "XOR", "OR", "AND", "SLL", "SRL", "SRA",
    "SLT", "SLTU", "ADDI", "XORI", "ORI", "ANDI", "SLLI", "SRLI",
    "SRAI", "SLTI", "SLTIU", "LB", "LH", "LW", "LBU", "LHU",
    "SB", "SH", "SW", "BEQ", "BNE", "BLT", "BGE", "BLTU",
    "BGEU", "JAL", "JALR", "LUI", "AUIPC", "ECALL", "EBREAK",
    "MUL", "MULH", "MULHU", "MULHSU", "MULU", "DIV",
    "DIVU", "REM", "REMU", "FENCE", "UNIMPL",
    "VIRTUAL_MOVSIGN", "VIRTUAL_MOVE",
])}

_ERRORS = {-1: "no instruction at PC", -2: "unknown opcode",
           -3: "memory access out of modeled range", -4: "step limit reached"}


def lib_path(src_name: str, lib_stem: str) -> Path:
    h = hashlib.sha256((SRC_DIR / src_name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"{lib_stem}-{h.hexdigest()[:16]}.so"


def _compile(src_name: str, lib_stem: str) -> Path:
    """Build `src_name` into its library unless it is built; returns the
    library's path.  Raises RuntimeError when the compiler is missing or
    fails."""
    out = lib_path(src_name, lib_stem)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC_DIR / src_name)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build of {src_name}: cannot run "
                           f"{CXX!r} ({e})") from e
    if proc.returncode:
        raise RuntimeError(f"native build of {src_name} failed "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def compiler_version() -> str:
    """The compiler `_compile` runs: its path and first version line."""
    path = shutil.which(CXX) or CXX
    ver = subprocess.run([path, "--version"], capture_output=True, text=True)
    return f"{path}: {ver.stdout.splitlines()[0] if ver.stdout else '?'}"


@functools.cache
def tracer_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_compile("tracer.cpp", "libjolt_tracer")))
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.jolt_trace.restype = ctypes.c_int64
    lib.jolt_trace.argtypes = [
        ctypes.c_int64, u32p, u16p, i16p, i16p, i16p, u32p,
        u8p, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_int64,
        u32p, u32p, u32p, u32p, u8p, u32p, u32p,
        u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib


@functools.cache
def keccak_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_compile("keccak.cpp", "libjolt_keccak")))
    lib.jolt_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                   ctypes.c_char_p]
    lib.jolt_keccak256.restype = None
    return lib


def keccak256(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(32)
    keccak_library().jolt_keccak256(data, len(data), out)
    return out.raw


class TraceColumns:
    """Columnar trace rows (indices into the program + per-step state)."""

    def __init__(self, instr_idx, rs1_val, rs2_val, rd_val, mem_kind,
                 mem_addr, mem_val):
        self.instr_idx = instr_idx
        self.rs1_val = rs1_val
        self.rs2_val = rs2_val
        self.rd_val = rd_val
        self.mem_kind = mem_kind
        self.mem_addr = mem_addr
        self.mem_val = mem_val

    def __len__(self):
        return len(self.instr_idx)


def pack_program(program):
    """ELFInstruction list -> parallel numpy arrays for the C ABI."""
    n = len(program)
    addr = np.zeros(n, np.uint32)
    opc = np.zeros(n, np.uint16)
    rd = np.full(n, -1, np.int16)
    rs1 = np.full(n, -1, np.int16)
    rs2 = np.full(n, -1, np.int16)
    imm = np.zeros(n, np.uint32)
    for i, ins in enumerate(program):
        addr[i] = ins.address & 0xFFFFFFFF
        opc[i] = OPCODE_CODES[ins.opcode.name]
        if ins.rd is not None:
            rd[i] = ins.rd
        if ins.rs1 is not None:
            rs1[i] = ins.rs1
        if ins.rs2 is not None:
            rs2[i] = ins.rs2
        if ins.imm is not None:
            imm[i] = ins.imm & 0xFFFFFFFF
    return addr, opc, rd, rs1, rs2, imm


def trace_columnar(program, device, max_steps: int = 1 << 26,
                   memory_size: int = 1 << 25) -> TraceColumns:
    """Run the native emulator; sets `device`'s outputs and panic flag."""
    lib = tracer_library()
    addr, opc, rd, rs1, rs2, imm = pack_program(program)
    ml = device.memory_layout
    mem_lo = min(int(addr.min()) if len(addr) else ml.input_start,
                 ml.input_start)
    mem_cap = max(int(addr.max()) + 4 if len(addr) else 0,
                  mem_lo + memory_size) - mem_lo
    inputs = np.frombuffer(bytes(device.inputs), np.uint8) \
        if device.inputs else np.zeros(0, np.uint8)

    outputs_cap = ml.max_output_size + 1
    outputs_buf = np.zeros(outputs_cap, np.uint8)
    outputs_len = ctypes.c_int64(0)
    panic = ctypes.c_uint8(0)

    # Grow the row buffers geometrically: rerunning the emulator costs
    # less than allocating max_steps rows up front.
    cap = min(1 << 18, max_steps)
    while True:
        out = {k: np.zeros(cap, np.uint32)
               for k in ("instr", "rs1", "rs2", "rd", "maddr", "mval")}
        mem_kind = np.zeros(cap, np.uint8)
        n = lib.jolt_trace(
            len(program), addr, opc, rd, rs1, rs2, imm,
            inputs, len(inputs),
            ml.input_start, ml.input_end, ml.output_start, ml.panic,
            mem_lo, mem_cap, cap,
            out["instr"], out["rs1"], out["rs2"], out["rd"], mem_kind,
            out["maddr"], out["mval"],
            outputs_buf, outputs_cap,
            ctypes.byref(outputs_len), ctypes.byref(panic))
        if n == -4 and cap < max_steps:
            cap = min(cap * 8, max_steps)
            continue
        break
    if n < 0:
        raise RuntimeError(f"native tracer failed: {_ERRORS.get(n, n)}")

    device.outputs[:] = bytearray(outputs_buf[:outputs_len.value].tobytes())
    device.panic = bool(panic.value)
    return TraceColumns(out["instr"][:n].copy(), out["rs1"][:n].copy(),
                        out["rs2"][:n].copy(), out["rd"][:n].copy(),
                        mem_kind[:n].copy(), out["maddr"][:n].copy(),
                        out["mval"][:n].copy())


def trace_native(program, device, max_steps: int = 1 << 26):
    """Native emulation returning the same RVTraceRow list as
    tracer.emulator.Emulator.run(), row for row."""
    from ..vm.rv_trace import MemoryState, RegisterState, RVTraceRow
    cols = trace_columnar(program, device, max_steps)
    rows = []
    for i in range(len(cols)):
        ins = program[int(cols.instr_idx[i])]
        mem_state = None
        if cols.mem_kind[i]:
            mem_state = MemoryState(bool(cols.mem_kind[i] == 2),
                                    int(cols.mem_addr[i]),
                                    int(cols.mem_val[i]))
        rows.append(RVTraceRow(
            instruction=ins,
            register_state=RegisterState(
                rs1_val=int(cols.rs1_val[i]) if ins.rs1 is not None else None,
                rs2_val=int(cols.rs2_val[i]) if ins.rs2 is not None else None,
                rd_post_val=int(cols.rd_val[i]) if ins.rd is not None
                else None),
            memory_state=mem_state,
            advice_value=None))
    return rows
