"""Build, load and count the port's hand-written CUDA kernels.

Each source `csrc/<name>.cu` (with `csrc/field.cuh`) is compiled by `nvcc`
for `sm_90a` into a shared library with a plain C interface, at first use,
into `jolt_tpu_torch/_build/`.  The library's file name carries a hash of
its sources and flags, so an edited source is rebuilt and a stale library
is never loaded.  `build()` starts one `nvcc` per source, all at once.

Every kernel is a `CudaKernel`: its C symbol, the TPU kernel it replaces,
the CUDA function it launches with its threads per block (as the source's
launch bounds fix them), and `launches`, the count of its launches.  A wrapper calls `launch` once
per launch of its kernel and nowhere else, so a run can show which kernels
it went through (`launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("mont", "gp_pair", "point")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

KERNELS: list["CudaKernel"] = []

vptr = ctypes.c_void_p
i64 = ctypes.c_int64
u32p = ctypes.POINTER(ctypes.c_uint32)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built where "
                       "the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in ("field.cuh", f"{name}.cu"):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every missing library, one nvcc process per source, started
    together.  Returns {name: compiler stderr} (the -Xptxas -v report when
    `ptxas_verbose`); raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode:
            failed.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{text}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def library(name: str) -> ctypes.CDLL:
    build([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    lib.jt_error_string.argtypes = [ctypes.c_int]
    lib.jt_error_string.restype = ctypes.c_char_p
    return lib


class CudaKernel:
    """A hand-written kernel's C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str, function: str, threads: int):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.function = function      # as demangled: "point_kernel<0>"
        self.threads = threads
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    @property
    def source_path(self) -> str:
        return f"jolt_tpu_torch/csrc/{self.source}.cu"

    @property
    def mangled(self) -> str:
        """The part of the function's mangled name that ptxas and
        cuobjdump print: point_kernel<0> -> point_kernelILi0E."""
        return re.sub(r"<(\d+)>", r"ILi\1E", self.function)

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library(self.source).jt_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")
        self.launches += 1


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def words(values) -> ctypes.Array:
    """A host array of 32-bit words passed to a kernel by value."""
    vals = [int(v) for v in values]
    return (ctypes.c_uint32 * len(vals))(*vals)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's checks on the tensors it hands to CUDA."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
