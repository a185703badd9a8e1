"""Where the port keeps what it builds and what it reads back: the
counterpart of jolt_tpu/utils/caches.py.

- `srs_cache_dir()`: the committed SRS fixtures, `fixtures/srs/`
  (`srs_<n>_<seed>.npz`), which `commitment/kzg.py`'s `srs_setup` reads.
  The port only reads them; it never writes into `fixtures/`.
- `build_dir()`: the kernel build directory, `jolt_tpu_torch/_build/`
  (gitignored), where `_native.py` puts the CUDA libraries nvcc builds and
  `native/` the g++ ones.  It is the counterpart of jolt_tpu's
  `jit_cache_dir`, the XLA compile cache: the port compiles its kernels
  ahead of time, once per source, and caches the libraries there.

Env overrides, as in jolt_tpu: JOLT_TPU_SRS_CACHE_DIR (the SRS fixtures)
and JOLT_TPU_CACHE_DIR (the build directory).  Neither function creates
its directory: the code that writes there does.
"""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def repo_root() -> str:
    return _REPO_ROOT


def build_dir() -> str:
    """The kernel libraries' directory (JOLT_TPU_CACHE_DIR overrides)."""
    return os.environ.get("JOLT_TPU_CACHE_DIR",
                          os.path.join(_REPO_ROOT, "jolt_tpu_torch", "_build"))


def srs_cache_dir() -> str:
    """The SRS fixtures' directory (JOLT_TPU_SRS_CACHE_DIR overrides)."""
    return os.environ.get("JOLT_TPU_SRS_CACHE_DIR",
                          os.path.join(_REPO_ROOT, "fixtures", "srs"))
