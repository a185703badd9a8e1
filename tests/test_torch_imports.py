"""The port stands alone: no JAX, no jolt_tpu, and no slide to the CPU.

- importing jolt_tpu_torch (every module of it) loads neither jax nor any
  jolt_tpu module;
- no source of the port, and not chip_smoke.py, imports them;
- an entry point called with no CUDA card and no device="cpu" raises;
- a kernel wrapper handed tensors that are not on the CPU launches its
  kernel or raises: it never runs its plain version instead.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu_torch import cli
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
from jolt_tpu_torch.curve import kernels as ck
from jolt_tpu_torch.field import kernels as fk
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.instructions import XorInstruction
from jolt_tpu_torch.lasso import SurgePreprocessing

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "jolt_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import jolt_tpu_torch, jolt_tpu_torch.cli
for m in pkgutil.walk_packages(jolt_tpu_torch.__path__, "jolt_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jolt_tpu"))
print(len([m for m in sys.modules if m.startswith("jolt_tpu_torch")]))
sys.exit("loaded: " + ", ".join(bad) if bad else 0)
"""


def test_import_loads_no_jax_and_no_jolt_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20        # the whole package loaded


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|jolt_tpu)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|jolt_tpu)\b(?!_torch))", re.M)


def test_sources_import_no_jax_and_no_jolt_tpu():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import jolt_tpu.cli",
                 "from jolt_tpu.field import fr_spec", "  import jolt_tpu"):
        assert _FORBIDDEN.search(line), line
    for line in ("import jolt_tpu_torch", "from jolt_tpu_torch.field import x",
                 "# the jax package", "x = 'from jax'"):
        assert not _FORBIDDEN.search(line), line


_ENTRY_POINTS = {
    "SurgePreprocessing": lambda: SurgePreprocessing(XorInstruction, 2, 16),
    "HyperKZG.setup": lambda: HyperKZG.setup(16),
    "cli.surge_setup": lambda: cli.surge_setup(4),
    "cli.main": lambda: cli.main(["surge-bench", "--nv", "4",
                                  "--prover-runs", "1", "--verifier-runs", "1"]),
}


@pytest.mark.parametrize("name", _ENTRY_POINTS)
def test_entry_points_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _ENTRY_POINTS[name]()


def test_entry_point_runs_on_cpu_when_asked():
    pre = SurgePreprocessing(XorInstruction, 2, 16, device="cpu")
    assert pre.subtable_dev.device.type == "cpu"


def _meta(*shape):
    return torch.zeros(shape, dtype=torch.int32, device="meta")


_WRAPPERS = {
    "mont_mul": lambda: fk.mont_mul(fr_spec(), _meta(16, 8), _meta(16, 8)),
    "mont_mul_bl": lambda: fk.mont_mul_bl(fr_spec(), _meta(2, 16, 8),
                                          _meta(2, 16, 8)),
    "gp_pair_evals": lambda: fk.gp_pair_evals(
        fr_spec(), _meta(2, 16, 8), _meta(2, 16, 8), _meta(16, 8),
        _meta(16, 2)),
    "gp_pair_bind": lambda: fk.gp_pair_bind(
        fr_spec(), _meta(2, 16, 8), _meta(2, 16, 8), _meta(16, 8),
        torch.zeros(16, dtype=torch.int32)),
    "proj_cadd": lambda: ck.proj_cadd((_meta(16, 4),) * 3, (_meta(16, 4),) * 3),
    "jac_add": lambda: ck.jac_add((_meta(16, 4),) * 3, (_meta(16, 4),) * 3),
}


@pytest.mark.parametrize("name", _WRAPPERS)
def test_kernel_wrappers_never_fall_back(name):
    """Tensors off the CPU go to the kernel's device checks, which refuse
    anything but CUDA; nothing is computed by the plain version."""
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        _WRAPPERS[name]()


def test_cli_inputs_follow_the_jax_cli():
    """surge-bench draws x, y from default_rng(0) as jolt_tpu's CLI does."""
    x, y = cli.surge_inputs(np.random.default_rng(0), 3)
    rng = np.random.default_rng(0)
    assert (x == rng.integers(0, 1 << 32, size=8, dtype=np.uint64)).all()
    assert (y == rng.integers(0, 1 << 32, size=8, dtype=np.uint64)).all()
