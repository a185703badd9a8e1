"""The port stands alone: no JAX, no jolt_tpu, no pyelftools, and no slide
to the CPU.

- importing jolt_tpu_torch (every module of it: the SDK, the native
  runtime, the ELF reader, the serializers, the profiling spans, the
  tracer's machine model and the multi-device prover among them) loads
  neither
  jax nor any jolt_tpu module nor elftools;
- no source of the port, and not chip_smoke.py, imports them;
- an entry point called with no CUDA card and no device="cpu" raises;
- a kernel wrapper handed tensors that are not on the CPU (K1-K7, the
  device Fiat-Shamir's K8 and K9, the field programs K10 and K11, also
  through fd.fadd, fsub, fneg and fsum, and the primary round's kernel,
  also with some operands on the CPU) launches its
  kernel or raises: it never runs its plain version instead, and neither
  do the windowed MSM, Hyrax, Zeromorph, the grand-product commit or the
  Quarks product tree.
"""
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jolt_tpu_torch import cli, sdk
from jolt_tpu_torch.commitment.base import BatchType
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
from jolt_tpu_torch.commitment.hyrax import HyraxScheme, PedersenGenerators
from jolt_tpu_torch.commitment.kzg import KZGProverKey, verifier_key
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.commitment.zeromorph import Zeromorph
from jolt_tpu_torch.curve import device as cd
from jolt_tpu_torch.curve import kernels as ck
from jolt_tpu_torch.curve.bn254 import G1Affine
from jolt_tpu_torch.evm import fixtures as evm_fixtures
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field import kernels as fk
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.instructions import (AddInstruction, BneInstruction,
                                         XorInstruction)
from jolt_tpu_torch.lasso import SurgePreprocessing
from jolt_tpu_torch.parallel import sharding
from jolt_tpu_torch.subprotocols import fs_device as fsd
from jolt_tpu_torch.subprotocols.grand_product_quarks import QuarkGrandProduct
from jolt_tpu_torch.utils import keccak_device as kd
from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES
from jolt_tpu_torch.vm import instruction_lookups as il

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "jolt_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import jolt_tpu_torch, jolt_tpu_torch.cli
for m in pkgutil.walk_packages(jolt_tpu_torch.__path__, "jolt_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "jolt_tpu", "elftools"))
need = {"jolt_tpu_torch.sdk", "jolt_tpu_torch.native",
        "jolt_tpu_torch.tracer.elf", "jolt_tpu_torch.tracer.elf_write",
        "jolt_tpu_torch.vm.analyze", "jolt_tpu_torch.utils.serialization",
        "jolt_tpu_torch.utils.ark_proof", "jolt_tpu_torch.utils.ark_serialize",
        "jolt_tpu_torch.commitment.zeromorph",
        "jolt_tpu_torch.commitment.hyrax",
        "jolt_tpu_torch.commitment.fixtures", "jolt_tpu_torch.convert",
        "jolt_tpu_torch.subprotocols.grand_product_quarks",
        "jolt_tpu_torch.subprotocols.fixtures", "jolt_tpu_torch.evm.fixtures",
        "jolt_tpu_torch.evm.gen_r1cs_sol", "jolt_tpu_torch.evm.solidity_vm",
        "jolt_tpu_torch.utils.profiling", "jolt_tpu_torch.utils.caches",
        "jolt_tpu_torch.tracer.bus", "jolt_tpu_torch.tracer.peripherals",
        "jolt_tpu_torch.field.binius", "jolt_tpu_torch.utils.keccak_device",
        "jolt_tpu_torch.subprotocols.fs_device",
        "jolt_tpu_torch.parallel", "jolt_tpu_torch.parallel.sharding"}
bad += sorted(f"not imported: {m}" for m in need - set(sys.modules))
print(len([m for m in sys.modules if m.startswith("jolt_tpu_torch")]))
sys.exit("loaded: " + ", ".join(bad) if bad else 0)
"""


def test_import_loads_no_jax_and_no_jolt_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 20        # the whole package loaded


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|jolt_tpu|elftools)\b(?!_torch)"
    r"|from\s+(jax|jaxlib|jolt_tpu|elftools)\b(?!_torch))", re.M)


def test_sources_import_no_jax_and_no_jolt_tpu():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "from jax import numpy", "import jolt_tpu.cli",
                 "from jolt_tpu.field import fr_spec", "  import jolt_tpu",
                 "from elftools.elf.elffile import ELFFile"):
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
    "JoltVM.preprocess": lambda: cli.fib_vm().preprocess(
        [], MockCommitmentScheme()),
    "cli.prove_fib": lambda: cli.prove_fib(1),
    "cli.main prove-fib": lambda: cli.main(["prove-fib", "--n", "1"]),
    "cli.main prove-fib --profile": lambda: cli.main(
        ["prove-fib", "--n", "1", "--profile"]),
    "cli.prove_sha2_chain": lambda: cli.prove_sha2_chain(1),
    "cli.main prove-sha2-chain": lambda: cli.main(["prove-sha2-chain"]),
    "cli.prove_guest": lambda: cli.prove_guest("collatz", 3),
    "cli.main prove-guest": lambda: cli.main(["prove-guest", "--guest",
                                              "collatz", "--n", "3"]),
    "sdk.build_provable": lambda: sdk.build_provable(
        cli.GUESTS["collatz"][0](3), pcs="mock"),
    "Zeromorph.setup": lambda: Zeromorph.setup(16),
    "HyraxScheme.setup": lambda: HyraxScheme.setup(16),
    "cli.pcs_bench": lambda: cli.pcs_bench("hyrax", 4),
    "cli.main pcs-bench": lambda: cli.main(["pcs-bench", "--logn", "4"]),
    "evm grand_product_fixture": lambda: evm_fixtures.grand_product_fixture(),
    "evm hyperkzg_fixture": lambda: evm_fixtures.hyperkzg_fixture(),
    "evm spartan_fixture": lambda: evm_fixtures.spartan_fixture(),
    "evm write_fixtures": lambda: evm_fixtures.write_fixtures("unused"),
    "sharding make_mesh": lambda: sharding.make_mesh(2),
    "sharding make_mesh virtual": lambda: sharding.make_mesh(2,
                                                             device="cuda"),
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


# what the primary round reads of the fib VM's lookup preprocessing (ADD,
# BNE; C = 4, M = 2^8; 6 memories)
_FIB_LOOKUPS = SimpleNamespace(
    instruction_classes=[AddInstruction, BneInstruction],
    instruction_to_memory_indices=il.memory_layout(
        [AddInstruction, BneInstruction], RV32I_SUBTABLES, 4, 1 << 8)[3],
    C=4, M=1 << 8, spec=fr_spec(), sumcheck_degree=3)

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
    "jac_double": lambda: ck.jac_double((_meta(16, 4),) * 3),
    "transcript_events": lambda: kd.transcript_events(
        fr_spec(), torch.zeros(9, dtype=torch.int64, device="meta"),
        _meta(16, 4), [(kd.APPEND, 4), (kd.CHALLENGE, 1)]),
    "fs_round": lambda: fsd.fs_round(
        fr_spec(), _meta(16, 3), _meta(16),
        torch.zeros(9, dtype=torch.int64, device="meta"), 3, True),
    "field_addsub": lambda: fk.field_addsub(fr_spec(), _meta(16, 8),
                                            _meta(16, 1), fk.SUB),
    "fd.fadd": lambda: fd.fadd(fr_spec(), _meta(16, 8), _meta(16, 8)),
    "fd.fneg": lambda: fd.fneg(fr_spec(), _meta(16, 8)),
    "field_sum": lambda: fk.field_sum(fr_spec(), _meta(16, 4, 8), 0),
    "fd.fsum": lambda: fd.fsum(fr_spec(), _meta(16, 8), -1),
    "primary_round": lambda: il.primary_round(
        _FIB_LOOKUPS, _meta(16, 8), _meta(16, 8), _meta(16, 2, 8),
        _meta(16, 6, 8)),
    "primary_round, flags on the CPU": lambda: il.primary_round(
        _FIB_LOOKUPS, _meta(16, 8), _meta(16, 8),
        torch.zeros((16, 2, 8), dtype=torch.int32), _meta(16, 6, 8)),
    "primary_round, all but eq on the CPU": lambda: il.primary_round(
        _FIB_LOOKUPS, _meta(16, 8), *(torch.zeros(s, dtype=torch.int32)
                                      for s in ((16, 8), (16, 2, 8),
                                                (16, 6, 8)))),
}


@pytest.mark.parametrize("name", _WRAPPERS)
def test_kernel_wrappers_never_fall_back(name):
    """Tensors off the CPU go to the kernel's device checks, which refuse
    anything but CUDA; nothing is computed by the plain version."""
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        _WRAPPERS[name]()


def _meta_points(n):
    return (_meta(16, n), _meta(16, n), _meta(16, n))


_MSM_PATHS = {
    "msm": lambda: cd.msm(_meta_points(4), _meta(16, 1, 4)),
    "HyraxScheme.commit": lambda: HyraxScheme(PedersenGenerators(
        [G1Affine.generator()] * 4, _meta_points(4))).commit(_meta(16, 16)),
    "Zeromorph.commit": lambda: Zeromorph(
        KZGProverKey(_meta_points(17), 17), verifier_key(),
        verifier_key().beta_g2).commit(_meta(16, 16)),
    "KZGProverKey.g_products": lambda: KZGProverKey(
        _meta_points(16), 16).g_products(),
    "HyperKZG GRAND_PRODUCT commit": lambda: HyperKZG(
        KZGProverKey(_meta_points(16), 16), verifier_key()).batch_commit(
        [_meta(16, 16)], BatchType.GRAND_PRODUCT),
    "QuarkGrandProduct.construct": lambda: QuarkGrandProduct.construct(
        _meta(16, 2, 64)),
}


@pytest.mark.parametrize("name", _MSM_PATHS)
def test_msm_paths_never_fall_back(name):
    """The windowed MSM, Hyrax, Zeromorph, the grand-product commit and the
    Quarks product tree hand tensors that are not on the CPU to the
    kernels' checks (K1 first, then K5/K6/K7)."""
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        _MSM_PATHS[name]()


def test_cli_inputs_follow_the_jax_cli():
    """surge-bench draws x, y from default_rng(0) as jolt_tpu's CLI does."""
    x, y = cli.surge_inputs(np.random.default_rng(0), 3)
    rng = np.random.default_rng(0)
    assert (x == rng.integers(0, 1 << 32, size=8, dtype=np.uint64)).all()
    assert (y == rng.integers(0, 1 << 32, size=8, dtype=np.uint64)).all()
