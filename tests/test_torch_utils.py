"""The port's copies of jolt_tpu's small host modules: utils/caches.py
and field/binius.py.

- caches: the SRS fixtures live in fixtures/srs/ and the kernel libraries
  in jolt_tpu_torch/_build/ unless JOLT_TPU_SRS_CACHE_DIR or
  JOLT_TPU_CACHE_DIR says otherwise, and commitment/kzg.py reads its SRS
  fixtures from `srs_cache_dir()`.
- binius: GF(2^128) sums, products and squares of seeded elements
  (numpy.random.default_rng) equal jolt_tpu's; `inverse` and `BiniusPCS`
  raise NotImplementedError, as in the reference.
"""
from pathlib import Path

import numpy as np
import pytest

from jolt_tpu.field import binius as jbinius
from jolt_tpu_torch.commitment import kzg
from jolt_tpu_torch.field import binius
from jolt_tpu_torch.utils import caches

ROOT = Path(__file__).resolve().parents[1]


def test_cache_defaults(monkeypatch):
    monkeypatch.delenv("JOLT_TPU_SRS_CACHE_DIR", raising=False)
    monkeypatch.delenv("JOLT_TPU_CACHE_DIR", raising=False)
    assert Path(caches.repo_root()) == ROOT
    assert Path(caches.srs_cache_dir()) == ROOT / "fixtures" / "srs"
    assert Path(caches.build_dir()) == ROOT / "jolt_tpu_torch" / "_build"
    assert kzg.fixture_path(1 << 16).name == "srs_65536_6a6f6c74.npz"


def test_cache_env_overrides(monkeypatch, tmp_path):
    monkeypatch.setenv("JOLT_TPU_SRS_CACHE_DIR", str(tmp_path / "srs"))
    monkeypatch.setenv("JOLT_TPU_CACHE_DIR", str(tmp_path / "build"))
    assert caches.srs_cache_dir() == str(tmp_path / "srs")
    assert caches.build_dir() == str(tmp_path / "build")
    assert kzg.fixture_path(16) is None           # no such directory
    (tmp_path / "srs").mkdir()
    np.savez(tmp_path / "srs" / "srs_32_6a6f6c74.npz", X=np.zeros(1))
    assert kzg.fixture_path(16) == tmp_path / "srs" / "srs_32_6a6f6c74.npz"
    assert not (tmp_path / "build").exists()      # nothing made on a query


def _elements(rng, n: int) -> list[int]:
    hi = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    lo = rng.integers(0, 1 << 64, size=n, dtype=np.uint64)
    return [(int(h) << 64) | int(l) for h, l in zip(hi, lo)]


def test_binius_arithmetic_equals_jolt_tpus():
    rng = np.random.default_rng(3)
    xs, ys = _elements(rng, 64), _elements(rng, 64)
    xs += [0, 1, (1 << 128) - 1]
    ys += [(1 << 128) - 1, 0x87, (1 << 127)]
    for x, y in zip(xs, ys):
        a, b = binius.BiniusElt(x), binius.BiniusElt(y)
        ja, jb = jbinius.BiniusElt(x), jbinius.BiniusElt(y)
        assert (a * b).v == (ja * jb).v < 1 << 128
        assert (a + b).v == (ja + jb).v == (a - b).v
        assert a.square().v == ja.square().v
    assert binius.BiniusElt.from_u64(-1).v == \
        jbinius.BiniusElt.from_u64(-1).v == (1 << 64) - 1
    one, zero = binius.BiniusElt.one(), binius.BiniusElt.zero()
    assert (binius.BiniusElt(xs[0]) * one).v == xs[0]
    assert (binius.BiniusElt(xs[0]) * zero).v == 0


def test_binius_stubs_raise_as_in_the_reference():
    with pytest.raises(NotImplementedError):
        binius.BiniusElt(5).inverse()
    with pytest.raises(NotImplementedError):
        binius.BiniusPCS()
