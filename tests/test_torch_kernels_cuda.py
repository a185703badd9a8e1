"""Each CUDA kernel of the port against its plain version, on the card.

Card-only (marker `cuda`): without a CUDA device every test skips.  The
shapes are the edges the main path reaches and chip_smoke.py's nv = 20
shapes do not: GP rounds down to pair size 2, odd sizes, views with a
batch stride, a broadcast scalar operand.  Every comparison is of integer
limbs: the tolerance is zero.  This file imports nothing of JAX, so on a
machine without it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from jolt_tpu_torch import _native as nat
from jolt_tpu_torch.curve import kernels as ck
from jolt_tpu_torch.curve.bn254 import G1Affine
from jolt_tpu_torch.field import arith
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field import kernels as fk
from jolt_tpu_torch.field.spec import fq_spec, fr_spec

pytestmark = pytest.mark.cuda
SPECS = {"fr": fr_spec(), "fq": fq_spec()}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(spec, dev, *shape, seed=0):
    """Reduced random field elements [16, *shape]."""
    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, 1 << 16, (16,) + shape, generator=g, dtype=torch.int32)
    t[15] = torch.randint(0, int(spec.p_limbs[15]), shape, generator=g,
                          dtype=torch.int32)
    return t.to(dev)


def _launched(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.cpu().long(), w.cpu().long())


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("shape", [(1,), (257,), (3, 1000)])
def test_mont_mul(dev, name, shape):
    spec = SPECS[name]
    a, b = _rand(spec, dev, *shape, seed=1), _rand(spec, dev, *shape, seed=2)
    _equal(_launched(fk.MONT_MUL, lambda: fk.mont_mul(spec, a, b)),
           arith.mont_mul(spec, a, b))
    s = b.reshape(16, -1)[:, :1].reshape((16,) + (1,) * len(shape))
    _equal(_launched(fk.MONT_MUL, lambda: fk.mont_mul(spec, s, a)),
           arith.mont_mul(spec, s, a))


@pytest.mark.parametrize("s", [1, 2, 6, 1026])
def test_mont_mul_bl_on_views(dev, s):
    spec = fr_spec()
    pair = _rand(spec, dev, 8, 2 * s, seed=s).movedim(0, 1).contiguous()
    l, r = pair[..., :s], pair[..., s:]                  # batch stride 32 s
    _equal(_launched(fk.MONT_MUL_BL, lambda: fk.mont_mul_bl(spec, l, r)),
           fk.mont_mul_bl_plain(spec, l, r))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("s", [2, 6, 64, 1026, 1 << 17])
def test_gp_pair_round(dev, B, s):
    spec = fr_spec()
    l = _rand(spec, dev, B, s, seed=3).movedim(0, 1).contiguous()
    r = _rand(spec, dev, B, s, seed=4).movedim(0, 1).contiguous()
    eq, coeffs = _rand(spec, dev, s, seed=5), _rand(spec, dev, B, seed=6)
    _equal(_launched(fk.GP_PAIR_EVALS,
                     lambda: fk.gp_pair_evals(spec, l, r, eq, coeffs)),
           fk.gp_pair_evals_plain(spec, l, r, eq, coeffs))
    rc = fd.scalar_to_device(spec, 0x1234567 ** 9, "cpu")
    _equal(_launched(fk.GP_PAIR_BIND,
                     lambda: fk.gp_pair_bind(spec, l, r, eq, rc)),
           fk.gp_pair_bind_plain(spec, l, r, eq, rc))


def _points(dev, n):
    """n distinct Jacobian multiples of the generator, made on the host."""
    fq = fq_spec()
    g = G1Affine.generator().to_jacobian()
    pts, acc = [], g
    for _ in range(n):
        acc = acc.add(g).double()
        pts.append(acc)
    cols = [fd.ints_to_device(fq, [getattr(p, c) for p in pts], "cpu")
            for c in "xyz"]
    return tuple(t.to(dev) for t in cols)


def test_jac_add_special_cases(dev):
    n = 37
    p1 = [t.clone() for t in _points(dev, n)]
    p2 = [t.flip(-1).contiguous() for t in p1]
    for k in range(3):
        p2[k][:, 0] = p1[k][:, 0]                        # doubling
    p2[1][:, 1] = arith.sub(fq_spec(), torch.zeros_like(p1[1][:, 1]),
                            p1[1][:, 1])                 # inverse
    p2[0][:, 1], p2[2][:, 1] = p1[0][:, 1], p1[2][:, 1]
    p2[2][:, 2] = 0                                      # P2 at infinity
    p1[2][:, 3] = 0                                      # P1 at infinity
    a, b = tuple(p1), tuple(p2)
    _equal(_launched(ck.JAC_ADD, lambda: ck.jac_add(a, b)),
           ck.jac_add_plain(a, b))


def test_proj_cadd_identity_and_doubling(dev):
    n = 37
    fq = fq_spec()
    X, Y, Z = _points(dev, n)
    PX, PZ = arith.mont_mul(fq, X, Z), arith.mont_mul(
        fq, Z, arith.mont_mul(fq, Z, Z))
    p1 = [PX, Y.clone(), PZ]
    p2 = [t.flip(-1).contiguous() for t in p1]
    for k in range(3):
        p2[k][:, 0] = p1[k][:, 0]                        # doubling
    p2[0][:, 1], p2[2][:, 1] = 0, 0                      # (0:1:0)
    p2[1][:, 1] = arith.const_limbs(fq, "r", dev)
    a, b = tuple(p1), tuple(p2)
    _equal(_launched(ck.PROJ_CADD, lambda: ck.proj_cadd(a, b)),
           ck.proj_cadd_plain(a, b))


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_jac_double_with_infinity(dev, n):
    p = [t.clone() for t in _points(dev, n)]
    p[2][:, ::3] = 0                                     # Z = 0: infinity
    pt = tuple(p)
    _equal(_launched(ck.JAC_DOUBLE, lambda: ck.jac_double(pt)),
           ck.jac_double_plain(*pt))


def test_build_reports_each_library(dev):
    assert set(nat.build()) <= set(nat.SOURCES)
    assert all(nat.lib_path(s).exists() for s in nat.SOURCES)
