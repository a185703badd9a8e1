"""Each CUDA kernel of the port against its plain version, on the card.

Card-only (marker `cuda`): without a CUDA device every test skips.  The
shapes are the edges the main path reaches and chip_smoke.py's nv = 20
shapes do not: GP rounds down to pair size 2 at every batch size the
provers use, odd sizes, views with a batch stride, a broadcast scalar
operand; K2 and K5 on edge residues (0, 1, p - 1, R mod p, ...), where the
kernels' lazy reduction crosses p and 2p, and on P + (-P); K2 called again
and again, which checks that its last-block counter is reset.  Every
comparison is of integer
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


@pytest.mark.parametrize("B", [1, 7, 8, 43, 64])
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


def _edge(spec, dev, *shape, seed=0):
    """Reduced field elements [16, *shape], most of them from a pool of
    edges (0, 1, p - 1, p - 2, (p +- 1)/2, R mod p, p - R mod p, 2^255 mod
    p), so that lazy sums and differences cross p and 2p."""
    p = spec.p
    pool = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, spec.r,
            p - spec.r, (1 << 255) % p]
    pool_t = torch.from_numpy(fd.pack_ints(pool).astype("int32"))
    t = _rand(spec, "cpu", *shape, seed=seed).reshape(16, -1)
    g = torch.Generator().manual_seed(seed + 1)
    pick = torch.randint(0, len(pool), (t.shape[1],), generator=g)
    use = torch.rand(t.shape[1], generator=g) < 0.75
    t[:, use] = pool_t[:, pick[use]]
    return t.reshape((16,) + shape).to(dev)


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


def test_proj_cadd_opposite_points(dev):
    fq = fq_spec()
    X, Y, Z = _points(dev, 37)
    PX, PZ = arith.mont_mul(fq, X, Z), arith.mont_mul(
        fq, Z, arith.mont_mul(fq, Z, Z))
    a = (PX, Y, PZ)
    b = (PX, arith.sub(fq, torch.zeros_like(Y), Y), PZ)  # P + (-P)
    _equal(_launched(ck.PROJ_CADD, lambda: ck.proj_cadd(a, b)),
           ck.proj_cadd_plain(a, b))


@pytest.mark.parametrize("shape", [(1,), (4099,), (64, 33)])
def test_proj_cadd_edge_residues(dev, shape):
    fq = fq_spec()
    a = tuple(_edge(fq, dev, *shape, seed=10 + k) for k in range(3))
    b = tuple(_edge(fq, dev, *shape, seed=20 + k) for k in range(3))
    _equal(_launched(ck.PROJ_CADD, lambda: ck.proj_cadd(a, b)),
           ck.proj_cadd_plain(a, b))


@pytest.mark.parametrize("B", [1, 8, 43])
@pytest.mark.parametrize("s", [2, 64, 1 << 12])
def test_gp_pair_evals_edge_residues(dev, B, s):
    spec = fr_spec()
    l = _edge(spec, dev, B, s, seed=3).movedim(0, 1).contiguous()
    r = _edge(spec, dev, B, s, seed=4).movedim(0, 1).contiguous()
    eq, coeffs = _edge(spec, dev, s, seed=5), _edge(spec, dev, B, seed=6)
    _equal(_launched(fk.GP_PAIR_EVALS,
                     lambda: fk.gp_pair_evals(spec, l, r, eq, coeffs)),
           fk.gp_pair_evals_plain(spec, l, r, eq, coeffs))


def test_gp_pair_evals_repeated_calls_reset_the_ticket(dev):
    """The last block of each launch resets its stream's counter, so
    back-to-back launches of several plans give the same sums."""
    spec = fr_spec()
    outs = {}
    for B, s in ((43, 1 << 15), (8, 64), (43, 1 << 15), (1, 2), (8, 64)):
        l = _rand(spec, dev, B, s, seed=B).movedim(0, 1).contiguous()
        r = _rand(spec, dev, B, s, seed=B + 1).movedim(0, 1).contiguous()
        eq, c = _rand(spec, dev, s, seed=B + 2), _rand(spec, dev, B, seed=B + 3)
        got = [fk.gp_pair_evals(spec, l, r, eq, c) for _ in range(3)]
        torch.cuda.synchronize()
        want = outs.setdefault((B, s), fk.gp_pair_evals_plain(spec, l, r, eq, c))
        for g in got:
            _equal(g, want)
    assert int(fk._gp_counter(dev).item()) == 0


def test_gp_pair_evals_on_two_streams(dev):
    """Launches on two streams at once each take their own stream's
    last-block counter, and both give the plain version's sums."""
    spec = fr_spec()
    B, s = 43, 1 << 15
    args = []
    for k in range(2):
        l = _rand(spec, dev, B, s, seed=10 + k).movedim(0, 1).contiguous()
        r = _rand(spec, dev, B, s, seed=20 + k).movedim(0, 1).contiguous()
        args.append((l, r, _rand(spec, dev, s, seed=30 + k),
                     _rand(spec, dev, B, seed=40 + k)))
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(4):
        for k in range(2):
            with torch.cuda.stream(streams[k]):
                got[k].append(fk.gp_pair_evals(spec, *args[k]))
    torch.cuda.synchronize()
    for k in range(2):
        want = fk.gp_pair_evals_plain(spec, *args[k])
        for g in got[k]:
            _equal(g, want)
        with torch.cuda.stream(streams[k]):
            assert int(fk._gp_counter(dev).item()) == 0


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
