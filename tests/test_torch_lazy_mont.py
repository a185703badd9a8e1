"""The lazy-reduction argument of the port's CUDA field arithmetic.

csrc/field.cuh multiplies by CIOS over eight 32-bit words in the even/odd
form: the accumulator is two eight-word halves, and per word b_i carry
chains add a*b_i and then m*p (m = -p^{-1} * word 0 mod 2^32) into them,
after which the halves swap roles.  Here those chains run word by word on
Python ints, op for op as the kernels' PTX, with a check wherever a chain
drops its carry that there was none, so the bounds the kernels rely on are
pinned on the CPU:

- 4p < 2^256 for BN254's Fr and Fq (8p is not), so intermediates may
  live in [0, 2p);
- for a, b in [0, 2p) the product without its final subtraction is below
  2p and congruent to a*b*R^-1; with it, the unique reduced value;
- one conditional subtraction of 2p keeps sums and differences of values
  below 2p below 2p;
- K5's and K2's lazy evaluation orders (csrc/point.cu `cadd_core`,
  csrc/gp_pair.cu `gp_pair_evals_kernel`) on this model give the limbs
  of their plain versions, with the identity, P + P, P + (-P) and the
  residues 0, 1, p - 1 and R mod p among the inputs.
"""
import itertools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jolt_tpu_torch.curve import kernels as ck
from jolt_tpu_torch.curve.bn254 import G1Affine
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field import kernels as fk
from jolt_tpu_torch.field.spec import fq_spec, fr_spec

SPECS = {"fr": fr_spec(), "fq": fq_spec()}
M32 = (1 << 32) - 1
R = 1 << 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(x):
    return [(x >> (32 * k)) & M32 for k in range(8)]


class _Chain:
    """One PTX carry chain of field.cuh: the carry flag and its ops."""

    def __init__(self):
        self.cf = 0

    def op(self, x, c, cin=True, cout=True):
        v = x + c + (self.cf if cin else 0)
        if cout:
            self.cf = v >> 32
        else:
            assert v >> 32 == 0              # nothing may carry out here
        return v & M32


def _lo(a, b):
    return (a * b) & M32


def _hi(a, b):
    return (a * b) >> 32


def _eo_row(ev, od, a, bi):
    """field.cuh `eo_row`: od down two words, od[1] into ev[0], T += a bi."""
    ch = _Chain()
    ev[0] = ch.op(ev[0], od[1], cin=False)                   # add.cc
    for j in range(0, 6, 2):
        od[j] = ch.op(_lo(a[j + 1], bi), od[j + 2])
        od[j + 1] = ch.op(_hi(a[j + 1], bi), od[j + 3])
    od[6] = ch.op(_lo(a[7], bi), 0)
    od[7] = ch.op(_hi(a[7], bi), 0, cout=False)              # madc.hi.u32
    ch = _Chain()
    for j in range(0, 8, 2):
        ev[j] = ch.op(_lo(a[j], bi), ev[j], cin=j > 0)
        ev[j + 1] = ch.op(_hi(a[j], bi), ev[j + 1])
    od[7] = ch.op(od[7], 0, cout=False)                      # addc.u32


def _eo_redc(ev, od, pw, inv):
    """field.cuh `eo_redc`: T += m p with m = ev[0] * inv."""
    m = (ev[0] * inv) & M32
    ch = _Chain()
    for j in range(0, 8, 2):
        od[j] = ch.op(_lo(pw[j + 1], m), od[j], cin=j > 0)
        od[j + 1] = ch.op(_hi(pw[j + 1], m), od[j + 1])
    assert ch.cf == 0                        # the chain's carry is dropped
    ch = _Chain()
    for j in range(0, 8, 2):
        ev[j] = ch.op(_lo(pw[j], m), ev[j], cin=j > 0)
        ev[j + 1] = ch.op(_hi(pw[j], m), ev[j + 1])
    od[7] = ch.op(od[7], 0, cout=False)
    assert ev[0] == 0


def cios(spec, a, b, reduce=False):
    """field.cuh `mont_mul<reduce>`, word by word, chain by chain."""
    aw, bw, pw = _words(a), _words(b), _words(spec.p)
    ev, od = [0] * 8, [0] * 8
    for j in range(0, 8, 2):                                  # eo_first
        ev[j], ev[j + 1] = _lo(aw[j], bw[0]), _hi(aw[j], bw[0])
        od[j], od[j + 1] = _lo(aw[j + 1], bw[0]), _hi(aw[j + 1], bw[0])
    for i in range(0, 8, 2):
        if i:
            _eo_row(ev, od, aw, bw[i])
        _eo_redc(ev, od, pw, spec.inv32)
        _eo_row(od, ev, aw, bw[i + 1])                       # roles swap
        _eo_redc(od, ev, pw, spec.inv32)
    ch = _Chain()
    for j in range(7):
        ev[j] = ch.op(ev[j], od[j + 1], cin=j > 0)
    ev[7] = ch.op(ev[7], 0, cout=False)
    r = sum(w << (32 * k) for k, w in enumerate(ev))
    return r - spec.p if reduce and r >= spec.p else r


def csub(x, m):
    assert 0 <= x < R
    return x - m if x >= m else x


def ladd(spec, x, y):
    assert x < 2 * spec.p and y < 2 * spec.p
    return csub(x + y, 2 * spec.p)


def lsub(spec, x, y):
    assert x < 2 * spec.p and y < 2 * spec.p
    d = (x - y) % R                          # sub.cc chain, then + 2p
    return (d + 2 * spec.p) % R if x < y else d


def _edges(spec):
    p = spec.p
    return [0, 1, p - 1, p, p + 1, 2 * p - 2, 2 * p - 1, spec.r, spec.r2,
            p + spec.r]


def _check_product(spec, a, b):
    want = a * b * spec.r_inv % spec.p
    lazy = cios(spec, a, b)
    assert lazy < 2 * spec.p and lazy % spec.p == want
    assert cios(spec, a, b, reduce=True) == want


@pytest.mark.parametrize("name", SPECS)
def test_headroom(name):
    p = SPECS[name].p
    assert 4 * p < R <= 8 * p
    assert 3 * p * (1 << 32) < 1 << 288      # a CIOS row fits nine words


@pytest.mark.parametrize("name", SPECS)
def test_cios_lazy_edges(name):
    spec = SPECS[name]
    for a, b in itertools.product(_edges(spec), repeat=2):
        _check_product(spec, a, b)


@pytest.mark.parametrize("name", SPECS)
@settings(max_examples=150, deadline=None, database=None)
@given(data=st.data())
def test_cios_lazy_random(name, data):
    spec = SPECS[name]
    a = data.draw(st.integers(0, 2 * spec.p - 1))
    b = data.draw(st.integers(0, 2 * spec.p - 1))
    _check_product(spec, a, b)


@pytest.mark.parametrize("name", SPECS)
def test_lazy_add_sub_stay_below_2p(name):
    spec = SPECS[name]
    for x, y in itertools.product(_edges(spec), repeat=2):
        s, d = ladd(spec, x, y), lsub(spec, x, y)
        assert s < 2 * spec.p and s % spec.p == (x + y) % spec.p
        assert d < 2 * spec.p and d % spec.p == (x - y) % spec.p
    assert csub(spec.p - 1, spec.p) == spec.p - 1 and csub(spec.p, spec.p) == 0


def _limbs(vals):
    return torch.from_numpy(fd.pack_ints(vals).astype(np.int32))


def _ints(t):
    return [int(v) for v in fd.unpack_ints(t.numpy())]


def cadd_lazy(P1, P2):
    """csrc/point.cu `cadd_core` on the model (RCB16 Alg. 7, a = 0)."""
    F = SPECS["fq"]
    mul = lambda x, y: cios(F, x, y)         # noqa: E731
    add = lambda x, y: ladd(F, x, y)         # noqa: E731
    sub = lambda x, y: lsub(F, x, y)         # noqa: E731

    def times9(t):                           # three doublings and an add
        t8 = add(t, t)
        t8 = add(t8, t8)
        return add(add(t8, t8), t)

    (X1, Y1, Z1), (X2, Y2, Z2) = P1, P2
    t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
    t3 = sub(mul(X1 + Y1, X2 + Y2), add(t0, t1))
    t4 = sub(mul(Y1 + Z1, Y2 + Z2), add(t1, t2))
    X3 = mul(X1 + Z1, X2 + Z2)
    Y3 = sub(X3, add(t0, t2))
    t0 = add(add(t0, t0), t0)
    t2 = times9(t2)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    Y3 = times9(Y3)
    return (csub(sub(mul(t3, t1), mul(t4, Y3)), F.p),
            csub(add(mul(Y3, t0), mul(t1, Z3)), F.p),
            csub(add(mul(Z3, t4), mul(t0, t3)), F.p))


def test_k5_lazy_order_equals_plain():
    F = SPECS["fq"]
    g = G1Affine.generator().to_jacobian()
    pts = [g.mul(k).to_affine() for k in (1, 2, 3, 5, 7)]
    mont = lambda x: F.to_mont(x)            # noqa: E731
    proj = [(mont(q.x), mont(q.y), F.r) for q in pts]
    neg = [(mont(q.x), mont(-q.y % F.p), F.r) for q in pts]
    ident = (0, F.r, 0)
    edge = (F.p - 1, F.r, 1)                 # not a point: limb edges
    pairs = ([(a, b) for a in proj for b in proj]       # includes P + P
             + [(a, b) for a, b in zip(proj, neg)]      # P + (-P)
             + [(ident, a) for a in proj] + [(proj[0], ident)]
             + [(ident, ident), (edge, edge), (edge, proj[1])])
    p1 = tuple(_limbs([a[k] for a, _ in pairs]) for k in range(3))
    p2 = tuple(_limbs([b[k] for _, b in pairs]) for k in range(3))
    want = [_ints(t) for t in ck.proj_cadd_plain(p1, p2)]
    got = [cadd_lazy(a, b) for a, b in pairs]
    assert [list(c) for c in zip(*got)] == want


def test_k2_lazy_order_equals_plain():
    F = SPECS["fr"]
    rng = np.random.default_rng(7)
    B, s = 3, 8
    h = s // 2
    pool = [0, 1, F.p - 1, F.r, F.p - F.r]
    draw = lambda: (pool[rng.integers(len(pool))] if rng.random() < 0.4  # noqa: E731
                    else int(rng.integers(0, 1 << 62)) * (F.p >> 60) % F.p)
    l = [[draw() for _ in range(s)] for _ in range(B)]
    r = [[draw() for _ in range(s)] for _ in range(B)]
    eq = [draw() for _ in range(s)]
    c = [draw() for _ in range(B)]
    mul = lambda x, y: cios(F, x, y)         # noqa: E731
    add = lambda x, y: ladd(F, x, y)         # noqa: E731
    sub = lambda x, y: lsub(F, x, y)         # noqa: E731
    e = [0, 0, 0]
    for i in range(h):                       # gp_pair_evals_kernel's order
        s0 = s2 = s3 = 0
        for b in range(B):
            cl0 = mul(c[b], l[b][i])
            s0 = add(s0, mul(cl0, r[b][i]))
            cl1 = mul(c[b], l[b][i + h])
            m_l, m_r = sub(cl1, cl0), sub(r[b][i + h], r[b][i])
            le2, re2 = add(cl1, m_l), add(r[b][i + h], m_r)
            s2 = add(s2, mul(le2, re2))
            s3 = add(s3, mul(add(le2, m_l), add(re2, m_r)))
        m_eq = sub(eq[i + h], eq[i])
        eq2 = add(eq[i + h], m_eq)
        for t, (w, x) in enumerate(((eq[i], s0), (eq2, s2),
                                    (add(eq2, m_eq), s3))):
            e[t] = add(e[t], mul(w, x))
    got = [csub(v, F.p) for v in e]
    lt = torch.stack([_limbs(row) for row in l])           # [B, 16, s]
    rt = torch.stack([_limbs(row) for row in r])
    want = fk.gp_pair_evals_plain(F, lt, rt, _limbs(eq), _limbs(c))
    assert _ints(want) == got
