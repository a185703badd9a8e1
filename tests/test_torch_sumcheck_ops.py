"""K14-K17's plain versions (field/kernels.py: the toggled grand
product's round, the opening reduction's round and its RLC) against
jolt_tpu's functions on the CPU.

The same numpy-seeded inputs go through jolt_tpu's `_toggle_cubic_evals`,
`_toggle_bind`, `_quadratic_evals` (weighted on the host as
`_reduction_round_fs` weighs them), `bind_top` and `rlc_polys`, and
through the port's wrappers, which on CPU tensors run the plain versions;
the limbs must be equal (tolerance 0: field residues).  Each jitted
jolt_tpu function compiles once, at one shape (m = 3, s = 8 for the
toggle round; three polynomials of 16 for the RLC): random and edge
residues (0, 1, p - 1, R mod p, ...) go through that one shape, and the
other shapes (m = 2; s = 2, the last round; first-round 0/1 flags) are
held against a host oracle of the same formula on Python ints.  The
wrappers' checks (pairs of one length, polynomials no longer than the
output) and the splits past each launch's cap (memories, polynomials)
are checked on the plain versions; the CUDA launches themselves are in
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.field import FElt as JFElt
from jolt_tpu.field import device as jfd
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.poly import mle as jmle
from jolt_tpu.poly import opening_proof as jop
from jolt_tpu.subprotocols import grand_product as jgp
from jolt_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from jolt_tpu_torch.field import arith
from jolt_tpu_torch.field import device as tfd
from jolt_tpu_torch.field import kernels as fk
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.poly import opening_proof as top
from jolt_tpu_torch.subprotocols import grand_product as tgp

JFR, FR = jfr_spec(), fr_spec()
P = FR.p
RINV = pow(FR.r, -1, P)
EDGES = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (P + 1) // 2, FR.r, P - FR.r,
         (1 << 255) % P]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _limbs(rng, shape, edge=False):
    """Montgomery Fr limbs uint32[16, *shape]: random residues (any residue
    below p is a Montgomery form), three in four drawn from EDGES with
    `edge`."""
    n = int(np.prod(shape))
    vals = [int(x) % P for x in rng.integers(0, 1 << 63, size=n)]
    vals = [(v * int(rng.integers(1, 1 << 62))) % P for v in vals]
    if edge:
        vals = [EDGES[int(rng.integers(len(EDGES)))] if rng.random() < 0.75
                else v for v in vals]
    return jfd.pack_ints(vals, shape).astype(np.uint32)


def _flags01(rng, shape):
    """Montgomery 0/1 flags, as the first toggle round holds them."""
    bits = rng.integers(0, 2, size=shape)
    return jfd.pack_ints([FR.r if b else 0 for b in bits.ravel()],
                         shape).astype(np.uint32)


def _ints(a) -> np.ndarray:
    """Montgomery limbs (numpy or tensor) -> canonical values (objects)."""
    a = limbs_to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.vectorize(lambda v: v * RINV % P, otypes=[object])(
        jfd.unpack_ints(a))


def _same(want_jax, got_torch):
    assert np.array_equal(np.asarray(want_jax), limbs_to_numpy(got_torch))


# ---------------------------------------------------------------------------
# K14, K15: the toggled grand product's round
# ---------------------------------------------------------------------------

def _toggle_inputs(m, s, seed, edge=False, first=False):
    rng = np.random.default_rng(seed)
    flags = _flags01(rng, (m, s)) if first else _limbs(rng, (m, s), edge)
    return (flags, _limbs(rng, (2 * m, s), edge), _limbs(rng, (s,), edge),
            _limbs(rng, (2 * m,), edge))


def _toggle_oracle(flags, fps, eq, coeffs):
    """sum_i eq_t(i) sum_b c_b (f_t(b // 2, i) p_t(b, i) + 1 - f_t) at
    t = 0, 2, 3 on Python ints."""
    f, p, e, c = (_ints(x) for x in (flags, fps, eq, coeffs))
    h = f.shape[-1] // 2
    at = lambda x, t: (x[..., :h] + t * (x[..., h:] - x[..., :h])) % P  # noqa
    out = []
    for t in (0, 2, 3):
        ft, pt, et = at(f, t), at(p, t), at(e, t)
        total = 0
        for i in range(h):
            inner = sum(c[b] * (ft[b // 2, i] * pt[b, i] + 1 - ft[b // 2, i])
                        for b in range(p.shape[0]))
            total += et[i] * inner
        out.append(total % P)
    return out


@pytest.mark.parametrize("edge", [False, True])
def test_toggle_evals_matches_jolt_tpu(edge):
    ins = _toggle_inputs(3, 8, 14, edge)
    want = jgp._toggle_cubic_evals(JFR, *map(jnp.asarray, ins))
    got = fk.toggle_evals(FR, *map(limbs_from_numpy, ins))
    _same(want, got)
    _same(want, tgp._toggle_cubic_evals(FR, *map(limbs_from_numpy, ins)))


@pytest.mark.parametrize("m,s,edge,first", [
    (2, 2, False, False), (2, 8, False, True), (3, 2, True, False),
    (2, 8, True, True)])
def test_toggle_evals_against_the_host_formula(m, s, edge, first):
    """m = 2; s = 2 (the last round); edge residues; 0/1 flags (the first
    round)."""
    ins = _toggle_inputs(m, s, 100 * m + s, edge, first)
    got = fk.toggle_evals(FR, *map(limbs_from_numpy, ins))
    assert list(_ints(got)) == _toggle_oracle(*ins)


@pytest.mark.parametrize("edge", [False, True])
def test_toggle_bind_matches_jolt_tpu(edge):
    flags, fps, eq, _ = _toggle_inputs(3, 8, 15, edge)
    r = _limbs(np.random.default_rng(16), (), edge)
    want = jgp._toggle_bind(JFR, *map(jnp.asarray, (flags, fps, eq, r)))
    ts = tuple(map(limbs_from_numpy, (flags, fps, eq)))
    rt = limbs_from_numpy(r)
    for got in (fk.bind_halves(FR, ts, rt), tgp._toggle_bind(FR, *ts, rt)):
        assert len(got) == 3
        for w, g in zip(want, got):
            _same(w, g)


def test_toggle_bind_at_the_last_round():
    """s = 2: each row binds to one entry, lo + r (hi - lo)."""
    flags, fps, eq, _ = _toggle_inputs(2, 2, 17, True)
    r = _limbs(np.random.default_rng(18), ())
    got = fk.bind_halves(FR, tuple(map(limbs_from_numpy, (flags, fps, eq))),
                         limbs_from_numpy(r))
    rv = _ints(r)[()]
    for x, g in zip((flags, fps, eq), got):
        v = _ints(x)
        assert g.shape[-1] == 1
        assert (_ints(g)[..., 0] == (v[..., 0] + rv * (v[..., 1] - v[..., 0]))
                % P).all()


def test_toggle_chunks_add_up():
    """Past TOGGLE_MAX_M memories the launches' outputs add mod p: the
    plain version over toggle_chunks' slices, summed, equals it over all
    memories (each slice carries its own coefficients' sum)."""
    m = fk.TOGGLE_MAX_M + 2
    flags, fps, eq, coeffs = map(limbs_from_numpy,
                                 _toggle_inputs(m, 2, 19))
    parts = [fk.toggle_evals(FR, flags[:, j0:j1], fps[:, 2 * j0:2 * j1], eq,
                             coeffs[:, 2 * j0:2 * j1])
             for j0, j1 in fk.toggle_chunks(m)]
    assert len(parts) == 2
    assert torch.equal(arith.add(FR, *parts),
                       fk.toggle_evals(FR, flags, fps, eq, coeffs))


def test_toggle_evals_refuses_mismatched_shapes():
    flags, fps, eq, coeffs = map(limbs_from_numpy, _toggle_inputs(2, 4, 20))
    with pytest.raises(ValueError):
        fk.toggle_evals(FR, flags, fps[:, :3], eq, coeffs)
    with pytest.raises(ValueError):
        fk.toggle_evals(FR, flags[..., :3], fps[..., :3], eq[..., :3],
                        coeffs)


# ---------------------------------------------------------------------------
# K16, K15: the opening reduction's round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("A,edge", [(1, False), (3, False), (3, True)])
def test_reduction_round_matches_jolt_tpu(A, edge):
    """(eval_0, eval_2) of A pairs weighted by their coefficients from the
    constant k, as _reduction_round_fs weighs jolt_tpu's _quadratic_evals
    (here on the host), and the pairs bound by bind_top."""
    rng = np.random.default_rng(160 + A + edge)
    n = 8
    polys = [_limbs(rng, (n,), edge) for _ in range(A)]
    eqs = [_limbs(rng, (n,), edge) for _ in range(A)]
    cs = [int(x) % P for x in rng.integers(1, 1 << 62, size=A)]
    k = int(rng.integers(0, 1 << 62)) if not edge else P - 1
    ev = [k, k]
    for p, q, c in zip(polys, eqs, cs):
        pair = jop._quadratic_evals(JFR, jnp.asarray(p), jnp.asarray(q))
        for t, v in enumerate(_ints(np.asarray(pair))):
            ev[t] = (JFElt(ev[t], JFR) + JFElt(c, JFR) * JFElt(int(v), JFR)).v
    got = fk.reduction_evals(FR, [limbs_from_numpy(p) for p in polys],
                             [limbs_from_numpy(q) for q in eqs],
                             fk.host_limbs(FR, cs),
                             fk.host_limbs(FR, [k])[:, 0])
    assert list(_ints(got)) == ev

    r = _limbs(rng, ())
    want = [jmle.bind_top(JFR, jnp.asarray(x), jnp.asarray(r))
            for x in polys + eqs]
    got = fk.bind_halves(FR, [limbs_from_numpy(x) for x in polys + eqs],
                         limbs_from_numpy(r))
    for w, g in zip(want, got):
        _same(w, g)


def test_reduction_evals_refuses_pairs_of_other_lengths():
    rng = np.random.default_rng(21)
    a, b = (limbs_from_numpy(_limbs(rng, (n,))) for n in (8, 4))
    cs, k = fk.host_limbs(FR, [3, 5]), fk.host_limbs(FR, [0])[:, 0]
    with pytest.raises(ValueError, match="one length"):
        fk.reduction_evals(FR, [a, b], [a, b], cs, k)
    with pytest.raises(ValueError, match="one length"):
        fk.reduction_evals(FR, [a], [b], cs[:, :1], k)
    with pytest.raises(ValueError):
        fk.reduction_evals(FR, [a], [a], cs, k)          # coeffs [16, 2]


def test_host_limbs_are_montgomery_forms():
    vals = EDGES + [12345, P + 7]
    assert torch.equal(fk.host_limbs(FR, vals),
                       tfd.ints_to_device(FR, vals, "cpu"))


# ---------------------------------------------------------------------------
# K17: the RLC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths,pad_to,strided", [
    ((16, 8, 2), None, False), ((16, 8, 2), 16, True),
    ((8, 4, 2), 16, False), ((16, 16, 16), None, True)])
def test_rlc_polys_matches_jolt_tpu(lengths, pad_to, strided):
    """Unequal lengths read as zero at the tail; pad_to past every
    polynomial (HyperKZG's); the polynomials as columns of one [16, 3, n]
    tensor, read in place (one compile: every case pads to three of 16)."""
    rng = np.random.default_rng(sum(lengths) + bool(strided))
    polys = [_limbs(rng, (n,), edge=n == 8) for n in lengths]
    cs = [int(x) % P for x in rng.integers(1, 1 << 62, size=3)]
    want = jop.rlc_polys(JFR, [jnp.asarray(p) for p in polys],
                         [JFElt(c, JFR) for c in cs], pad_to=pad_to)
    if strided:
        n = max(lengths)
        wide = np.zeros((16, 3, n), dtype=np.uint32)
        for i, p in enumerate(polys):
            wide[:, i, :p.shape[-1]] = p
        wide_t = limbs_from_numpy(wide)
        ts = [tfd.col(wide_t, i)[:, :n_i] for i, n_i in enumerate(lengths)]
        assert all(t.stride(-1) == 1 and not t.is_contiguous() for t in ts)
    else:
        ts = [limbs_from_numpy(p) for p in polys]
    got = top.rlc_polys(FR, ts, [FElt(c, FR) for c in cs], pad_to=pad_to)
    _same(want, got)


def test_rlc_chunks_add_up():
    """Past RLC_MAX polynomials each launch adds its sum into the
    output: the plain version over the first RLC_MAX and the rest,
    added, equals it over all of them."""
    rng = np.random.default_rng(22)
    k = fk.RLC_MAX + 2
    polys = [limbs_from_numpy(_limbs(rng, (4,))) for _ in range(k)]
    cs = fk.host_limbs(FR, range(3, 3 + k))
    q = fk.RLC_MAX
    assert torch.equal(
        arith.add(FR, fk.rlc(FR, polys[:q], cs[:, :q], 4),
                  fk.rlc(FR, polys[q:], cs[:, q:], 4)),
        fk.rlc(FR, polys, cs, 4))


def test_rlc_refuses_a_polynomial_longer_than_the_output():
    rng = np.random.default_rng(23)
    a = limbs_from_numpy(_limbs(rng, (8,)))
    with pytest.raises(ValueError):
        fk.rlc(FR, [a], fk.host_limbs(FR, [1]), 4)
    with pytest.raises(ValueError):
        fk.rlc(FR, [a, a], fk.host_limbs(FR, [1]), 8)
