"""Each CUDA kernel of the port against its plain version, on the card.

Card-only (marker `cuda`): without a CUDA device every test skips.  The
shapes are the edges the main path reaches and chip_smoke.py's nv = 20
shapes do not: GP rounds down to pair size 2 at every batch size the
provers use, odd sizes, views with a batch stride, a broadcast scalar
operand; K2 and K5 on edge residues (0, 1, p - 1, R mod p, ...), where the
kernels' lazy reduction crosses p and 2p, and on P + (-P); K2 called again
and again, which checks that its last-block counter is reset; K8 (the
transcript events) against its plain version and the host transcript over
chained appends and challenges, at a chained GKR layer's merged list,
past its shared memory and with empty segments, and K9 (the device
Fiat-Shamir round) at every degree it takes; K3 taking its challenge from
the card; K10 (the modular add, subtract, negate) at 1 to 2^20 elements,
on strided halves and broadcasts and edge residues, refusing int64; K11
(the modular sum) at lengths 1 to 2^20 along each axis and over many
rows, at the sha2 prove's largest sum, a row cut into exactly one wave
of segments, a wave of tiles and an unaligned view, twice (its tickets
reset), and on two streams in turn; the primary round's kernel (the
extrapolation, the collations, the finisher and the sum of every point)
at h = 1 to 2^15 on rv32i_vm(), the narrow VM in Fr and Fq and the mini
VM, on views of wider tensors, twice (its ticket resets), one launch a
round, and once a shard on a virtual card mesh; each call of K10, K11
and the round one launch; K14 (the toggle round's evaluations) from
s = 2 to 2^12, with 0/1 flags, edge residues, 55 and 130 memories (two
launches), twice (its ticket resets); K15 (the binds) on views, 35
tensors (two launches), a challenge by value and on the card; K16 (the
reduction round) at 1, 3 and 17 pairs (two launches) from n = 2 to
2^12 on edge residues; K17 (the RLC) at unequal lengths, a pad past
every polynomial, strided columns read in place, and 50 polynomials (two
launches); and K14, K15 and K16 a shard on a virtual card mesh.  Every
comparison is of integer
limbs or transcript bytes: the tolerance is zero.  This file imports nothing of JAX, so on a
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
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.subprotocols import fs_device as fsd
from jolt_tpu_torch.transcript import Transcript
from jolt_tpu_torch.utils import keccak_device as kd

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


def _launched(kernel, fn, n=1):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + n
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


@pytest.mark.parametrize("B", [1, 7, 8, 43, 64, 65, 81, 110, 128, 200])
@pytest.mark.parametrize("s", [2, 6, 64, 1026, 1 << 17])
def test_gp_pair_round(dev, B, s):
    """B up to the full VM's 110 (its toggled read/write GP) and 81 (its
    init/final GP), the kernel's cap of 128, and 200, which the wrapper
    splits over two launches."""
    spec = fr_spec()
    l = _rand(spec, dev, B, s, seed=3).movedim(0, 1).contiguous()
    r = _rand(spec, dev, B, s, seed=4).movedim(0, 1).contiguous()
    eq, coeffs = _rand(spec, dev, s, seed=5), _rand(spec, dev, B, seed=6)
    _equal(_launched(fk.GP_PAIR_EVALS,
                     lambda: fk.gp_pair_evals(spec, l, r, eq, coeffs),
                     len(fk.gp_batch_chunks(B))),
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


def _msm_inputs(N, rows, bits, seed):
    """N generators (g * k, k from a seeded Random) with a repeated one,
    and rows x N scalars below 2^bits, Montgomery, on the CPU."""
    import random
    rng = random.Random(seed)
    g = G1Affine.generator().to_jacobian()
    pts = [g.mul(rng.randrange(1, fr_spec().p)).to_affine() for _ in range(N)]
    if N > 1:
        pts[-1] = pts[0]                                 # doubling lanes
    vals = [[rng.randrange(1 << bits) for _ in range(N)] for _ in range(rows)]
    if N > 1:
        for r in vals:
            r[-1] = r[0]
    return pts, vals


@pytest.mark.parametrize("N,rows,bits", [(1, 1, 254), (37, 3, 254),
                                         (256, 4, 63), (1024, 64, 63)])
def test_windowed_msm_kernels_at_its_shapes(dev, N, rows, bits, monkeypatch):
    """Every K6 and K7 call of a windowed MSM on the card (scan, bit
    planes, Horner) against its plain version, and the MSMs against the
    host's."""
    from jolt_tpu_torch.curve import device as cd
    from jolt_tpu_torch.curve.bn254 import g1_msm_host
    pts, vals = _msm_inputs(N, rows, bits, seed=N)
    calls = []

    def record(name, kernel):
        def wrapped(*args):
            calls.append((name, args, kernel(*args)))
            return calls[-1][2]
        monkeypatch.setattr(cd, name, wrapped)

    record("jac_add", cd.jac_add)
    record("jac_double", cd.jac_double)
    bases = tuple(fd.ints_to_device(fq_spec(), v, dev) for v in (
        [p.x for p in pts], [p.y for p in pts], [1] * len(pts)))
    got = cd.msm(bases, fd.ints_to_device(fr_spec(), vals, dev))
    assert got == [g1_msm_host(pts, r) for r in vals]
    assert {name for name, _, _ in calls} == {"jac_add", "jac_double"}
    for name, args, out in calls:          # the plain versions, on the card
        plain = ck.jac_add_plain(*args) if name == "jac_add" \
            else ck.jac_double_plain(*args[0])
        _equal(out, plain)


def test_hyrax_commit_on_the_card_equals_the_cpu(dev):
    """Generators and a commitment of 2^8 values below 2^63 (16 rows of
    16): the card (K6, K7) and the CPU's plain versions agree."""
    import numpy as np
    from jolt_tpu_torch.commitment.hyrax import HyraxScheme
    vals = np.random.default_rng(0).integers(1, 1 << 63, size=256,
                                             dtype=np.uint64)
    coms = []
    for d in (dev, torch.device("cpu")):
        pcs = HyraxScheme.setup(256, device=d)
        before = (ck.JAC_ADD.launches, ck.JAC_DOUBLE.launches)
        coms.append(pcs.commit(fd.u64_to_mont_device(fr_spec(), vals, d)))
        if d.type == "cuda":
            assert ck.JAC_ADD.launches > before[0]
            assert ck.JAC_DOUBLE.launches > before[1]
    assert coms[0].row_commitments == coms[1].row_commitments


def _edge_scalars(spec, n, seed):
    """n scalars, most of them edges (0, 1, p - 1, R mod p), as ints."""
    import random
    rng = random.Random(seed)
    pool = [0, 1, spec.p - 1, spec.r]
    return [rng.choice(pool) if rng.random() < 0.5 else rng.randrange(spec.p)
            for _ in range(n)]


def test_transcript_events_chain(dev):
    """1,024 chained events (appends of edge scalars, challenges) in
    launches of up to 16 segments: K8 == its plain version on the card ==
    the host transcript, state, count and challenges; some challenge
    digests lie in [5p, 2^256), the range the reduction must handle."""
    import random
    spec = fr_spec()
    rng = random.Random(8)
    host = Transcript(b"k8")
    state = fsd.state_to_device(host, dev)
    plain_state = state.clone()
    done, big = 0, 0
    while done < 1024:
        segs = [(rng.choice((kd.APPEND, kd.CHALLENGE)), rng.randrange(0, 9))
                for _ in range(rng.randrange(1, kd.MAX_SEGS + 1))]
        n_app = sum(c for k, c in segs if k == kd.APPEND)
        vals = _edge_scalars(spec, max(n_app, 1), seed=done)
        sc = fd.ints_to_device(spec, vals, dev)
        before = kd.TRANSCRIPT_EVENTS.launches
        state, chals = kd.transcript_events(spec, state, sc, segs)
        torch.cuda.synchronize()
        assert kd.TRANSCRIPT_EVENTS.launches == before + 1
        plain_state, plain_chals = kd.transcript_events_plain(
            spec, plain_state, sc, segs)
        _equal((state, chals), (plain_state, plain_chals))
        want, col = [], 0
        for kind, count in segs:
            for _ in range(count):
                if kind == kd.APPEND:
                    host.append_scalar(FElt(vals[col], spec))
                    col += 1
                else:
                    want.append(host.challenge_scalar().v)
                    big += int.from_bytes(host.state, "big") >= 5 * spec.p
        assert fsd.state_bytes(state) == (host.state, host.n_rounds)
        assert [int(v) for v in fd.device_to_ints(spec, chals).tolist()] \
            == want
        done += sum(c for _, c in segs)
    assert big > 0


@pytest.mark.parametrize("segs", [
    [(kd.APPEND, 2 * B), (kd.CHALLENGE, 1), (kd.CHALLENGE, B)]
    for B in (81, 110, 128)] + [
    [(kd.APPEND, 1000)],
    [(kd.APPEND, 600), (kd.CHALLENGE, 0), (kd.CHALLENGE, 300)],
    [(kd.CHALLENGE, 0), (kd.APPEND, 0)],
    [(kd.APPEND, 3), (kd.CHALLENGE, 0), (kd.APPEND, 0), (kd.CHALLENGE, 2),
     (kd.APPEND, 0)]],
    ids=["layer81", "layer110", "layer128", "appends1000", "scratch900",
         "empty", "empty_between"])
def test_transcript_events_lists(dev, segs):
    """K8 at a chained GKR layer's merged list (2B claims, r_layer, the
    next B coefficients) for the full VM's batches, past the block's
    threads and shared memory (1,000 appends; 900 events), and with empty
    segments: == its plain version == the host transcript, in one
    launch."""
    spec = fr_spec()
    host = Transcript(b"k8 lists")
    state = fsd.state_to_device(host, dev)
    n_app = sum(c for k, c in segs if k == kd.APPEND)
    vals = _edge_scalars(spec, max(n_app, 1), seed=n_app)
    sc = fd.ints_to_device(spec, vals, dev)
    got = _launched(kd.TRANSCRIPT_EVENTS,
                    lambda: kd.transcript_events(spec, state, sc, segs))
    _equal(got, kd.transcript_events_plain(spec, state, sc, segs))
    want, col = [], 0
    for kind, count in segs:
        for _ in range(count):
            if kind == kd.APPEND:
                host.append_scalar(FElt(vals[col], spec))
                col += 1
            else:
                want.append(host.challenge_scalar().v)
    assert fsd.state_bytes(got[0]) == (host.state, host.n_rounds)
    assert [int(v) for v in fd.device_to_ints(spec, got[1]).tolist()] == want


def test_digest_reduction_on_the_card(dev):
    """K8's and K9's challenge conversion is field.cuh's fmul(R^2, v) with
    the digest v in the b slot; K1 runs the same routine: all-ones and
    [5p, 2^256) digests against the plain words_to_mont."""
    spec = fr_spec()
    vals = [(1 << 256) - 1, 5 * spec.p, 5 * spec.p + 12345,
            (1 << 256) - spec.p]
    limbs = torch.from_numpy(fd.pack_ints(vals).astype("int32")).to(dev)
    r2 = arith.const_limbs(spec, "r2", dev).reshape(16, 1)
    got = fk.mont_mul(spec, r2, limbs)
    words = torch.tensor([[int.from_bytes(v.to_bytes(32, "big")[4 * k:4 * k + 4],
                                          "little") for v in vals]
                          for k in range(8)], dtype=torch.int64, device=dev)
    _equal(got, kd.words_to_mont(spec, words))
    assert [int(v) for v in fd.device_to_ints(spec, got).tolist()] == \
        [v % spec.p for v in vals]


@pytest.mark.parametrize("degree,use_hint,n_evals",
                         [(d, hint, n) for d in range(1, 9)
                          for hint, n in ((True, d), (True, d + 1),
                                          (False, d + 1))])
def test_fs_round(dev, degree, use_hint, n_evals):
    """K9 == its plain version at every degree it takes (1..8: 2 is the
    opening reduction, 3 GKR, toggle and Spartan, 8 the full VM's primary
    sumcheck), with the hint (the evaluation at 1 left out or given) and
    without; edge residues."""
    spec = fr_spec()
    host = Transcript(b"k9")
    state = fsd.state_to_device(host, dev)
    for seed in range(4):
        evals = _edge(spec, dev, n_evals, seed=seed)
        prev = _edge(spec, dev, 1, seed=seed + 9)[:, 0]
        got = _launched(fsd.FS_ROUND, lambda: fsd.fs_round(
            spec, evals, prev, state, degree, use_hint))
        want = fsd.fs_round_plain(spec, evals, prev, state, degree, use_hint)
        _equal(got, want)
        state = got[3]


@pytest.mark.parametrize("degree,use_hint,n_evals",
                         [(9, True, 9), (9, False, 10), (12, True, 13),
                          (12, False, 13), (40, False, 41)])
def test_fs_round_past_degree_8(dev, degree, use_hint, n_evals):
    """K9 sizes its shared buffers from the degree at launch: 9 and 12,
    and 40, past the 48 KiB a block takes without opting in, equal the
    plain version; edge residues."""
    spec = fr_spec()
    state = fsd.state_to_device(Transcript(b"k9 degree"), dev)
    for seed in range(2):
        evals = _edge(spec, dev, n_evals, seed=seed)
        prev = _edge(spec, dev, 1, seed=seed + 5)[:, 0]
        got = _launched(fsd.FS_ROUND, lambda: fsd.fs_round(
            spec, evals, prev, state, degree, use_hint))
        _equal(got, fsd.fs_round_plain(spec, evals, prev, state, degree,
                                       use_hint))
        state = got[3]


def test_fs_round_refuses_a_degree_past_the_cards_shared_memory(dev):
    spec = fr_spec()
    state = fsd.state_to_device(Transcript(b"k9"), dev)
    evals = _edge(spec, dev, 101)
    with pytest.raises(ValueError, match="degree 100"):
        fsd.fs_round(spec, evals, evals[:, 0], state, 100, False)


def test_sharded_gp_round_on_a_virtual_card_mesh(dev):
    """parallel/sharding.py on a virtual mesh of 4 shards on the card: B = 11
    padded to 12; K2 and K3 once per shard; equal to one unsharded call."""
    from jolt_tpu_torch.parallel import sharding as sh
    spec = fr_spec()
    mesh = sh.make_mesh(4, device=dev)
    l = _rand(spec, dev, 11, 64, seed=6).movedim(0, 1).contiguous()
    r = _rand(spec, dev, 11, 64, seed=7).movedim(0, 1).contiguous()
    eq, co = _rand(spec, dev, 64, seed=8), _rand(spec, dev, 11, seed=9)
    rc = fd.scalar_to_device(spec, 0x1234567 ** 9, dev)
    pl, pr = sh.maybe_shard_pair(mesh, (l, r))
    cop = torch.cat([co, fd.zeros(spec, (1,), dev)], dim=1)
    before = (fk.GP_PAIR_EVALS.launches, fk.GP_PAIR_BIND.launches)
    e, nl, nr, neq = sh.sharded_gp_round(mesh, spec, pl, pr, eq, cop, rc)
    torch.cuda.synchronize()
    assert (fk.GP_PAIR_EVALS.launches - before[0],
            fk.GP_PAIR_BIND.launches - before[1]) == (4, 4)
    _equal(e, fk.gp_pair_evals(spec, l, r, eq, co))
    _equal((nl.gather()[:11], nr.gather()[:11], neq.gather()),
           fk.gp_pair_bind(spec, l, r, eq, rc))


def test_gp_pair_bind_takes_a_challenge_on_the_card(dev):
    spec = fr_spec()
    l = _rand(spec, dev, 3, 64, seed=3).movedim(0, 1).contiguous()
    r = _rand(spec, dev, 3, 64, seed=4).movedim(0, 1).contiguous()
    eq = _rand(spec, dev, 64, seed=5)
    rc = fd.scalar_to_device(spec, 0x1234567 ** 9, dev)
    _equal(_launched(fk.GP_PAIR_BIND,
                     lambda: fk.gp_pair_bind(spec, l, r, eq, rc)),
           fk.gp_pair_bind_plain(spec, l, r, eq, rc))


# ---------------------------------------------------------------------------
# K10, K11: the modular add/sub/neg and the modular sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("n", [1, 257, 1 << 20])
@pytest.mark.parametrize("op", [fk.ADD, fk.SUB, fk.NEG])
def test_field_addsub(dev, name, n, op):
    """Contiguous operands, edge residues, and a = b (a - a = 0)."""
    spec = SPECS[name]
    a, b = _edge(spec, dev, n, seed=1), _edge(spec, dev, n, seed=2)
    for x, y in ((a, b), (a, a), (b, a)):
        _equal(_launched(fk.FIELD_ADDSUB,
                         lambda: fk.field_addsub(spec, x, y, op)),
               fk.field_addsub_plain(spec, x, y, op))


@pytest.mark.parametrize("m,n", [(3, 2), (55, 1 << 10), (7, 1 << 16)])
def test_field_addsub_on_strided_halves_and_broadcasts(dev, m, n):
    """The round split's halves of [16, m, n] (no copy), a stride-0
    scalar on either side, a column broadcast along the last axis, and
    fd.fadd/fsub/fneg on the same views: one launch each."""
    spec = fr_spec()
    t, u = _edge(spec, dev, m, n, seed=3), _edge(spec, dev, m, n, seed=4)
    h = n // 2
    lo, hi = t[..., :h], u[..., h:]
    s = u[:, 1:2, 0:1]
    col = t[:, :, :1]
    for x, y in ((lo, hi), (hi, lo), (lo, s), (s, hi), (col, hi), (hi, col)):
        for op in (fk.ADD, fk.SUB):
            _equal(_launched(fk.FIELD_ADDSUB,
                             lambda: fk.field_addsub(spec, x, y, op)),
                   fk.field_addsub_plain(spec, x, y, op))
    for f, args in ((fd.fadd, (lo, hi)), (fd.fsub, (lo, hi)), (fd.fneg, (hi,))):
        _equal(_launched(fk.FIELD_ADDSUB, lambda: f(spec, *args)),
               fk.field_addsub_plain(spec, *((hi, hi) if f is fd.fneg
                                             else args),
                                     {fd.fadd: fk.ADD, fd.fsub: fk.SUB,
                                      fd.fneg: fk.NEG}[f]))


def test_field_addsub_refuses_int64(dev):
    spec = fr_spec()
    a = _rand(spec, dev, 8)
    with pytest.raises(TypeError, match="int32"):
        fk.field_addsub(spec, a.long(), a, fk.ADD)
    with pytest.raises(TypeError, match="int32"):
        fd.fsum(spec, a.long(), -1)


@pytest.mark.parametrize("n", [1, 2, 3, 1023, 1 << 15, 1 << 20])
@pytest.mark.parametrize("axis", [0, 1])
def test_field_sum(dev, n, axis):
    """Lengths 1 to 2^20 along each axis of [16, n, 3] / [16, 3, n] (the
    summed axis has element stride 3 or 1: lanes along the rows), edge
    residues; called twice, so a row's ticket is reset."""
    spec = fr_spec()
    shape = (n, 3) if axis == 0 else (3, n)
    a = _edge(spec, dev, *shape, seed=n)
    want = fk.field_sum_plain(spec, a, axis)
    for _ in range(2):
        _equal(_launched(fk.FIELD_SUM, lambda: fd.fsum(spec, a, axis)), want)


@pytest.mark.parametrize("shape,axis", [((110, 1 << 15), 0),
                                        ((55, 1 << 16), 0),
                                        ((64, 3, 5), 1), ((40, 9), -1),
                                        ((1 << 16, 2), -1),
                                        ((300, 33), 0), ((16, 1 << 16), -1),
                                        ((5, 2051), -1)])
def test_field_sum_rows(dev, shape, axis):
    """Many rows: the leading axis of [16, B, h] (lanes across rows, the
    terms over 8 warps), a middle axis (the rest made contiguous), many
    short rows, few rows cut into segments, rows whose last terms follow
    their 16-byte loads one at a time."""
    spec = fr_spec()
    a = _edge(spec, dev, *shape, seed=len(shape))
    _equal(_launched(fk.FIELD_SUM, lambda: fd.fsum(spec, a, axis)),
           fk.field_sum_plain(spec, a, axis))


@pytest.mark.parametrize("what", ["[16,2^23] along -1",
                                  "[16,110,2^15] along 0",
                                  "a row one wave of segments long",
                                  "a wave of tiles", "a view one term in"])
def test_field_sum_main_path_shapes(dev, what):
    """The sha2-chain prove's largest sum, the GP's sum over the leading
    axis, a row that sum_plan cuts into exactly one wave of segments
    (SUM_WAVE), rows that make exactly one wave of tiles, and a view whose
    terms are not 16-byte aligned (scalar loads): each one launch, equal
    to the plain version, twice (the tickets reset)."""
    spec = fr_spec()
    wave = fk.SUM_WAVE * fk.SUM_MIN_TERMS * fk.SUM_THREADS
    a, axis = {
        "[16,2^23] along -1": lambda: (_rand(spec, dev, 1 << 23), -1),
        "[16,110,2^15] along 0": lambda: (_edge(spec, dev, 110, 1 << 15), 0),
        "a row one wave of segments long": lambda: (
            _edge(spec, dev, wave), -1),
        "a wave of tiles": lambda: (_edge(spec, dev, 7, 32 * fk.SUM_WAVE),
                                    0),
        "a view one term in": lambda: (_edge(spec, dev, 3, 4099)[..., 1:],
                                       -1)}[what]()
    want = fk.field_sum_plain(spec, a, axis)
    for _ in range(2):
        _equal(_launched(fk.FIELD_SUM, lambda: fd.fsum(spec, a, axis)), want)


def test_field_sum_on_two_streams(dev):
    """Sums cut into segments on two streams in turn, each stream with its
    own partials and tickets: every sum equals the plain version's, and
    each stream's counters are back at 0."""
    spec = fr_spec()
    args = [(_edge(spec, dev, 1 << 20, seed=50), -1),
            (_edge(spec, dev, 300, 40, seed=51), 0)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(4):
        for k in range(2):
            with torch.cuda.stream(streams[k]):
                got[k].append(fd.fsum(spec, *args[k]))
    torch.cuda.synchronize()
    for k in range(2):
        want = fk.field_sum_plain(spec, *args[k])
        for g in got[k]:
            _equal(g, want)
        key = (torch.device(dev.type, torch.cuda.current_device()),
               streams[k].cuda_stream)
        assert int(fk._SUM_SCRATCH[key][0].abs().sum()) == 0


# ---------------------------------------------------------------------------
# The primary round: extrapolation, collations, finisher and sum, one launch
# ---------------------------------------------------------------------------

def _lookups(spec, M, narrow=False, fib=False):
    """What the round reads of rv32i_vm()'s lookup preprocessing (C = 4; at
    M = 2^8 the narrow VM's 23 instructions, or the mini VM's ADD and
    BNE)."""
    from types import SimpleNamespace
    from jolt_tpu_torch.instructions import RV32I_INSTRUCTIONS
    from jolt_tpu_torch.vm import instruction_lookups as il
    from jolt_tpu_torch.vm.fixtures import narrow_instructions
    from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES
    by = {c.name: c for c in RV32I_INSTRUCTIONS}
    classes = ([by["add"], by["bne"]] if fib else
               narrow_instructions(RV32I_INSTRUCTIONS) if narrow
               else list(RV32I_INSTRUCTIONS))
    return SimpleNamespace(
        instruction_classes=classes, C=4, M=M, spec=spec,
        sumcheck_degree=max(c().g_poly_degree(4) for c in classes) + 2,
        instruction_to_memory_indices=il.memory_layout(
            classes, RV32I_SUBTABLES, 4, M)[3])


def _round_inputs(spec, dev, pre, n, seed, edge=True):
    make = _edge if edge else _rand
    m = 1 + max(max(mk) for mk in pre.instruction_to_memory_indices)
    return (make(spec, dev, n, seed=seed), make(spec, dev, n, seed=seed + 1),
            make(spec, dev, len(pre.instruction_classes), n, seed=seed + 2),
            make(spec, dev, m, n, seed=seed + 3))


def _round(pre, ts, n=1):
    """The round on the card, launched n times (once a call), twice, each
    equal to its plain version on the same tensors."""
    from jolt_tpu_torch.vm import instruction_lookups as il
    want = il.primary_round_plain(pre, *ts)
    assert want.shape == (16, pre.sumcheck_degree + 1)
    for _ in range(2):
        got = _launched(il.PRIMARY_ROUND, lambda: il.primary_round(pre, *ts),
                        n)
        _equal(got, want)


@pytest.mark.parametrize("h", [1, 5, 1 << 15])
def test_primary_finish(dev, h):
    """The round's finisher on the mini VM (ADD, BNE) at h = 1, 5 and
    2^15: eq and out on edge residues, so inner - out and eq's product
    wrap; one launch a call, twice (its ticket resets)."""
    spec = fr_spec()
    pre = _lookups(spec, 1 << 8, fib=True)
    _round(pre, _round_inputs(spec, dev, pre, 2 * h, seed=h))


@pytest.mark.parametrize("h", [1, 2, 5, 1 << 12, 1 << 15])
def test_collate(dev, h):
    """The round on rv32i_vm()'s 29 instructions (55 memories) at the
    first round's h = 2^15, h = 2^12 and the last rounds, on edge
    residues: E and the flags as column views of wider tensors, eq and out
    as element views (stride 2), as the kernel takes any strides."""
    spec = fr_spec()
    pre = _lookups(spec, 1 << 16)
    eq, out, fl, e = _round_inputs(spec, dev, pre, 4 * h, seed=h)
    e_wide = torch.cat([e, _edge(spec, dev, 3, 4 * h, seed=9)], dim=1)
    ts = (eq[:, ::2], out[:, 1::2], fl[..., :2 * h], e_wide[:, :55, 2 * h:])
    _round(pre, ts)


@pytest.mark.parametrize("name", SPECS)
def test_collate_narrow_vm(dev, name):
    """The narrow VM's 23 instructions at M = 2^8, in Fr and in Fq (the
    field's words go in as K10 and K11 take them), at h = 300: a tile
    half full."""
    spec = SPECS[name]
    pre = _lookups(spec, 1 << 8, narrow=True)
    _round(pre, _round_inputs(spec, dev, pre, 600, seed=5))


def test_collate_refuses_int64(dev):
    from jolt_tpu_torch.vm import instruction_lookups as il
    spec = fr_spec()
    pre = _lookups(spec, 1 << 16)
    eq, out, fl, e = _round_inputs(spec, dev, pre, 8, seed=1, edge=False)
    with pytest.raises(TypeError, match="int32"):
        il.primary_round(pre, eq, out, fl, e.long())
    with pytest.raises(ValueError, match="CUDA"):
        il.primary_round(pre, eq, out, fl.cpu(), e)
    with pytest.raises(ValueError, match="n even"):
        il.primary_round(pre, eq[:, :7], out[:, :7], fl[..., :7], e[..., :7])


def test_primary_round_one_collate_a_point(dev):
    """The prover's round on a preprocessing of five instructions: one
    launch a round (in place of a collation launch a point), equal to the
    same round on the CPU."""
    from jolt_tpu_torch.instructions import RV32I_INSTRUCTIONS
    from jolt_tpu_torch.vm import instruction_lookups as il
    from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES
    spec = fr_spec()
    by = {c.name: c for c in RV32I_INSTRUCTIONS}
    classes = [by[n] for n in ("add", "xor", "slt", "sltu", "sll")]
    pre = il.InstructionLookupsPreprocessing(classes, RV32I_SUBTABLES, 4,
                                             1 << 8, dev, spec)
    ts = [_edge(spec, "cpu", *s, seed=i) for i, s in enumerate(
        [(64,), (64,), (5, 64), (pre.num_memories, 64)])]
    want = il.primary_round(pre, *ts)
    got = _launched(il.PRIMARY_ROUND, lambda: il.primary_round(
        pre, *(t.to(dev) for t in ts)))
    _equal(got, want)


def test_primary_round_on_a_virtual_card_mesh(dev):
    """parallel/sharding.py's round_evals on a virtual mesh of 2 shards on
    the card (rv32i_vm(), 2^10 entries, cyclic shards): one launch a
    shard, folded equal to the unsharded round."""
    from jolt_tpu_torch.parallel import sharding as sh
    from jolt_tpu_torch.vm import instruction_lookups as il
    spec = fr_spec()
    pre = _lookups(spec, 1 << 16)
    ts = _round_inputs(spec, dev, pre, 1 << 10, seed=21)
    mesh = sh.make_mesh(2, device=dev)
    shards = [sh.maybe_shard_hypercube(mesh, t) for t in ts]
    got = _launched(il.PRIMARY_ROUND, lambda: sh.round_evals(
        spec, lambda *x: il.primary_round(pre, *x), shards), 2)
    _equal(got, il.primary_round_plain(pre, *ts))


# ---------------------------------------------------------------------------
# K14-K17: the toggled grand product's round, the opening reduction's
# round and its RLC
# ---------------------------------------------------------------------------

def _toggle_ins(spec, dev, m, s, seed, edge=False, flags01=False):
    mk = _edge if edge else _rand
    if flags01:
        g = torch.Generator().manual_seed(seed)
        bits = torch.randint(0, 2, (m, s), generator=g).bool()
        one = arith.const_limbs(spec, "r", "cpu").reshape(16, 1, 1)
        flags = torch.where(bits[None], one, 0).int().to(dev)
    else:
        flags = mk(spec, dev, m, s, seed=seed)
    return (flags, mk(spec, dev, 2 * m, s, seed=seed + 1),
            mk(spec, dev, s, seed=seed + 2),
            mk(spec, dev, 2 * m, seed=seed + 3))


@pytest.mark.parametrize("m,s,edge,flags01", [
    (55, 2, True, False), (55, 64, False, True), (3, 2, True, True),
    (55, 1 << 12, False, True), (29, 1026, True, False)])
def test_toggle_evals(dev, m, s, edge, flags01):
    spec = fr_spec()
    ins = _toggle_ins(spec, dev, m, s, s + m, edge, flags01)
    for _ in range(2):                  # the ticket is reset
        _equal(_launched(fk.TOGGLE_EVALS,
                         lambda: fk.toggle_evals(spec, *ins)),
               fk.toggle_evals_plain(spec, *ins))


def test_toggle_evals_past_the_cap_and_on_views(dev):
    """130 memories: two launches, their sums added; views of wider
    tensors (a row stride past the row)."""
    spec = fr_spec()
    m = fk.TOGGLE_MAX_M + 2
    ins = _toggle_ins(spec, dev, m, 8, 40)
    _equal(_launched(fk.TOGGLE_EVALS, lambda: fk.toggle_evals(spec, *ins), 2),
           fk.toggle_evals_plain(spec, *ins))
    wide = [_rand(spec, dev, 4, 3, 16, seed=41), _rand(spec, dev, 8, 3, 16,
                                                      seed=42)]
    flags, fps = wide[0][:, :, 1], wide[1][:, :, 2]
    eq, co = _rand(spec, dev, 16, seed=43), _rand(spec, dev, 8, seed=44)
    _equal(_launched(fk.TOGGLE_EVALS,
                     lambda: fk.toggle_evals(spec, flags, fps, eq, co)),
           fk.toggle_evals_plain(spec, flags, fps, eq, co))


@pytest.mark.parametrize("on_card", [False, True])
def test_bind_halves(dev, on_card):
    """The toggle's three tensors in one launch; 35 tensors of several
    shapes, views among them, in two; the challenge by value or read on
    the card."""
    spec = fr_spec()
    r = fd.scalar_to_device(spec, 0x1234567 ** 9, dev if on_card else "cpu")
    flags, fps, eq, _ = _toggle_ins(spec, dev, 55, 1 << 10, 50, True)
    _equal(tuple(_launched(fk.BIND_HALVES,
                           lambda: fk.bind_halves(spec, (flags, fps, eq), r))),
           tuple(fk.bind_halves_plain(spec, (flags, fps, eq), r)))
    wide = _rand(spec, dev, 5, 64, seed=51)
    ts = ([_rand(spec, dev, 2 << (k % 7), seed=60 + k) for k in range(30)]
          + [wide[:, k] for k in range(5)])
    got = _launched(fk.BIND_HALVES, lambda: fk.bind_halves(spec, ts, r), 2)
    _equal(tuple(got), tuple(fk.bind_halves_plain(spec, ts, r)))
    assert all(g.is_contiguous() for g in got)


@pytest.mark.parametrize("A,n", [(1, 2), (3, 64), (3, 1 << 12), (17, 1026)])
def test_reduction_evals(dev, A, n):
    spec = fr_spec()
    polys = [_edge(spec, dev, n, seed=70 + a) for a in range(A)]
    eqs = [_edge(spec, dev, n, seed=90 + a) for a in range(A)]
    cs = fk.host_limbs(spec, [spec.p - 1 - a for a in range(A)])
    k = fk.host_limbs(spec, [spec.p - 2])[:, 0]
    launches = -(-A // fk.REDUCE_MAX_PAIRS)
    for _ in range(2):                  # the ticket is reset
        _equal(_launched(fk.REDUCTION_EVALS, lambda: fk.reduction_evals(
                   spec, polys, eqs, cs, k), launches),
               fk.reduction_evals_plain(spec, polys, eqs, cs, k))


def test_reduction_evals_refuses_what_the_kernel_does_not_take(dev):
    spec = fr_spec()
    a, b = _rand(spec, dev, 8), _rand(spec, dev, 4)
    cs, k = fk.host_limbs(spec, [1]), fk.host_limbs(spec, [0])[:, 0]
    with pytest.raises(ValueError, match="one length"):
        fk.reduction_evals(spec, [a], [b], cs, k)
    with pytest.raises(ValueError, match="by value"):
        fk.reduction_evals(spec, [a], [a], cs.to(dev), k)
    with pytest.raises(ValueError, match="contiguous"):
        w = _rand(spec, dev, 8, 2)[..., 0]
        fk.reduction_evals(spec, [w], [a], cs, k)


@pytest.mark.parametrize("lengths,n", [
    ((1 << 12, 1 << 11, 2, 1), 1 << 12), ((1 << 10, 8), 1 << 14),
    ((5,) * 50, 5), ((1 << 12,) * 85, 1 << 12)])
def test_rlc(dev, lengths, n):
    """Unequal lengths; a pad past every polynomial (HyperKZG's); 50
    polynomials (two launches, the second adding into the first's
    output); 85 columns of [16, 85, 2^12], read in place (the first
    append's)."""
    spec = fr_spec()
    k = len(lengths)
    if len(set(lengths)) == 1 and k == 85:
        wide = _edge(spec, dev, k, n, seed=80)
        polys = [wide[:, i] for i in range(k)]
    else:
        polys = [_edge(spec, dev, m, seed=81 + i) for i, m in
                 enumerate(lengths)]
    cs = fk.host_limbs(spec, [spec.p - 1 - i for i in range(k)])
    _equal(_launched(fk.RLC, lambda: fk.rlc(spec, polys, cs, n),
                     -(-k // fk.RLC_MAX)),
           fk.rlc_plain(spec, polys, cs, n))


def test_sumcheck_ops_a_shard_on_a_virtual_card_mesh(dev):
    """The toggle round and the reduction round on a virtual mesh of 2
    shards on the card (cyclic): K14 and K16 once a shard, folded equal to
    the unsharded call (K16 with its constant added once, after the
    fold); K15 once a shard and tensor."""
    from jolt_tpu_torch.parallel import sharding as sh
    from jolt_tpu_torch.poly import opening_proof as op
    from jolt_tpu_torch.subprotocols import grand_product as gp
    spec = fr_spec()
    mesh = sh.make_mesh(2, device=dev)
    ins = _toggle_ins(spec, dev, 5, 64, 100, True)
    shards = [sh.maybe_shard_hypercube(mesh, t) for t in ins[:3]]
    got = _launched(fk.TOGGLE_EVALS, lambda: sh.round_evals(
        spec, lambda f, p, e, c: gp._toggle_cubic_evals(spec, f, p, e, c),
        (*shards, ins[3])), 2)
    _equal(got, fk.toggle_evals_plain(spec, *ins))
    r = fd.scalar_to_device(spec, 77, dev)
    bound = _launched(fk.BIND_HALVES,
                      lambda: gp._toggle_bind(spec, *shards, r), 6)
    _equal(tuple(b.gather() for b in bound),
           tuple(fk.bind_halves_plain(spec, ins[:3], r)))
    polys = [_edge(spec, dev, 64, seed=110 + a) for a in range(3)]
    eqs = [_edge(spec, dev, 64, seed=120 + a) for a in range(3)]
    cs = fk.host_limbs(spec, [5, 6, 7])
    k = fk.host_limbs(spec, [spec.p - 3])[:, 0]
    sp = [sh.maybe_shard_hypercube(mesh, t) for t in polys + eqs]
    got = _launched(fk.REDUCTION_EVALS, lambda: op._round_evals(
        spec, sp[:3], sp[3:], cs, k, k.to(dev)), 2)
    _equal(got, fk.reduction_evals_plain(spec, polys, eqs, cs, k))
