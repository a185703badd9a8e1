"""The port's field arithmetic (jolt_tpu_torch.field) against jolt_tpu's.

The same limbs, made with numpy from a seed, go through jolt_tpu's XLA
path on the CPU and through the port on the CPU (the kernels' plain
versions), K10's and K11's (fadd, fsub, fneg, fsum) on strided halves,
broadcast scalars and odd lengths among them.  Every comparison is of
integer limbs: the tolerance is zero.  The CUDA wrappers' index math (the
strides K1 and K10 read operands by, K11's moved axis and its cut into
segments) is held against a Python model of the kernels' loads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.field import device as jfd
from jolt_tpu.field import fq_spec as jfq_spec
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from jolt_tpu_torch.field import device as tfd
from jolt_tpu_torch.field import kernels as tfk
from jolt_tpu_torch.field.spec import fq_spec, fr_spec

SPECS = {"fr": (jfr_spec(), fr_spec()), "fq": (jfq_spec(), fq_spec())}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_field(rng, p, shape):
    """Canonical limbs uint32[16, *shape] of random residues, with 0, 1 and
    p - 1 among the first entries."""
    n = int(np.prod(shape))
    words = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64)
    vals = [sum(int(w) << (64 * k) for k, w in enumerate(row)) % p
            for row in words]
    vals[:3] = [0, 1, p - 1][:n]
    return jfd.pack_ints(vals, shape)


def _pair(name, shape=(67,), seed=0):
    jspec, tspec = SPECS[name]
    rng = np.random.default_rng(seed)
    a = _rand_field(rng, jspec.p, shape)
    b = _rand_field(rng, jspec.p, shape)
    # put p - 1 against 0, 1 and p - 1 as well
    b.reshape(16, -1)[:, :3] = a.reshape(16, -1)[:, 2:3]
    return jspec, tspec, a, b


def _same(jax_out, torch_out):
    want = np.asarray(jax_out)
    got = limbs_to_numpy(torch_out)
    assert got.shape == want.shape
    assert (got == want).all()


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("op", ["fmul", "fadd", "fsub", "fneg"])
def test_elementwise_ops_match_jolt_tpu(name, op):
    jspec, tspec, a, b = _pair(name)
    jf, tf = getattr(jfd, op), getattr(tfd, op)
    if op == "fneg":
        _same(jf(jspec, jnp.asarray(a)), tf(tspec, limbs_from_numpy(a)))
    else:
        _same(jf(jspec, jnp.asarray(a), jnp.asarray(b)),
              tf(tspec, limbs_from_numpy(a), limbs_from_numpy(b)))


@pytest.mark.parametrize("name", SPECS)
def test_fmul_broadcast_scalar(name):
    """A [16, 1] operand against a [16, 3, 5] one: the K1 kernel's zero
    element stride on the card."""
    jspec, tspec, a, b = _pair(name, (3, 5), seed=1)
    s = b.reshape(16, -1)[:, 7:8]
    want = jfd.fmul(jspec, jnp.asarray(a),
                    jnp.broadcast_to(jnp.asarray(s)[:, :, None], a.shape))
    _same(want, tfd.fmul(tspec, limbs_from_numpy(a),
                         limbs_from_numpy(s)[:, :, None]))
    want = jfd.fmul(jspec, jnp.broadcast_to(jnp.asarray(s), a[:, 0].shape),
                    jnp.asarray(a[:, 0]))
    _same(want, tfd.fmul(tspec, limbs_from_numpy(s), limbs_from_numpy(a[:, 0])))


@pytest.mark.parametrize("name", SPECS)
def test_mont_mul_batch_leading(name):
    """K4's layout [B, 16, n] against jolt_tpu's product on the moved axes
    (its non-Pallas branch of `_pair_tree_level`)."""
    jspec, tspec, a, b = _pair(name, (4, 33), seed=2)
    al, bl = np.moveaxis(a, 0, 1), np.moveaxis(b, 0, 1)     # [4, 16, 33]
    want = jnp.moveaxis(jfd.fmul(jspec, jnp.asarray(a), jnp.asarray(b)), 0, 1)
    _same(want, tfk.mont_mul_bl(tspec, limbs_from_numpy(al),
                                limbs_from_numpy(bl)))


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_fsum(name, axis):
    jspec, tspec, a, _ = _pair(name, (6, 40), seed=3)
    # all-(p-1) columns make the limb sums carry across every limb
    a[:, :, :5] = np.asarray(jspec.p_limbs, dtype=np.uint32)[:, None, None] - (
        np.arange(16) == 0)[:, None, None]
    _same(jfd.fsum(jspec, jnp.asarray(a), axis=axis),
          tfd.fsum(tspec, limbs_from_numpy(a), axis))


@pytest.mark.parametrize("name", SPECS)
def test_montgomery_conversions(name):
    jspec, tspec, a, _ = _pair(name, (50,), seed=4)
    _same(jfd.to_mont_device(jspec, jnp.asarray(a)),
          tfd.to_mont_device(tspec, limbs_from_numpy(a)))
    _same(jfd.from_mont_device(jspec, jnp.asarray(a)),
          tfd.from_mont_device(tspec, limbs_from_numpy(a)))


@pytest.mark.parametrize("name", SPECS)
def test_u64_to_mont(name):
    jspec, tspec = SPECS[name]
    u = np.random.default_rng(5).integers(0, 1 << 64, size=(3, 7),
                                          dtype=np.uint64)
    u[0, :3] = [0, 1, (1 << 64) - 1]
    _same(jfd.u64_to_mont_device(jspec, u),
          tfd.u64_to_mont_device(tspec, u, "cpu"))


def test_host_conversions_round_trip():
    """ints -> device -> ints through the port, against jolt_tpu's limbs."""
    jspec, tspec = SPECS["fr"]
    vals = [0, 1, jspec.p - 1, 12345, 1 << 200]
    dev = tfd.ints_to_device(tspec, vals, "cpu")
    _same(jfd.ints_to_device(jspec, vals), dev)
    assert [int(v) for v in tfd.device_to_ints(tspec, dev)] == vals
    assert tfd.to_int(tspec, tfd.scalar_to_device(tspec, 99, "cpu")) == 99


def _carry_inputs(kind: str, n: int, rng):
    """(column sums [33, n] for carry, a - b limbs [16, n] for borrow):
    random products' schoolbook columns and random limbs, or carries and
    borrows that run through every limb, or the two mixed lane by lane."""
    a = rng.integers(0, 1 << 16, (16, n))
    b = rng.integers(0, 1 << 16, (16, n))
    cols = np.zeros((33, n), np.int64)
    for i in range(16):
        cols[i:i + 16] += a[i] * b
    worst_cols = np.zeros((33, n), np.int64)
    worst_cols[:32] = 0xFFFF
    worst_cols[0] += 1                   # 2^512 - 1 + 1: 32 carries
    worst_diff = np.zeros((16, n), np.int64)
    worst_diff[0] = -1                   # 0 - 1: 16 borrows
    if kind == "worst":
        return worst_cols, worst_diff
    diff = a - b
    if kind == "mixed":
        cols[:, ::3], diff[:, ::3] = worst_cols[:, ::3], worst_diff[:, ::3]
    return cols, diff


@pytest.mark.parametrize("kind", ["random", "worst", "mixed"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 1024])
def test_carry_and_borrow_routes_agree(kind, n):
    """carry and sub_borrow's two CPU routes (whole-tensor passes, limb by
    limb) give the same limbs and borrow as integer arithmetic, on either
    side of the lane count where carry switches route."""
    from jolt_tpu_torch.field import arith
    cols, diff = _carry_inputs(kind, n, np.random.default_rng(n))
    k = cols.shape[0]
    want = [sum(int(v) << (16 * i) for i, v in enumerate(cols[:, j]))
            % (1 << (16 * k)) for j in range(n)]
    t = torch.from_numpy(cols)
    for got in (arith._carry_limbs(t), arith._carry_passes(t),
                arith.carry(t)):
        g = got.numpy()
        assert (g >= 0).all() and (g < 1 << 16).all()
        assert [sum(int(v) << (16 * i) for i, v in enumerate(g[:, j]))
                for j in range(n)] == want
    value = [sum(int(v) << (16 * i) for i, v in enumerate(diff[:, j]))
             for j in range(n)]
    d = torch.from_numpy(diff)
    zero = torch.zeros_like(d)
    for out, borrow in (arith._borrow_limbs(d), arith._borrow_passes(d),
                        arith.sub_borrow(d, zero)):
        o = out.numpy()
        assert (o >= 0).all() and (o < 1 << 16).all()
        assert [sum(int(v) << (16 * i) for i, v in enumerate(o[:, j]))
                for j in range(n)] == [v % (1 << 256) for v in value]
        assert borrow.tolist() == [int(v < 0) for v in value]


# ---------------------------------------------------------------------------
# K10 and K11 (fd.fadd, fsub, fneg, fsum): their plain versions against
# jolt_tpu on views and odd lengths, and the CUDA wrappers' index math
# ---------------------------------------------------------------------------

def _halves(name, seed, m=3, n=10):
    """The lo and hi halves of two [16, m, n] tensors along the last axis
    (views whose rows are strided) as numpy and as torch views."""
    jspec, tspec, a, b = _pair(name, (m, n), seed=seed)
    h = n // 2
    ta, tb = limbs_from_numpy(a), limbs_from_numpy(b)
    return jspec, tspec, (a[..., :h], b[..., h:]), (ta[..., :h], tb[..., h:])


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("op", ["fadd", "fsub", "fneg"])
def test_addsub_on_strided_halves(name, op):
    """The lo half of one [16, 3, 10] tensor against the hi half of
    another, as the bind and the primary round hand them to K10."""
    jspec, tspec, (ja, jb), (ta, tb) = _halves(name, 6)
    assert not ta.is_contiguous() and not tb.is_contiguous()
    jf, tf = getattr(jfd, op), getattr(tfd, op)
    if op == "fneg":
        _same(jf(jspec, jnp.asarray(jb)), tf(tspec, tb))
    else:
        _same(jf(jspec, jnp.asarray(ja), jnp.asarray(jb)), tf(tspec, ta, tb))


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("op", ["fadd", "fsub"])
def test_addsub_broadcast_scalar_on_either_side(name, op):
    """A stride-0 constant [16, 1, 1] (DevF's coerced scalars) on the left
    and on the right of a [16, 3, 5] half."""
    jspec, tspec, (ja, _), (ta, _) = _halves(name, 7)
    s = ja[:, 1:2, 2:3]
    js = jnp.broadcast_to(jnp.asarray(s), ja.shape)
    ts = limbs_from_numpy(np.ascontiguousarray(s))
    jf, tf = getattr(jfd, op), getattr(tfd, op)
    _same(jf(jspec, jnp.asarray(ja), js), tf(tspec, ta, ts))
    _same(jf(jspec, js, jnp.asarray(ja)), tf(tspec, ts, ta))


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("n", [1, 3, 257])
def test_fsum_lengths(name, n):
    """fsum over lengths 1, 3 (odd: jolt_tpu's halving carries a tail) and
    257 of a [16, 3, n] tensor, along its last axis and its first."""
    jspec, tspec, a, _ = _pair(name, (3, n), seed=8)
    a[:, 0, : min(n, 4)] = np.asarray(jspec.p_limbs, np.uint32)[:, None] - (
        np.arange(16) == 0)[:, None]                     # p - 1: carries
    for axis in (-1, 0):
        _same(jfd.fsum(jspec, jnp.asarray(a), axis=axis),
              tfd.fsum(tspec, limbs_from_numpy(a), axis))


def _flat_value(flat: np.ndarray, at: int, ls: int) -> int:
    return sum(int(flat[at + k * ls]) << (16 * k) for k in range(16))


_VIEWS = {                      # view of a [16, 4, 6] tensor, broadcast to
    "contiguous": (lambda t: t, (4, 6)),
    "lo half": (lambda t: t[..., :3], (4, 3)),
    "hi half": (lambda t: t[..., 3:], (4, 3)),
    "a column": (lambda t: t[:, :, 1:2], (4, 6)),
    "a row": (lambda t: t[:, 2:3, :], (4, 6)),
    "a scalar": (lambda t: t[:, 1:2, 4:5], (4, 6)),
    "a scalar, 3 axes": (lambda t: t[:, 1:2, 4:5, None], (2, 4, 5)),
    "transposed": (lambda t: t.transpose(1, 2), (6, 4)),
    "a plane": (lambda t: t[:, 1], (6,)),
    "an element": (lambda t: t[:, 0, 0], ()),
}


@pytest.mark.parametrize("view", _VIEWS)
def test_addsub_operand_strides_address_every_element(view):
    """K1 and K10 read limb k of element (bb, i) of an operand at ptr + bb*bs +
    i*es + k*ls: for each view the wrapper passes (halves, broadcasts,
    planes, transposes), those addresses hold the broadcast operand's
    limbs, element by element (a model of the kernel's loads)."""
    base = torch.arange(16 * 4 * 6, dtype=torch.int32).reshape(16, 4, 6)
    fn, logical = _VIEWS[view]
    t = fn(base)
    shape = torch.Size((16,) + logical)
    n = shape.numel() // 16
    s = shape[-1] if len(shape) > 1 else 1
    src, bs, ls, es = tfk._operand("test", t, shape, n)
    flat = torch.tensor([], dtype=torch.int32).set_(
        src.untyped_storage()).numpy()
    want = t.expand(shape).reshape(16, n)
    for e in range(n):
        bb, i = divmod(e, s)
        at = src.storage_offset() + bb * bs + i * es
        assert [int(flat[at + k * ls]) for k in range(16)] == \
            want[:, e].tolist(), (view, e)
    assert src.data_ptr() == t.data_ptr()              # no copy


def _thread_terms(plan, k0: int, k1: int, sub: int) -> list[int]:
    """The terms of [k0, k1) that K11's thread `sub` of a row reads
    (csrc/field_ops.cu thread_sum): with vec, quads from k0 + 4 sub by
    4 tpr, then the last (k1 - k0) % 4 terms one at a time; else k0 +
    sub by tpr."""
    ks = []
    if plan.vec:
        kq = k0 + ((k1 - k0) & ~3)
        for k in range(k0 + 4 * sub, kq, 4 * plan.tpr):
            ks += [k, k + 1, k + 2, k + 3]
        k0 = kq
    return ks + list(range(k0 + sub, k1, plan.tpr))


def _model_field_sum(v: torch.Tensor, rows, n, rs, ls, es, plan,
                     p) -> list[int]:
    """K11's loops in Python: segment seg covers chunk c of a tile of
    SUM_THREADS // tpr rows (32 across the rows), each row's terms split
    over its tpr threads (_thread_terms); the block sums each row's
    threads; with one chunk a tile it writes the rows' sums, else a
    partial a (row, chunk), and the last block of the tile (the chunks-th
    ticket) sums each row's partials over its tpr threads (j = sub, sub +
    tpr, ...).  Asserts that every term is read once, every partial
    written and read once inside sum_scratch's rows x chunks, the tickets
    inside its SUM_WAVE counters, and 16-byte loads at 16-byte
    boundaries."""
    flat = torch.tensor([], dtype=torch.int32).set_(
        v.untyped_storage()).numpy()
    off = v.storage_offset()
    per = tfk.SUM_THREADS // plan.tpr
    assert (per == 32) == plan.across
    assert 1 <= plan.blocks <= min(tfk.SUM_WAVE, plan.tiles * plan.chunks)
    assert plan.tiles * per >= rows > (plan.tiles - 1) * per
    if plan.chunks > 1:
        assert plan.tiles <= tfk.SUM_WAVE
    seen, partial, out = set(), {}, [None] * rows
    tickets = [0] * plan.tiles
    for seg in range(plan.tiles * plan.chunks):
        tile, c = divmod(seg, plan.chunks)
        k0, k1 = c * plan.chunk, min(c * plan.chunk + plan.chunk, n)
        assert k0 < k1
        live = [r for r in range(tile * per, tile * per + per) if r < rows]
        for r in live:
            total = 0
            for sub in range(plan.tpr):
                for k in _thread_terms(plan, k0, k1, sub):
                    assert k0 <= k < k1 and (r, k) not in seen
                    seen.add((r, k))
                    at = off + r * rs + k * es
                    if plan.vec and k % 4 == 0:
                        assert all((at + j * ls) % 4 == 0
                                   for j in range(16))
                    total += _flat_value(flat, at, ls)
            if plan.chunks == 1:
                out[r] = total % p
            else:
                assert (r, c) not in partial and r * plan.chunks + c < \
                    rows * plan.chunks
                partial[r, c] = total % p
        if plan.chunks > 1:
            tickets[tile] += 1
            if tickets[tile] == plan.chunks:       # the tile's last block
                for r in live:
                    out[r] = sum(partial.pop((r, j)) for sub in
                                 range(plan.tpr) for j in
                                 range(sub, plan.chunks, plan.tpr)) % p
    assert len(seen) == rows * n and not partial
    assert all(t == plan.chunks for t in tickets) or plan.chunks == 1
    return out


def _plans(rows, n, across, vec):
    """The wrapper's plan, and the same layout cut into one segment a tile
    and into segments of one term a thread (4 with vec)."""
    plan = tfk.sum_plan(rows, n, across, vec)
    least = (4 if plan.vec else 1) * plan.tpr
    yield plan
    for chunk in (-(-n // 4) * 4 if plan.vec else n, least):
        chunks = -(-n // chunk)
        yield plan._replace(chunk=chunk, chunks=chunks, blocks=min(
            tfk.SUM_WAVE, plan.tiles * chunks))


@pytest.mark.parametrize("shape,axis", [
    ((2, 300), -1), ((40, 9), 0), ((3, 4, 5), 1), ((70, 2), -1), ((1,), 0),
    ((33, 1), -1),
    ((3,), -1),              # one block, one warp a row
    ((2048,), -1),           # one block, 256 threads a row
    ((2 * tfk.SUM_WAVE * 8, 3), -1),   # exactly one wave of tiles
    ((20, 40), 0),           # across the rows, the terms over 8 warps
    ((300, 33), 0),          # across, a tile's terms cut into segments
    ((8, 4, 11), 0),         # across (rows 44), a middle view made whole
    ((5, 2051), -1)])        # 16-byte loads, a row's last 3 terms alone
def test_field_sum_plan_covers_every_term(shape, axis):
    """K11's wrapper math: the summed axis moved last as a view, its rows'
    stride, the layout (along or across the rows), the 16-byte loads and
    sum_plan's cut; the model of the kernel's loops reads every term once
    and gives the plain version's sums."""
    tspec = SPECS["fr"][1]
    rng = np.random.default_rng(len(shape) + shape[0])
    a = _rand_field(rng, tspec.p, shape)
    t = limbs_from_numpy(a)
    v, rows, n, rs, ls, es = tfk.sum_view(
        t, axis + 1 if axis >= 0 else axis + t.dim())
    across = rows >= 32 and es != 1
    want = tfd.unpack_ints(tfk.field_sum_plain(tspec, t, axis).numpy())
    vecs = {tfk.sum_vec(v, rows, rs, ls, es, across), False}
    for vec in vecs:
        for plan in _plans(rows, n, across, vec):
            assert (plan.chunks - 1) * plan.chunk < n <= \
                plan.chunks * plan.chunk
            got = _model_field_sum(v, rows, n, rs, ls, es, plan, tspec.p)
            assert got == [int(w) for w in np.ravel(want)]


def test_field_sum_vec_needs_alignment():
    """16-byte loads only where every row and limb starts at a 16-byte
    boundary and the terms are unit stride: not on a view one element
    in, nor along a row stride of 6, nor across the rows."""
    t = torch.zeros((16, 6, 8), dtype=torch.int32)
    u = torch.zeros((16, 4, 6), dtype=torch.int32)
    for view, ax, want in ((t, 2, True), (t[..., 1:5], 2, False),
                           (t[..., :4], 2, True), (t[:, :, :6], 2, True),
                           (u, 2, False), (t[:, 0], 1, True),
                           (t, 1, False)):
        v, rows, n, rs, ls, es = tfk.sum_view(view, ax)
        across = rows >= 32 and es != 1
        assert tfk.sum_vec(v, rows, rs, ls, es, across) == want, (
            view.shape, view.stride(), ax)


@pytest.mark.parametrize("rows,n,across,vec", [
    (1, 1, False, False), (1, 127, False, True), (1, 1 << 15, False, True),
    (1, 1 << 20, False, True), (55, 1 << 15, False, True),
    (1 << 15, 110, True, False), (1 << 16, 55, True, False),
    (31, 4, False, False), (4224, 3, False, False), (4300, 2, True, False),
    (1 << 20, 1, True, False),
    (1, 3, False, False),                              # one block
    (1, tfk.SUM_WAVE * tfk.SUM_MIN_TERMS * 256, False, True),  # one wave
    (1, tfk.SUM_WAVE * tfk.SUM_MIN_TERMS * 256 + 1, False, False),
    (tfk.SUM_WAVE * 32, 7, True, False),               # a wave of tiles
    (33, 300, True, False), (32, 1 << 20, True, False),  # across, cut
    (1, 1 << 23, False, True)])
def test_sum_plan_bounds(rows, n, across, vec):
    """sum_plan's cut covers each row with non-empty chunks (multiples of
    4 with 16-byte loads, which start at SUM_VEC_MIN terms), gives a row
    a power of two of threads (8 warps across the rows), cuts a tile's
    terms only while its tickets fit the counters (SUM_WAVE words) and
    each thread keeps at least half of SUM_MIN_TERMS terms, and launches
    at most one wave."""
    plan = tfk.sum_plan(rows, n, across, vec)
    chunk, chunks = plan.chunk, plan.chunks
    assert chunk >= 1 and (chunks - 1) * chunk < n <= chunks * chunk
    if across:
        assert plan.tpr == tfk.SUM_THREADS // 32
    else:
        assert plan.tpr in (32, 64, 128, 256)
    per = tfk.SUM_THREADS // plan.tpr
    assert plan.tiles == -(-rows // per)
    assert plan.blocks == min(tfk.SUM_WAVE, plan.tiles * chunks)
    if chunks > 1:
        assert plan.tiles < tfk.SUM_WAVE
        assert plan.tiles * chunks < 2 * tfk.SUM_WAVE
        assert 2 * chunk >= tfk.SUM_MIN_TERMS * plan.tpr
    assert plan.vec == (vec and n >= tfk.SUM_VEC_MIN)
    if plan.vec:
        assert chunk % 4 == 0
    if rows == 1 and n >= tfk.SUM_WAVE * tfk.SUM_MIN_TERMS * 256:
        assert chunks == tfk.SUM_WAVE == plan.blocks     # one full wave


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("view", ["whole", "lo half", "hi half, odd",
                                  "leading axis", "a plane"])
def test_strided_copy_keeps_k11_plan(view):
    """chip_smoke.py's strided_copy, which keeps every K11 call of a prove
    for its replay: the copy holds the same values with the same strides
    and offset mod 16 bytes, so K11's view, layout, 16-byte loads and
    plan are those of the call it copies."""
    t = torch.arange(16 * 6 * 10, dtype=torch.int32).reshape(16, 6, 10)
    a, ax = {"whole": (t, 2), "lo half": (t[..., :5], 2),
             "hi half, odd": (t[..., 3:], 2), "leading axis": (t, 1),
             "a plane": (t[:, 1], 1)}[view]
    c = _chip_smoke().strided_copy(a)
    assert torch.equal(c, a) and c.stride() == a.stride()
    assert c.storage_offset() % 4 == a.storage_offset() % 4
    plans = []
    for x in (a, c):
        v, rows, n, rs, ls, es = tfk.sum_view(x, ax)
        across = rows >= 32 and es != 1
        vec = tfk.sum_vec(v, rows, rs, ls, es, across)
        plans.append(((rows, n, rs, ls, es), tfk.sum_plan(rows, n, across,
                                                          vec)))
    assert plans[0] == plans[1]
