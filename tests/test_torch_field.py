"""The port's field arithmetic (jolt_tpu_torch.field) against jolt_tpu's.

The same limbs, made with numpy from a seed, go through jolt_tpu's XLA
path on the CPU and through the port on the CPU (the kernels' plain
versions).  Every comparison is of integer limbs: the tolerance is zero.
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
