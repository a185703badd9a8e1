"""The port's field arithmetic (jolt_tpu_torch.field) against jolt_tpu's.

The same limbs, made with numpy from a seed, go through jolt_tpu's XLA
path on the CPU and through the port on the CPU (the kernels' plain
versions).  Every comparison is of integer limbs: the tolerance is zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from jolt_tpu.field import device as jfd
from jolt_tpu.field import fq_spec as jfq_spec
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from jolt_tpu_torch.field import device as tfd
from jolt_tpu_torch.field import kernels as tfk
from jolt_tpu_torch.field.spec import fq_spec, fr_spec

SPECS = {"fr": (jfr_spec(), fr_spec()), "fq": (jfq_spec(), fq_spec())}


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
