"""The port's G1 point ops, SRS generation and batch commit against jolt_tpu.

Points come from the committed SRS fixture (Montgomery Jacobian Fq limbs);
scalars from numpy's default_rng.  Point ops are compared limb for limb
with jolt_tpu's XLA path on the CPU; SRS points with the fixture itself;
commitments with jolt_tpu's host MSM.  The tolerance is zero.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from jolt_tpu.curve import device as jcd
from jolt_tpu.curve.bn254 import G1Jacobian as JG1Jacobian
from jolt_tpu.curve.bn254 import g1_msm_host
from jolt_tpu.field import device as jfd
from jolt_tpu.field import fq_spec as jfq_spec
from jolt_tpu_torch.commitment.kzg import kzg_commit_batch, srs_generate
from jolt_tpu_torch.convert import (limbs_from_numpy, limbs_to_numpy,
                                    prover_key_from_numpy)
from jolt_tpu_torch.curve import kernels as tck
from jolt_tpu_torch.field import device as tfd
from jolt_tpu_torch.field.spec import fr_spec

FIXTURE = Path(__file__).resolve().parents[1] / "fixtures" / "srs" / \
    "srs_8192_6a6f6c74.npz"
FQ = jfq_spec()
N = 40          # points per batch: below the Pallas kernels' 256


def _fixture():
    with np.load(FIXTURE) as z:
        return tuple(z[k] for k in ("X", "Y", "Z"))


def _mont(vals):
    return jfd.pack_ints([FQ.to_mont(v % FQ.p) for v in vals])


def _host_jac(X, Y, Z):
    """Montgomery limb columns -> jolt_tpu host Jacobian points."""
    xs, ys, zs = (jfd.unpack_ints(t) for t in (X, Y, Z))
    return [JG1Jacobian(FQ.from_mont(int(a)), FQ.from_mont(int(b)),
                        FQ.from_mont(int(c))) for a, b, c in zip(xs, ys, zs)]


def _jac_operands():
    """(P1, P2) of N Jacobian points each, with the special cases of
    `_jac_add_core`: doubling (same representation and a rescaled one),
    inverse, P2 at infinity, P1 at infinity, both at infinity."""
    X, Y, Z = (t[:, :2 * N].copy() for t in _fixture())
    p1 = [t[:, :N].copy() for t in (X, Y, Z)]
    p2 = [t[:, N:].copy() for t in (X, Y, Z)]
    for k in range(3):
        p2[k][:, 0] = p1[k][:, 0]                       # doubling
    pt = _host_jac(*(t[:, 1:2] for t in p1))[0]
    lam = 7
    scaled = [pt.x * lam ** 2, pt.y * lam ** 3, pt.z * lam]
    for k in range(3):
        p2[k][:, 1] = _mont([scaled[k]])[:, 0]          # doubling, rescaled
        p2[k][:, 2] = p1[k][:, 2]
    p2[1][:, 2] = np.asarray(jfd.fneg(FQ, jnp.asarray(p1[1][:, 2])))  # -P1
    p2[2][:, 3] = 0                                     # P2 at infinity
    p1[2][:, 4] = 0                                     # P1 at infinity
    p1[2][:, 5] = p2[2][:, 5] = 0                       # both
    return tuple(p1), tuple(p2)


def _same(jax_pts, torch_pts):
    for want, got in zip(jax_pts, torch_pts):
        assert (limbs_to_numpy(got) == np.asarray(want)).all()


def test_jac_add_matches_jolt_tpu():
    p1, p2 = _jac_operands()
    want = jcd.jac_add(tuple(map(jnp.asarray, p1)), tuple(map(jnp.asarray, p2)))
    got = tck.jac_add(tuple(map(limbs_from_numpy, p1)),
                      tuple(map(limbs_from_numpy, p2)))
    _same(want, got)
    # and the group law itself, on the host
    h1, h2 = _host_jac(*p1), _host_jac(*p2)
    hout = _host_jac(*(limbs_to_numpy(t) for t in got))
    for a, b, c in zip(h1, h2, hout):
        assert a.add(b).to_affine() == c.to_affine()


def test_proj_cadd_matches_jolt_tpu():
    """Complete projective add, identity (0:1:0), doubling and inverse."""
    p1, p2 = _jac_operands()
    proj = []
    for X, Y, Z in (p1, p2):
        PX, PZ = jcd._proj_from_jac(jnp.asarray(X), jnp.asarray(Z))
        proj.append([np.array(PX), Y.copy(), np.array(PZ)])
    one = np.asarray(FQ.r_limbs, dtype=np.uint32)
    for q in proj:                                      # Z = 0 -> (0:1:0)
        inf = (q[2] == 0).all(axis=0)
        q[0][:, inf] = 0
        q[1][:, inf] = one[:, None]
    q1, q2 = tuple(proj[0]), tuple(proj[1])
    want = jcd.proj_cadd(tuple(map(jnp.asarray, q1)),
                         tuple(map(jnp.asarray, q2)))
    got = tck.proj_cadd(tuple(map(limbs_from_numpy, q1)),
                        tuple(map(limbs_from_numpy, q2)))
    _same(want, got)


def test_srs_generation_matches_fixture():
    """The port's SRS generation (powers of tau, fixed-base table gather,
    the Jacobian-add tree of K6's plain version) makes the fixture's first
    64 points bit for bit."""
    got = srs_generate(64, "cpu")
    for t, want in zip(got, _fixture()):
        assert (limbs_to_numpy(t) == want[:, :64]).all()


@pytest.mark.parametrize("n", [16, 5])
def test_kzg_commit_batch_matches_host_msm(n):
    """Full-width scalars, small scalars and a zero vector, committed in
    one batch over the fixture's points, against jolt_tpu's host MSM."""
    X, Y, Z = (t[:, :16] for t in _fixture())
    pk = prover_key_from_numpy(X, Y, Z)
    rng = np.random.default_rng(n)
    fr = fr_spec()
    vectors = [[int(v) for v in rng.integers(0, 1 << 62, n)],
               [int(v) for v in rng.integers(0, 1 << 9, n)],
               [0] * n]
    vectors[0] = [v * (fr.p // (1 << 62)) % fr.p for v in vectors[0]]
    polys = [tfd.ints_to_device(fr, v, "cpu") for v in vectors]
    got = kzg_commit_batch(pk, polys)
    points = [p.to_affine() for p in _host_jac(X, Y, Z)][:n]
    for c, v in zip(got, vectors):
        want = g1_msm_host(points, v)
        assert c.is_infinity == want.is_infinity
        assert c.is_infinity or (c.x, c.y) == (want.x, want.y)
