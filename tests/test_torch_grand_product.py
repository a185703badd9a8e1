"""The port's batched GKR grand product against jolt_tpu's.

The round functions (the K2, K3 and K4 kernels' plain versions on the CPU)
are compared limb for limb with jolt_tpu's non-Pallas branches; a whole
prove is compared by its transcript, and jolt_tpu's verifier must accept
the port's proof.  The tolerance is zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from jolt_tpu.field import FElt as JFElt
from jolt_tpu.field import device as jfd
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.poly.unipoly import CompressedUniPoly as JCompressedUniPoly
from jolt_tpu.subprotocols import grand_product as jgp
from jolt_tpu.subprotocols.sumcheck import \
    SumcheckInstanceProof as JSumcheckInstanceProof
from jolt_tpu.transcript import Transcript as JTranscript
from jolt_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from jolt_tpu_torch.field import device as tfd
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.subprotocols import grand_product as tgp
from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
from jolt_tpu_torch.transcript import Transcript

JFR, FR = jfr_spec(), fr_spec()
B = 8


def _mont_limbs(rng, shape):
    """Random Montgomery Fr limbs uint32[16, *shape] (any residue below p
    is a Montgomery form)."""
    n = int(np.prod(shape))
    words = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64)
    vals = [sum(int(w) << (64 * k) for k, w in enumerate(row)) % JFR.p
            for row in words]
    return jfd.pack_ints(vals, shape)


def _round_inputs(s, seed):
    rng = np.random.default_rng(seed)
    l = np.ascontiguousarray(np.moveaxis(_mont_limbs(rng, (B, s)), 0, 1))
    r = np.ascontiguousarray(np.moveaxis(_mont_limbs(rng, (B, s)), 0, 1))
    return l, r, _mont_limbs(rng, (s,)), _mont_limbs(rng, (B,))


def _same(jax_outs, torch_outs):
    for want, got in zip(jax_outs, torch_outs):
        assert (limbs_to_numpy(got) == np.asarray(want)).all()


@pytest.mark.parametrize("s", [2, 64])
def test_pair_cubic_evals(s):
    l, r, eq, coeffs = _round_inputs(s, s)
    want = jgp._pair_cubic_evals(JFR, *map(jnp.asarray, (l, r, eq, coeffs)))
    got = tgp._pair_cubic_evals(FR, *map(limbs_from_numpy, (l, r, eq, coeffs)))
    _same([want], [got])


@pytest.mark.parametrize("s", [2, 64])
def test_pair_bind(s):
    l, r, eq, _ = _round_inputs(s, s + 1)
    chal = 0x1234567 ** 9 % JFR.p
    want = jgp._pair_bind(JFR, *map(jnp.asarray, (l, r, eq)),
                          jfd.scalar_to_device(JFR, chal))
    got = tgp._pair_bind(FR, *map(limbs_from_numpy, (l, r, eq)),
                         tfd.scalar_to_device(FR, chal, "cpu"))
    _same(want, got)


@pytest.mark.parametrize("s", [2, 64])
def test_pair_tree_level(s):
    l, r, _, _ = _round_inputs(s, s + 2)
    want = jgp._pair_tree_level(JFR, jnp.asarray(l), jnp.asarray(r))
    got = tgp._pair_tree_level(FR, limbs_from_numpy(l), limbs_from_numpy(r))
    _same(want, got)


def to_jax_gp_proof(proof):
    """The port's grand-product proof as jolt_tpu dataclasses."""
    jf = lambda x: JFElt(x.v, JFR)
    return jgp.BatchedGrandProductProof([
        jgp.BatchedGrandProductLayerProof(
            JSumcheckInstanceProof([
                JCompressedUniPoly([jf(c) for c in p.coeffs_except_linear_term])
                for p in lp.proof.compressed_polys]),
            [jf(x) for x in lp.left_claims],
            [jf(x) for x in lp.right_claims])
        for lp in proof.layers])


def _prove_both():
    leaves = _mont_limbs(np.random.default_rng(7), (B, 64))   # [16, 8, 64]
    jgp_ = jgp.BatchedDenseGrandProduct.construct(jnp.asarray(leaves), JFR)
    tgp_ = tgp.BatchedDenseGrandProduct.construct(limbs_from_numpy(leaves), FR)
    claims = tgp_.claims()
    assert [c.v for c in claims] == [c.v for c in jgp_.claims()]
    jt = JTranscript(b"gp")
    jproof, jr = jgp_.prove(jt)
    tt = Transcript(b"gp")
    tproof, tr = tgp_.prove(tt)
    return (jproof, jr, jt), (tproof, tr, tt, claims)


def test_batched_dense_grand_product_matches_jolt_tpu():
    (jproof, jr, jt), (tproof, tr, tt, claims) = _prove_both()
    assert tt.state_history == jt.state_history
    assert [x.v for x in tr] == [x.v for x in jr]
    assert len(tproof.layers) == len(jproof.layers)
    for tl, jl in zip(tproof.layers, jproof.layers):
        assert [x.v for x in tl.left_claims] == [x.v for x in jl.left_claims]
        assert [x.v for x in tl.right_claims] == [x.v for x in jl.right_claims]

    # jolt_tpu's verifier accepts the port's proof, event for event
    vt = JTranscript(b"gp")
    vt.compare_to(tt)
    jclaims = [JFElt(c.v, JFR) for c in claims]
    _, r_verify = jgp.verify_grand_product(to_jax_gp_proof(tproof), jclaims, vt)
    assert [x.v for x in r_verify] == [x.v for x in tr]


def test_port_verifier_accepts_and_rejects():
    _, (tproof, tr, tt, claims) = _prove_both()
    vt = Transcript(b"gp")
    vt.compare_to(tt)
    _, r_verify = tgp.verify_grand_product(tproof, claims, vt)
    assert [x.v for x in r_verify] == [x.v for x in tr]
    lc = tproof.layers[-1].left_claims
    lc[0] = lc[0] + FElt(1, FR)
    with pytest.raises(VerificationError):
        tgp.verify_grand_product(tproof, claims, Transcript(b"gp"))
