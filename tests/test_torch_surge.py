"""The port's Surge prover and verifier against jolt_tpu's.

jolt_tpu's own small sizes (tests/test_surge.py): XOR lookups with C = 2
chunks into M = 16-entry subtables, 13 operations (padded to 16).  The
port proves with HyperKZG over the committed SRS fixture; jolt_tpu with
its mock PCS, since Surge appends no commitment to the transcript.  The
transcripts must be equal event for event, the port's commitments must
equal jolt_tpu's host MSM, each package's verifier must accept the port's
proof, and the port's arkworks proof bytes must equal jolt_tpu's
serialize_surge_proof of the same proof.  The tolerance is zero.
"""
import dataclasses

import numpy as np
import pytest
import torch

from jolt_tpu.commitment import MockCommitmentScheme
from jolt_tpu.commitment.hyperkzg import HyperKZGCommitment as JCommitment
from jolt_tpu.curve.bn254 import G1Affine as JG1Affine
from jolt_tpu.curve.bn254 import G1Jacobian as JG1Jacobian
from jolt_tpu.curve.bn254 import g1_msm_host
from jolt_tpu.field import FElt as JFElt
from jolt_tpu.field import device as jfd
from jolt_tpu.field import fq_spec as jfq_spec
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.instructions import XorInstruction as JXor
from jolt_tpu.lasso import surge as jsurge
from jolt_tpu.lasso import memory_checking as jmc
from jolt_tpu.poly.unipoly import CompressedUniPoly as JCompressedUniPoly
from jolt_tpu.subprotocols import grand_product as jgp
from jolt_tpu.subprotocols.sumcheck import \
    SumcheckInstanceProof as JSumcheckInstanceProof
from jolt_tpu.utils.ark_proof import \
    serialize_surge_proof as j_serialize_surge_proof
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
from jolt_tpu_torch.convert import limbs_to_numpy
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.instructions import XorInstruction
from jolt_tpu_torch.lasso import SurgePreprocessing, surge_prove, surge_verify
from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
from jolt_tpu_torch.utils.ark_proof import serialize_surge_proof

JFR, JFQ = jfr_spec(), jfq_spec()
C, M, N_OPS = 2, 16, 13


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(123)
    x = rng.integers(0, M, size=N_OPS, dtype=np.uint64)
    y = rng.integers(0, M, size=N_OPS, dtype=np.uint64)
    return x, y


@pytest.fixture(scope="module")
def proofs():
    x, y = _inputs()
    jpre = jsurge.SurgePreprocessing(JXor, C, M, JFR)
    jproof, jt, _ = jsurge.surge_prove(jpre, MockCommitmentScheme(JFR), x, y)
    pre = SurgePreprocessing(XorInstruction, C, M, device="cpu")
    pcs = HyperKZG.setup(M, device="cpu")
    proof, tt, _ = surge_prove(pre, pcs, x, y)
    return dict(jpre=jpre, jproof=jproof, jt=jt, pre=pre, pcs=pcs,
                proof=proof, tt=tt)


def _jf(x):
    return JFElt(x.v, JFR)


def _jvals(xs):
    return [_jf(x) for x in xs]


def _to_jax_gp_proof(proof):
    return jgp.BatchedGrandProductProof([
        jgp.BatchedGrandProductLayerProof(
            _to_jax_sumcheck(lp.proof), _jvals(lp.left_claims),
            _jvals(lp.right_claims))
        for lp in proof.layers])


def _to_jax_sumcheck(proof):
    return JSumcheckInstanceProof([
        JCompressedUniPoly(_jvals(p.coeffs_except_linear_term))
        for p in proof.compressed_polys])


def _to_jax_commitment(c):
    p = c.point
    return JCommitment(JG1Affine(p.x, p.y, p.is_infinity))


def to_jax_surge_proof(proof):
    """The port's Surge proof rebuilt as jolt_tpu dataclasses."""
    ps, mc = proof.primary_sumcheck, proof.memory_checking
    h = mc.multiset_hashes
    return jsurge.SurgeProof(
        [_to_jax_commitment(c) for c in proof.commitments],
        [_to_jax_commitment(c) for c in proof.final_commitments],
        jsurge.SurgePrimarySumcheck(
            _to_jax_sumcheck(ps.sumcheck_proof), ps.num_rounds,
            _jf(ps.claimed_evaluation), _jvals(ps.E_poly_openings)),
        jmc.MemoryCheckingProof(
            jmc.MultisetHashes(_jvals(h.read_hashes), _jvals(h.write_hashes),
                               _jvals(h.init_hashes), _jvals(h.final_hashes)),
            _to_jax_gp_proof(mc.read_write_grand_product),
            _to_jax_gp_proof(mc.init_final_grand_product)),
        proof.C, proof.M)


def test_surge_transcript_matches_jolt_tpu(proofs):
    assert proofs["tt"].state_history == proofs["jt"].state_history
    ps, jps = proofs["proof"].primary_sumcheck, proofs["jproof"].primary_sumcheck
    assert ps.claimed_evaluation.v == jps.claimed_evaluation.v
    assert [x.v for x in ps.E_poly_openings] == \
        [x.v for x in jps.E_poly_openings]


def test_surge_commitments_match_host_msm(proofs):
    """Every commitment of the port's proof against jolt_tpu's host MSM of
    jolt_tpu's own witness over the same SRS points."""
    X, Y, Z = (jfd.unpack_ints(limbs_to_numpy(t))
               for t in proofs["pcs"].pk.g1_jac)
    points = [JG1Jacobian(JFQ.from_mont(int(a)), JFQ.from_mont(int(b)),
                          JFQ.from_mont(int(c))).to_affine()
              for a, b, c in zip(X, Y, Z)]
    polys, _ = jsurge.generate_witness(proofs["jpre"], *_inputs())
    vectors = polys.read_write_values() + polys.init_final_values()
    proof = proofs["proof"]
    commitments = proof.commitments + proof.final_commitments
    assert len(commitments) == len(vectors) == 3 * C + C
    for c, v in zip(commitments, vectors):
        scalars = [int(s) for s in jfd.device_to_ints(JFR, v)]
        want = g1_msm_host(points[:len(scalars)], scalars)
        assert c.point.is_infinity == want.is_infinity
        assert c.point.is_infinity or (c.point.x, c.point.y) == (want.x, want.y)


def test_jolt_tpu_verifier_accepts_port_proof(proofs):
    jsurge.surge_verify(proofs["jpre"], MockCommitmentScheme(JFR),
                        to_jax_surge_proof(proofs["proof"]),
                        debug_transcript=proofs["jt"])


def test_port_verifier_accepts_and_rejects_tampered(proofs):
    surge_verify(proofs["pre"], proofs["proof"], debug_transcript=proofs["tt"])
    proof = proofs["proof"]
    ps = proof.primary_sumcheck
    bad = dataclasses.replace(proof, primary_sumcheck=dataclasses.replace(
        ps, claimed_evaluation=ps.claimed_evaluation + FElt(1, fr_spec())))
    with pytest.raises(VerificationError):
        surge_verify(proofs["pre"], bad)


def test_surge_proof_bytes_match_jolt_tpu(proofs):
    """The arkworks SurgeProof bytes (the bench's proof size) of the port's
    proof, against jolt_tpu's serializer on the same proof rebuilt as
    jolt_tpu dataclasses (whose transcript equals jolt_tpu's own proof's)."""
    proof, pre = proofs["proof"], proofs["pre"]
    data = serialize_surge_proof(proof, pre.num_memories)
    assert data == j_serialize_surge_proof(to_jax_surge_proof(proof),
                                           proofs["jpre"].num_memories)
    # 4C compressed points and their four Vec lengths come first
    assert data[:8] == C.to_bytes(8, "little")
    assert len(data) > 32 * 4 * C
    with pytest.raises(ValueError):
        serialize_surge_proof(proof, pre.num_memories + 1)
