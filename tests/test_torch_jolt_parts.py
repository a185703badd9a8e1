"""Parts of the port's Jolt VM prover against jolt_tpu's, live and small.

Each test feeds the same numpy-seeded field elements to jolt_tpu (on the
CPU, its XLA path) and to the port's CPU path, and compares transcripts
(state_history), proof values and points for equality:

- the toggled grand product (Lasso's flag-gated read/write multisets),
  proved by both and verified by the port;
- the batched opening reduction (`reduce_and_prove`) with the mock PCS;
- HyperKZG's opening at ell = 6, whose proof jolt_tpu's verifier accepts,
  and the univariate KZG opening, evaluation and pairing check under it;
- the MLE helpers and the sumcheck's product combiner;
- Spartan's key digest, in the default mode and under
  JOLT_REFERENCE_PARITY=1.

The tolerance is zero.
"""
import numpy as np
import pytest
import torch

from jolt_tpu.commitment import MockCommitmentScheme as JMock
from jolt_tpu.commitment.hyperkzg import HyperKZG as JHyperKZG
from jolt_tpu.commitment.hyperkzg import HyperKZGCommitment as JCommitment
from jolt_tpu.commitment.hyperkzg import HyperKZGProof as JHyperKZGProof
from jolt_tpu.commitment import kzg as jkzg
from jolt_tpu.curve.bn254 import G1Affine as JG1Affine
from jolt_tpu.field import FElt as JFElt
from jolt_tpu.field import device as jfd
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.poly import mle as jmle
from jolt_tpu.poly.opening_proof import \
    ProverOpeningAccumulator as JProverAccumulator
from jolt_tpu.subprotocols import grand_product as jgp
from jolt_tpu.subprotocols import sumcheck as jsumcheck
from jolt_tpu.transcript import Transcript as JTranscript
from jolt_tpu.utils.math import log2_strict
from jolt_tpu.vm import r1cs as jr1cs
from jolt_tpu.vm.rv_trace import RAM_START_ADDRESS
from jolt_tpu_torch.commitment import kzg
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.poly import mle
from jolt_tpu_torch.poly.opening_proof import (ProverOpeningAccumulator,
                                               VerifierOpeningAccumulator)
from jolt_tpu_torch.subprotocols import grand_product as gp
from jolt_tpu_torch.subprotocols import sumcheck
from jolt_tpu_torch.transcript import Transcript
from jolt_tpu_torch.instructions import AddInstruction, BneInstruction
from jolt_tpu_torch.vm import r1cs
from jolt_tpu_torch.vm.rv32i_vm import mini_vm

FR, JFR = fr_spec(), jfr_spec()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(rng, *shape):
    """Uniform field elements as Python ints (numpy object array)."""
    hi = rng.integers(0, 1 << 62, size=shape + (4,), dtype=np.uint64)
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        w = [int(x) for x in hi[idx]]
        out[idx] = (w[0] | w[1] << 62 | w[2] << 124 | w[3] << 186) % FR.p
    return out


def _both(vals):
    """Montgomery limbs of `vals` for jolt_tpu (jnp) and the port (torch)."""
    return (jfd.ints_to_device(JFR, vals.tolist()),
            fd.ints_to_device(FR, vals.tolist(), "cpu"))


def _jvals(xs):
    return [x.v for x in xs]


def _limbs_equal(port: torch.Tensor, jax_arr) -> bool:
    return np.array_equal(port.numpy().astype(np.uint32),
                          np.asarray(jax_arr).astype(np.uint32))


# ---------------------------------------------------------------------------
# toggled grand product
# ---------------------------------------------------------------------------

def test_toggled_grand_product_matches_jolt_tpu():
    rng = np.random.default_rng(5)
    m, T = 3, 16
    bits = rng.integers(0, 2, size=(m, T)).astype(bool)
    jfps, fps = _both(_ints(rng, 2 * m, T))

    jcirc = jgp.ToggledBatchedGrandProduct(bits, jfps, JFR)
    jclaims = jcirc.claims()
    jt = JTranscript(b"toggled")
    jproof, jr = jcirc.prove(jt)

    circ = gp.ToggledBatchedGrandProduct(torch.from_numpy(bits), fps, FR)
    claims = circ.claims()
    assert _jvals(claims) == _jvals(jclaims)
    tt = Transcript(b"toggled")
    proof, r = circ.prove(tt)
    assert tt.state_history == jt.state_history
    assert _jvals(r) == _jvals(jr)
    for lp, jlp in zip(proof.layers, jproof.layers, strict=True):
        assert _jvals(lp.left_claims) == _jvals(jlp.left_claims)
        assert _jvals(lp.right_claims) == _jvals(jlp.right_claims)

    vt = Transcript(b"toggled")
    vt.compare_to(tt)
    finals, rv = gp.verify_grand_product(
        proof, claims, vt,
        verify_sumcheck_claim=gp.toggled_verify_sumcheck_claim)
    assert _jvals(rv) == _jvals(r)
    bad = proof.layers[-1].right_claims
    bad[0] = bad[0] + FElt(1, FR)
    with pytest.raises(gp.VerificationError):
        gp.verify_grand_product(
            proof, claims, Transcript(b"toggled"),
            verify_sumcheck_claim=gp.toggled_verify_sumcheck_claim)


# ---------------------------------------------------------------------------
# opening reduction with the mock PCS
# ---------------------------------------------------------------------------

def _accumulate(rng, sizes):
    """The same openings appended to jolt_tpu's and the port's accumulator:
    for each ell in `sizes`, two random polys of 2^ell opened at a random
    point.  Returns (jacc, jt, acc, tt, the groups as host values)."""
    jacc, jt = JProverAccumulator(JFR), JTranscript(b"openings")
    acc, tt = ProverOpeningAccumulator(FR), Transcript(b"openings")
    groups = []
    for ell in sizes:
        point = [int(x) for x in _ints(rng, ell)]
        vals = _ints(rng, 2, 1 << ell)
        jpolys, polys = _both(vals)
        claims = [mle.evaluate_host([FElt(int(v), FR) for v in row],
                                    [FElt(x, FR) for x in point])
                  for row in vals]
        jacc.append([jpolys[:, i] for i in range(2)],
                    jmle.eq_evals_device(JFR, point), [JFElt(x, JFR)
                                                       for x in point],
                    [JFElt(c.v, JFR) for c in claims], jt)
        acc.append([polys[:, i] for i in range(2)],
                   mle.eq_evals_device(FR, point, "cpu"),
                   [FElt(x, FR) for x in point], claims, tt)
        groups.append((polys, point, claims))
    return jacc, jt, acc, tt, groups


def test_reduce_and_prove_matches_jolt_tpu():
    rng = np.random.default_rng(9)
    jacc, jt, acc, tt, groups = _accumulate(rng, (3, 2, 3))
    jred = jacc.reduce_and_prove(JMock(JFR), jt)
    pcs = MockCommitmentScheme(FR)
    red = acc.reduce_and_prove(pcs, tt)
    assert tt.state_history == jt.state_history
    assert _jvals(red.sumcheck_claims) == _jvals(jred.sumcheck_claims)

    vt = Transcript(b"openings")
    vt.compare_to(tt)
    vacc = VerifierOpeningAccumulator(pcs, FR)
    vacc.compare_to(acc)
    for polys, point, claims in groups:
        vacc.append(pcs.batch_commit([polys[:, i] for i in range(2)]),
                    [FElt(x, FR) for x in point], claims, vt)
    vacc.reduce_and_verify(pcs, red, vt)


# ---------------------------------------------------------------------------
# HyperKZG opening, ell = 6
# ---------------------------------------------------------------------------

ELL = 6


def _jpoint(p):
    return JG1Affine(p.x, p.y, p.is_infinity)


@pytest.fixture(scope="module")
def pcs_pair():
    """jolt_tpu's and the port's HyperKZG over the same 2^6-point SRS."""
    return JHyperKZG.setup(1 << ELL), HyperKZG.setup(1 << ELL, device="cpu")


def test_hyperkzg_prove_matches_jolt_tpu_and_verifies_there(pcs_pair):
    ell = ELL
    rng = np.random.default_rng(13)
    vals = _ints(rng, 1 << ell)
    point = [int(x) for x in _ints(rng, ell)]
    jpoly, poly = _both(vals)
    jpcs, pcs = pcs_pair
    for k in ("g1", "g2", "beta_g2"):
        a, b = getattr(pcs.vk, k), getattr(jpcs.vk, k)
        assert (a.x, a.y) == (b.x, b.y)

    jt, tt = JTranscript(b"hyperkzg"), Transcript(b"hyperkzg")
    jproof = jpcs.prove(jpoly, [JFElt(x, JFR) for x in point], jt)
    proof = pcs.prove(poly, [FElt(x, FR) for x in point], tt)
    assert tt.state_history == jt.state_history
    assert proof.com == jproof.com and proof.w == jproof.w
    assert [_jvals(row) for row in proof.v] == [_jvals(row) for row in jproof.v]

    (com,) = pcs.batch_commit([poly])
    y = mle.evaluate_host([FElt(int(v), FR) for v in vals],
                          [FElt(x, FR) for x in point])
    as_jax = JHyperKZGProof([_jpoint(p) for p in proof.com],
                            [_jpoint(p) for p in proof.w],
                            [[JFElt(x.v, JFR) for x in row] for row in proof.v])
    jpcs.verify(as_jax, JTranscript(b"hyperkzg"),
                [JFElt(x, JFR) for x in point], JFElt(y.v, JFR),
                JCommitment(_jpoint(com.point)))
    pcs.verify(proof, Transcript(b"hyperkzg"), [FElt(x, FR) for x in point],
               y, com)
    with pytest.raises(gp.VerificationError):
        pcs.verify(proof, Transcript(b"hyperkzg"),
                   [FElt(x, FR) for x in point], y + FElt(1, FR), com)


def test_kzg_open_eval_and_verify_match_jolt_tpu(pcs_pair):
    """The univariate opening HyperKZG batches: equal quotient commitment
    and evaluation; both pairing checks accept it and reject v + 1."""
    rng = np.random.default_rng(17)
    jb, b = _both(_ints(rng, 1 << ELL))
    u = FElt(int(_ints(rng, 1)[0]), FR)
    ju = JFElt(u.v, JFR)
    jpcs, pcs = pcs_pair
    w = kzg.kzg_open_no_rem(pcs.pk, b, u)
    jw = jkzg.kzg_open_no_rem(jpcs.pk, jb, ju)
    assert (w.x, w.y, w.is_infinity) == (jw.x, jw.y, jw.is_infinity)
    v = kzg.poly_eval_device(b, u)
    assert v.v == jkzg.poly_eval_device(jb, ju).v
    (com,) = kzg.kzg_commit_batch(pcs.pk, [b])
    assert kzg.kzg_verify(pcs.vk, com, u, v, w)
    assert jkzg.kzg_verify(jpcs.vk, _jpoint(com), ju, JFElt(v.v, JFR),
                           _jpoint(w))
    assert not kzg.kzg_verify(pcs.vk, com, u, v + FElt(1, FR), w)


# ---------------------------------------------------------------------------
# MLE helpers and the product combiner
# ---------------------------------------------------------------------------

def test_mle_helpers_match_jolt_tpu():
    rng = np.random.default_rng(21)
    nv = 4
    vals = _ints(rng, 3, 1 << nv)
    point = [FElt(int(x), FR) for x in _ints(rng, nv)]
    jpoint = [JFElt(x.v, JFR) for x in point]
    jz, z = _both(vals)
    assert _jvals(mle.eq_evals_host(point)) == \
        _jvals(jmle.eq_evals_host(jpoint))
    row = [FElt(int(v), FR) for v in vals[0]]
    assert mle.evaluate_host(row, point).v == jmle.evaluate_host(
        [JFElt(x.v, JFR) for x in row], jpoint).v
    eq = mle.eq_evals_device(FR, [x.v for x in point], "cpu")
    jeq = jmle.eq_evals_device(JFR, [x.v for x in point])
    assert _limbs_equal(eq, jeq)
    assert _limbs_equal(mle.evaluate_device(FR, z, eq),
                        jmle.evaluate_device(JFR, jz, jeq))
    polys = [z[:, i] for i in range(3)]
    assert _jvals(mle.evaluate_many_host(FR, polys, eq)) == _jvals(
        jmle.evaluate_many_host(JFR, [jz[:, i] for i in range(3)], jeq))
    assert _limbs_equal(mle.mle_from_ints(FR, vals.tolist(), "cpu"),
                        jmle.mle_from_ints(JFR, vals.tolist()))
    assert [x.v for x in mle.mle_to_felts(FR, z).ravel()] == \
        [x.v for x in jmle.mle_to_felts(JFR, jz).ravel()]
    assert _limbs_equal(sumcheck.comb_product(FR, polys),
                        jsumcheck.comb_product(
                            JFR, [jz[:, i] for i in range(3)]))


# ---------------------------------------------------------------------------
# Spartan key digest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parity", ["", "1"])
def test_vk_digest_matches_jolt_tpu(parity, monkeypatch):
    monkeypatch.setenv("JOLT_REFERENCE_PARITY", parity)
    vm = mini_vm([AddInstruction, BneInstruction], [], M_mini=1 << 16)
    builder, nu = r1cs.build_jolt_constraints(
        vm.layout, vm.C, RAM_START_ADDRESS - 256, vm.name_to_index, 16)
    jbuilder, jnu = jr1cs.build_jolt_constraints(
        vm.layout, vm.C, RAM_START_ADDRESS - 256, vm.name_to_index,
        log2_strict(1 << 16))
    key = r1cs.UniformSpartanKey(vm.layout, builder.constraints, nu,
                                 1 << 16, FR)
    jkey = jr1cs.UniformSpartanKey(vm.layout, jbuilder.constraints, jnu,
                                   1 << 16, JFR)
    assert key.vk_digest.v == jkey.vk_digest.v
    want = key._digest_ark_parity() if parity else key._digest()
    assert key.vk_digest == want
