"""Parts of the port's Jolt VM prover against jolt_tpu's, small.

Each test feeds the numpy-seeded field elements of
scripts/freeze_port_fixtures.py `parts_inputs` to the port's CPU path and
compares transcripts (state_history), proof values, points and limbs for
equality with jolt_tpu's outputs on the same inputs, frozen in
fixtures/port/jolt_parts.npz by that script (jolt_tpu's side costs tens of
seconds of XLA compiles; the `slow` test below recomputes it live):

- the toggled grand product (Lasso's flag-gated read/write multisets),
  proved by both and verified by the port;
- the batched opening reduction (`reduce_and_prove`) with the mock PCS;
- HyperKZG's opening at ell = 6, whose proof jolt_tpu's verifier (host
  code, run live) accepts, and the univariate KZG opening, evaluation and
  pairing check under it;
- the MLE helpers and the sumcheck's product combiner (the host ones
  against jolt_tpu's live);
- Spartan's key digest, in the default mode and under
  JOLT_REFERENCE_PARITY=1 (live).

The tolerance is zero.
"""
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu.commitment import kzg as jkzg
from jolt_tpu.commitment.hyperkzg import HyperKZG as JHyperKZG
from jolt_tpu.commitment.hyperkzg import HyperKZGCommitment as JCommitment
from jolt_tpu.commitment.hyperkzg import HyperKZGProof as JHyperKZGProof
from jolt_tpu.curve.bn254 import G1Affine as JG1Affine
from jolt_tpu.curve.bn254 import G2Affine as JG2Affine
from jolt_tpu.field import FElt as JFElt
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.poly import mle as jmle
from jolt_tpu.transcript import Transcript as JTranscript
from jolt_tpu.utils.math import log2_strict
from jolt_tpu.vm import r1cs as jr1cs
from jolt_tpu.vm.rv_trace import RAM_START_ADDRESS
from jolt_tpu_torch.commitment import kzg
from jolt_tpu_torch.commitment.fixtures import states
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.convert import points_from_numpy, scalars_from_numpy
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

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "fixtures" / "port" / "jolt_parts.npz"
FR, JFR = fr_spec(), jfr_spec()


def _freeze_script():
    """scripts/freeze_port_fixtures.py: the inputs, and jolt_tpu's side."""
    spec = importlib.util.spec_from_file_location(
        "freeze_port_fixtures", ROOT / "scripts" / "freeze_port_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    return _freeze_script().parts_inputs()


@pytest.fixture(scope="module")
def frozen():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _dev(vals):
    return fd.ints_to_device(FR, vals.tolist(), "cpu")


def _vals(xs):
    return [x.v for x in xs]


def _limbs_equal(port: torch.Tensor, frozen_limbs) -> bool:
    return np.array_equal(port.numpy().astype(np.uint32), frozen_limbs)


# ---------------------------------------------------------------------------
# toggled grand product
# ---------------------------------------------------------------------------

def test_toggled_grand_product_matches_jolt_tpu(inputs, frozen):
    bits, fps = inputs["toggled"]
    circ = gp.ToggledBatchedGrandProduct(torch.from_numpy(bits), _dev(fps),
                                         FR)
    claims = circ.claims()
    assert _vals(claims) == scalars_from_numpy(frozen["gp_claims"])
    tt = Transcript(b"toggled")
    proof, r = circ.prove(tt)
    assert np.array_equal(states(tt), frozen["gp_states"])
    assert _vals(r) == scalars_from_numpy(frozen["gp_r"])
    assert len(proof.layers) == len(frozen["gp_left"])
    for lp, left, right in zip(proof.layers, frozen["gp_left"],
                               frozen["gp_right"]):
        assert _vals(lp.left_claims) == scalars_from_numpy(left)
        assert _vals(lp.right_claims) == scalars_from_numpy(right)

    vt = Transcript(b"toggled")
    vt.compare_to(tt)
    finals, rv = gp.verify_grand_product(
        proof, claims, vt,
        verify_sumcheck_claim=gp.toggled_verify_sumcheck_claim)
    assert _vals(rv) == _vals(r)
    bad = proof.layers[-1].right_claims
    bad[0] = bad[0] + FElt(1, FR)
    with pytest.raises(gp.VerificationError):
        gp.verify_grand_product(
            proof, claims, Transcript(b"toggled"),
            verify_sumcheck_claim=gp.toggled_verify_sumcheck_claim)


# ---------------------------------------------------------------------------
# opening reduction with the mock PCS
# ---------------------------------------------------------------------------

def test_reduce_and_prove_matches_jolt_tpu(inputs, frozen):
    acc, tt = ProverOpeningAccumulator(FR), Transcript(b"openings")
    groups = []
    for point, vals in inputs["openings"]:
        polys = _dev(vals)
        claims = [mle.evaluate_host([FElt(int(v), FR) for v in row],
                                    [FElt(x, FR) for x in point])
                  for row in vals]
        acc.append([polys[:, i] for i in range(2)],
                   mle.eq_evals_device(FR, point, "cpu"),
                   [FElt(x, FR) for x in point], claims, tt)
        groups.append((polys, point, claims))
    pcs = MockCommitmentScheme(FR)
    red = acc.reduce_and_prove(pcs, tt)
    assert np.array_equal(states(tt), frozen["open_states"])
    assert _vals(red.sumcheck_claims) == \
        scalars_from_numpy(frozen["open_claims"])

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

def _jpoint(p):
    return JG1Affine(p.x, p.y, p.is_infinity)


@pytest.fixture(scope="module")
def pcs():
    """The port's HyperKZG over the 2^6-point SRS."""
    return HyperKZG.setup(1 << 6, device="cpu")


@pytest.fixture(scope="module")
def jpcs():
    """jolt_tpu's HyperKZG verifier (host code) over the SRS of seed
    0x6A6F6C74, its key drawn as jolt_tpu's srs_setup draws it."""
    tau = random.Random(0x6A6F6C74).randrange(1, JFR.p)
    g2 = JG2Affine.generator()
    return JHyperKZG(None, jkzg.KZGVerifierKey(JG1Affine.generator(), g2,
                                               g2.mul(tau)))


def test_hyperkzg_prove_matches_jolt_tpu_and_verifies_there(
        inputs, frozen, pcs, jpcs):
    vals, point = inputs["hyperkzg"]
    ell = len(point)
    poly = _dev(vals)
    for k in ("g1", "g2", "beta_g2"):
        a, b = getattr(pcs.vk, k), getattr(jpcs.vk, k)
        assert (a.x, a.y) == (b.x, b.y)

    tt = Transcript(b"hyperkzg")
    proof = pcs.prove(poly, [FElt(x, FR) for x in point], tt)
    assert np.array_equal(states(tt), frozen["hk_states"])
    assert proof.com == points_from_numpy(frozen["hk_com"])
    assert proof.w == points_from_numpy(frozen["hk_w"])
    assert [_vals(row) for row in proof.v] == \
        [scalars_from_numpy(row) for row in frozen["hk_v"]]
    assert len(proof.v[0]) == ell

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


def test_kzg_open_eval_and_verify_match_jolt_tpu(inputs, frozen, pcs, jpcs):
    """The univariate opening HyperKZG batches: equal quotient commitment
    and evaluation; both pairing checks accept it and reject v + 1."""
    vals, u_int = inputs["kzg"]
    b, u = _dev(vals), FElt(u_int, FR)
    ju = JFElt(u.v, JFR)
    w = kzg.kzg_open_no_rem(pcs.pk, b, u)
    assert [w] == points_from_numpy(frozen["kzg_w"])
    v = kzg.poly_eval_device(b, u)
    assert [v.v] == scalars_from_numpy(frozen["kzg_v"])
    (com,) = kzg.kzg_commit_batch(pcs.pk, [b])
    assert kzg.kzg_verify(pcs.vk, com, u, v, w)
    assert jkzg.kzg_verify(jpcs.vk, _jpoint(com), ju, JFElt(v.v, JFR),
                           _jpoint(w))
    assert not kzg.kzg_verify(pcs.vk, com, u, v + FElt(1, FR), w)


# ---------------------------------------------------------------------------
# MLE helpers and the product combiner
# ---------------------------------------------------------------------------

def test_mle_helpers_match_jolt_tpu(inputs, frozen):
    vals, point_ints = inputs["mle"]
    point = [FElt(x, FR) for x in point_ints]
    jpoint = [JFElt(x.v, JFR) for x in point]
    z = _dev(vals)
    assert _vals(mle.eq_evals_host(point)) == \
        _vals(jmle.eq_evals_host(jpoint))
    row = [FElt(int(v), FR) for v in vals[0]]
    assert mle.evaluate_host(row, point).v == jmle.evaluate_host(
        [JFElt(x.v, JFR) for x in row], jpoint).v
    eq = mle.eq_evals_device(FR, [x.v for x in point], "cpu")
    assert _limbs_equal(eq, frozen["mle_eq"])
    assert _limbs_equal(mle.evaluate_device(FR, z, eq), frozen["mle_eval"])
    polys = [z[:, i] for i in range(3)]
    assert _vals(mle.evaluate_many_host(FR, polys, eq)) == \
        scalars_from_numpy(frozen["mle_many"])
    assert _limbs_equal(mle.mle_from_ints(FR, vals.tolist(), "cpu"),
                        frozen["mle_from_ints"])
    assert [x.v for x in mle.mle_to_felts(FR, z).ravel()] == \
        scalars_from_numpy(frozen["mle_to_felts"])
    assert _limbs_equal(sumcheck.comb_product(FR, polys),
                        frozen["comb_product"])


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


# ---------------------------------------------------------------------------
# the frozen fixture, live
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_frozen_jolt_parts_match_a_live_jolt_tpu_run():
    """jolt_tpu computes its side live (tens of seconds of XLA
    compiles)."""
    want = _freeze_script().jolt_parts_arrays()
    with np.load(FIXTURE) as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert np.array_equal(z[k], want[k]), k
