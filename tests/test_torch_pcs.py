"""The port's windowed MSM, Zeromorph and Hyrax against jolt_tpu's.

- the windowed MSM (`curve/device.py` `msm`, on the plain Jacobian add and
  doubling) and the verifiers' bucket MSM (`g1_msm_buckets`) against the
  host MSM `g1_msm_host`, at N in {1, 2, 37, 256}
  with scalars of 1, 8, 63 and 254 bits, zero scalars, points at infinity
  and repeated points (the scan's doubling lanes), and with its rows cut
  into several chunks;
- the host functions (`_eval_and_quotient_scalars`, `matrix_dimensions`
  for every num_vars 1-24 and every batch type's ratio,
  `PedersenGenerators.new(64)`) against jolt_tpu's, live;
- Zeromorph at ell = 3 and 6, Hyrax at ell = 3, 6, 7 and ratios 1 and 4,
  and a BatchedHyraxOpeningProof of four polynomials: the transcript's
  state_history, the commitments and every proof element must equal
  jolt_tpu's, frozen in fixtures/port/zeromorph_l6.npz and hyrax_l7.npz
  by scripts/freeze_port_fixtures.py (its `slow` test below reruns it
  live); the port's verifier accepts jolt_tpu's proof, jolt_tpu's verifier
  (host code, no XLA) accepts the port's, and both refuse a tampered one.

The cases and their inputs are in jolt_tpu_torch/commitment/fixtures.py.
The tolerance is zero.
"""
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu.commitment import hyrax as jhyrax
from jolt_tpu.commitment import zeromorph as jzm
from jolt_tpu.commitment.base import BatchType as JBatchType
from jolt_tpu.commitment.kzg import KZGVerifierKey as JVerifierKey
from jolt_tpu.curve.bn254 import G1Affine as JG1Affine
from jolt_tpu.curve.bn254 import G2Affine as JG2Affine
from jolt_tpu.field import FElt as JFElt
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.transcript import Transcript as JTranscript
from jolt_tpu_torch import convert
from jolt_tpu_torch.commitment import fixtures as pfx
from jolt_tpu_torch.commitment import hyrax, zeromorph
from jolt_tpu_torch.commitment.base import BatchType
from jolt_tpu_torch.curve import device as cd
from jolt_tpu_torch.curve.bn254 import G1Affine, g1_msm_buckets, g1_msm_host
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.poly import mle
from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
from jolt_tpu_torch.transcript import Transcript

ROOT = Path(__file__).resolve().parents[1]
FR, JFR = fr_spec(), jfr_spec()
PCS_FILES = ("zeromorph_l6", "hyrax_l7")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frozen():
    out = {}
    for name in PCS_FILES:
        with np.load(ROOT / "fixtures" / "port" / f"{name}.npz") as z:
            out.update({k: z[k] for k in z.files})
    return out


def _felts(xs):
    return [FElt(int(x), FR) for x in xs]


def _jfelts(xs):
    return [JFElt(int(getattr(x, "v", x)), JFR) for x in xs]


def _jpoints(a):
    return [JG1Affine(p.x, p.y, p.is_infinity)
            for p in convert.points_from_numpy(a)]


def _expect_equal(got: dict, frozen: dict):
    for k, v in got.items():
        assert np.array_equal(np.asarray(v), frozen[k]), k


# ---------------------------------------------------------------------------
# the windowed MSM
# ---------------------------------------------------------------------------

def _jacobian(pts, device):
    """Affine host points -> Jacobian device limbs (X, Y, Z), Z = 0 at
    infinity."""
    return tuple(fd.ints_to_device(cd.FQ, v, device) for v in (
        [p.x for p in pts], [p.y for p in pts],
        [0 if p.is_infinity else 1 for p in pts]))


def _msm_case(N, bits, seed):
    """N points g * (a + i * b) for random a, b (one host scalar
    multiplication each for a and b, then adds) and N scalars below 2^bits
    (all zero for bits = 0); with N > 2, a zero scalar, a point at infinity
    and a repeated point with its scalar; with N = 2, one point twice with
    one scalar (a doubling lane at once)."""
    rng = random.Random(seed)
    g = G1Affine.generator().to_jacobian()
    p, step = g.mul(rng.randrange(1, FR.p)), g.mul(rng.randrange(1, FR.p))
    pts = []
    for _ in range(N):
        pts.append(p.to_affine())
        p = p.add(step)
    sc = [rng.randrange(1 << bits) if bits else 0 for _ in range(N)]
    if N == 2:
        pts[1], sc[1] = pts[0], sc[0]
    elif N > 2:
        pts[3], sc[3] = pts[1], sc[1]
        sc[4] = 0
        pts[5] = G1Affine.identity()
    return pts, sc


@pytest.mark.parametrize("N,bits", [(1, 254), (2, 1), (2, 63), (2, 254),
                                    (2, 0), (37, 63), (256, 8)])
def test_windowed_msm_matches_host(N, bits):
    pts, sc = _msm_case(N, bits, seed=N * 1000 + bits)
    got = cd.msm(_jacobian(pts, "cpu"), fd.ints_to_device(FR, [sc], "cpu"))
    want = g1_msm_host(pts, sc)
    assert got == [want]
    assert g1_msm_buckets(pts, sc) == want      # the verifiers' host MSM


def test_windowed_msm_rows_in_chunks_and_horner_on_device(monkeypatch):
    """Two rows: the bit-plane sums Horner-combined on the host (the CPU's
    path) and on the device (the card's: doublings and adds) equal the host
    MSM, and so do rows cut into chunks of one row each."""
    rng = random.Random(7)
    pts, _ = _msm_case(8, 8, seed=1)
    rows = [[rng.randrange(1 << 8) for _ in range(8)] for _ in range(2)]
    mont = fd.ints_to_device(FR, rows, "cpu")
    canon = fd.from_mont_device(FR, mont)
    bases = _jacobian(pts, "cpu")
    want = [g1_msm_host(pts, r) for r in rows]
    S = cd._msm_bit_sums(*bases, canon, cd.scalar_max_windows(canon))
    assert [p.to_affine() for p in cd._horner_host(S)] == want
    on_dev = cd.jacobian_to_host(*cd._horner_device(S))
    assert [p.to_affine() for p in on_dev] == want
    monkeypatch.setattr(cd, "MSM_LANES", 1)
    assert cd.msm(bases, mont) == want


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

def test_eval_and_quotient_scalars_match_jolt_tpu():
    rng = np.random.default_rng(3)
    for n in (1, 3, 6):
        y, x, z, *ch = pfx.field_ints(rng, 3 + n)
        got = zeromorph._eval_and_quotient_scalars(
            *_felts([y, x, z]), _felts(ch), FR)
        want = jzm._eval_and_quotient_scalars(
            *_jfelts([y, x, z]), _jfelts(ch), JFR)
        assert got[0].v == want[0].v
        assert [a.v for a in got[1]] == [a.v for a in want[1]]
        assert [a.v for a in got[2]] == [a.v for a in want[2]]


def test_matrix_dimensions_match_jolt_tpu():
    for bt in BatchType:
        assert hyrax.batch_type_to_ratio(bt) == \
            jhyrax.batch_type_to_ratio(JBatchType(bt.value))
    ratios = sorted({hyrax.batch_type_to_ratio(bt) for bt in BatchType})
    assert ratios == [1, 4, 16, 64]
    for num_vars in range(1, 25):
        for ratio in ratios:
            assert hyrax.matrix_dimensions(num_vars, ratio) == \
                jhyrax.matrix_dimensions(num_vars, ratio), (num_vars, ratio)


@pytest.fixture(scope="module")
def gens():
    return hyrax.PedersenGenerators.new(64, device="cpu")


def test_pedersen_generators_match_jolt_tpu(gens):
    want = jhyrax.PedersenGenerators.new(64)
    assert gens.points == want.points
    assert [p.to_affine() for p in cd.jacobian_to_host(*gens.dev)] == \
        want.points


# ---------------------------------------------------------------------------
# Zeromorph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zm_pcs():
    """One SRS of 2^6 + 1 points: ell = 3 uses its prefix, as jolt_tpu's
    Zeromorph.setup(2^3) does."""
    return zeromorph.Zeromorph.setup(1 << 6, device="cpu")


def _jzeromorph(pcs):
    vk = pcs.vk
    g2 = lambda p: JG2Affine(p.x, p.y, p.is_infinity)
    jvk = JVerifierKey(JG1Affine(vk.g1.x, vk.g1.y), g2(vk.g2),
                       g2(vk.beta_g2))
    return jzm.Zeromorph(None, jvk, g2(pcs.tau_shift_g2))


@pytest.mark.parametrize("ell", pfx.ZEROMORPH_ELLS)
def test_zeromorph_matches_jolt_tpu(ell, zm_pcs, frozen):
    vals, point = pfx.zeromorph_inputs(ell)
    poly = mle.mle_from_ints(FR, vals, "cpu")
    com = zm_pcs.commit(poly)
    t = Transcript(pfx.ZEROMORPH_LABEL)
    proof = zm_pcs.prove(poly, _felts(point), t)
    _expect_equal(pfx.zeromorph_arrays(ell, t, com, proof), frozen)

    y = mle.evaluate_host(_felts(vals), _felts(point))
    pre = f"zm{ell}_"
    theirs = convert.zeromorph_proof_from_numpy(
        frozen[pre + "pi"], frozen[pre + "q_hat_com"], frozen[pre + "q_k_com"])
    their_com = convert.zeromorph_commitment_from_numpy(frozen[pre + "com"])
    zm_pcs.verify(theirs, Transcript(pfx.ZEROMORPH_LABEL), _felts(point), y,
                  their_com)
    with pytest.raises(VerificationError):
        zm_pcs.verify(proof, Transcript(pfx.ZEROMORPH_LABEL), _felts(point),
                      y + FElt(1, FR), com)

    jpcs = _jzeromorph(zm_pcs)
    mine = convert.zeromorph_proof_to_numpy(proof)
    jmine = jzm.ZeromorphProof(*_jpoints(mine["pi"]),
                               *_jpoints(mine["q_hat_com"]),
                               _jpoints(mine["q_k_com"]))
    jcom = jzm.ZeromorphCommitment(
        _jpoints(convert.points_to_numpy([com.point]))[0])
    jpcs.verify(jmine, JTranscript(pfx.ZEROMORPH_LABEL), _jfelts(point),
                JFElt(y.v, JFR), jcom)
    if ell == pfx.ZEROMORPH_ELLS[0]:      # its refusal does not depend on ell
        with pytest.raises(AssertionError):
            jpcs.verify(jmine, JTranscript(pfx.ZEROMORPH_LABEL),
                        _jfelts(point), JFElt(y.v + 1, JFR), jcom)


def test_zeromorph_srs_is_g_times_powers_of_tau(zm_pcs):
    """The SRS of seed 0x5A4D (no fixture has it): g * tau^i, and the
    shift-1 key g2 * tau, with tau drawn as jolt_tpu draws it."""
    tau = random.Random(0x5A4D).randrange(1, FR.p)
    assert zm_pcs.pk.n == (1 << 6) + 1
    g = G1Affine.generator().to_jacobian()
    pts = [p.to_affine() for p in cd.jacobian_to_host(
        *(c[:, :8] for c in zm_pcs.pk.g1_jac))]
    assert pts == [g.mul(pow(tau, i, FR.p)).to_affine() for i in range(8)]
    want = JG2Affine.generator().mul(tau)
    assert (zm_pcs.tau_shift_g2.x, zm_pcs.tau_shift_g2.y) == (want.x, want.y)


# ---------------------------------------------------------------------------
# Hyrax
# ---------------------------------------------------------------------------

def _jhyrax(gens):
    """jolt_tpu's scheme over the port's generators (its verifier reads only
    the host points)."""
    return jhyrax.HyraxScheme(jhyrax.PedersenGenerators(
        _jpoints(convert.points_to_numpy(gens.points)), None))


@pytest.mark.parametrize("ell,ratio", pfx.HYRAX_CASES)
def test_hyrax_matches_jolt_tpu(ell, ratio, gens, frozen):
    pcs = hyrax.HyraxScheme(gens)
    vals, point = pfx.hyrax_inputs(ell, ratio)
    poly = mle.mle_from_ints(FR, vals, "cpu")
    com = pcs.commit(poly, ratio)
    t = Transcript(pfx.HYRAX_LABEL)
    proof = pcs.prove(poly, _felts(point), t, ratio)
    got = pfx.hyrax_arrays(ell, ratio, t, com, proof)
    _expect_equal(got, frozen)

    y = mle.evaluate_host(_felts(vals), _felts(point))
    pre = f"hx{ell}_{ratio}_"
    their_com = convert.hyrax_commitment_from_numpy(frozen[pre + "rows"])
    theirs = convert.hyrax_proof_from_numpy(frozen[pre + "vmp"])
    pcs.verify(theirs, Transcript(pfx.HYRAX_LABEL), _felts(point), y,
               their_com, ratio)
    # bump vmp[0] by one and vmp[1] so that <vmp, R> stays the opening:
    # only the row-commitment equation can refuse it
    l_size, _ = hyrax.matrix_dimensions(ell, ratio)
    R = mle.eq_evals_host(_felts(point)[l_size.bit_length() - 1:])
    bumped = hyrax.HyraxOpeningProof(list(proof.vector_matrix_product))
    bumped.vector_matrix_product[0] += FElt(1, FR)
    bumped.vector_matrix_product[1] -= R[0] * R[1].inverse()
    with pytest.raises(VerificationError):
        pcs.verify(bumped, Transcript(pfx.HYRAX_LABEL), _felts(point), y,
                   com, ratio)

    jpcs = _jhyrax(gens)
    jcom = jhyrax.HyraxCommitment(_jpoints(got[pre + "rows"]))
    jmine = jhyrax.HyraxOpeningProof(_jfelts(proof.vector_matrix_product))
    jpcs.verify(jmine, JTranscript(pfx.HYRAX_LABEL), _jfelts(point),
                JFElt(y.v, JFR), jcom, ratio)
    with pytest.raises(AssertionError):
        jpcs.verify(jhyrax.HyraxOpeningProof(
            _jfelts(bumped.vector_matrix_product)),
            JTranscript(pfx.HYRAX_LABEL), _jfelts(point), JFElt(y.v, JFR),
            jcom, ratio)


def test_batched_hyrax_matches_jolt_tpu(gens, frozen):
    pcs = hyrax.HyraxScheme(gens)
    all_vals, point = pfx.hyrax_batch_inputs()
    polys = [mle.mle_from_ints(FR, v, "cpu") for v in all_vals]
    coms = pcs.batch_commit(polys)
    openings = [mle.evaluate_host(_felts(v), _felts(point)) for v in all_vals]
    t = Transcript(pfx.HYRAX_BATCH_LABEL)
    proof = pcs.prove_batched(polys, _felts(point), openings, t,
                              BatchType.SMALL)
    got = pfx.hyrax_batch_arrays(t, coms, proof)
    _expect_equal(got, frozen)

    theirs = convert.batched_hyrax_proof_from_numpy(frozen["hxb_vmp"],
                                                    frozen["hxb_ratio"])
    their_coms = [convert.hyrax_commitment_from_numpy(r)
                  for r in frozen["hxb_rows"]]
    theirs.verify(pcs, _felts(point), openings, their_coms,
                  Transcript(pfx.HYRAX_BATCH_LABEL))
    bad = list(openings)
    bad[1] = bad[1] + FElt(1, FR)
    with pytest.raises(VerificationError):
        proof.verify(pcs, _felts(point), bad, coms,
                     Transcript(pfx.HYRAX_BATCH_LABEL))

    jpcs = _jhyrax(gens)
    jcoms = [jhyrax.HyraxCommitment(_jpoints(r)) for r in got["hxb_rows"]]
    jmine = jhyrax.BatchedHyraxOpeningProof(jhyrax.HyraxOpeningProof(
        _jfelts(proof.joint_proof.vector_matrix_product)), proof.ratio)
    jmine.verify(jpcs, _jfelts(point), _jfelts(openings), jcoms,
                 JTranscript(pfx.HYRAX_BATCH_LABEL))
    with pytest.raises(AssertionError):
        jmine.verify(jpcs, _jfelts(point), _jfelts(bad), jcoms,
                     JTranscript(pfx.HYRAX_BATCH_LABEL))


# ---------------------------------------------------------------------------
# the frozen fixtures, live
# ---------------------------------------------------------------------------

def _freeze_script():
    spec = importlib.util.spec_from_file_location(
        "freeze_port_fixtures", ROOT / "scripts" / "freeze_port_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("case", PCS_FILES)
def test_frozen_pcs_fixtures_match_a_live_jolt_tpu_run(case, monkeypatch):
    """jolt_tpu commits, opens and verifies every case live (minutes of
    XLA compiles); JOLT_TPU_SRS_CACHE=0 keeps its SRS out of fixtures/."""
    monkeypatch.setenv("JOLT_TPU_SRS_CACHE", "0")
    want = _freeze_script().prove_pcs_case(case)
    with np.load(ROOT / "fixtures" / "port" / f"{case}.npz") as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert np.array_equal(z[k], want[k]), k
