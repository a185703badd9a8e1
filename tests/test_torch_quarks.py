"""The port's Quarks hybrid grand product and HyperKZG's grand-product
commit against jolt_tpu's.

- With the mock PCS, at tests/test_quark_gp.py's sizes (B = 2; 2^5 leaves
  for quark_prove alone, 2^6 and 2^3 with seed 11 for the hybrid), the
  port proves on the CPU and jolt_tpu's proofs are read from
  fixtures/port/quark_mock.json (frozen by scripts/freeze_port_fixtures.py;
  the `slow` test recomputes them live): the transcripts' state_history,
  every proof field, r_t, h_r_t and the claims must be equal; the port's
  verifier accepts each proof and rejects it with one value bumped.
- With HyperKZG, the case of jolt_tpu_torch/subprotocols/fixtures.py
  (B = 2, 2^6 leaves, a 2^8-point SRS) against jolt_tpu's proof frozen in
  fixtures/port/quark_hyperkzg.npz by scripts/freeze_port_fixtures.py: the
  transcript, the g commitments and the canonical bytes of the
  grand-product proof; the port reads jolt_tpu's bytes back and verifies
  them.
- `kzg_commit_grand_product` (g_products plus the residual MSM) equals
  `kzg_commit` on random, 90%-ones, all-ones and non-power-of-two
  polynomials, and g_products[k] is the host sum of the first 2^k SRS
  points.

The tolerance is zero.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu_torch.commitment.kzg import (kzg_commit,
                                          kzg_commit_grand_product,
                                          srs_setup)
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.curve import device as cd
from jolt_tpu_torch.curve.bn254 import G1Jacobian
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.poly.opening_proof import (ProverOpeningAccumulator,
                                               VerifierOpeningAccumulator)
from jolt_tpu_torch.subprotocols import fixtures as sfx
from jolt_tpu_torch.subprotocols.grand_product import BatchedDenseGrandProduct
from jolt_tpu_torch.subprotocols.grand_product_quarks import (
    QuarkGrandProduct, quark_prove, quark_verify)
from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
from jolt_tpu_torch.transcript import Transcript
from jolt_tpu_torch.utils import serialization as ser
from jolt_tpu_torch.utils.ark_proof import _w_gp_proof

ROOT = Path(__file__).resolve().parents[1]
LABEL = sfx.QUARK_LABEL
CASES = sfx.QUARK_MOCK_CASES


def _frozen_mock() -> dict:
    return json.loads((ROOT / "fixtures" / "port" / "quark_mock.json")
                      .read_text())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prove(kind: str, log_n: int, seed: int) -> dict:
    """One case proved by the port with the mock PCS on the CPU; the
    opening accumulator reduced and proved after it."""
    vals = sfx.mock_leaves_u64(log_n, seed)
    spec = fr_spec()
    leaves = fd.u64_to_mont_device(spec, vals, "cpu")
    t, acc = Transcript(LABEL), ProverOpeningAccumulator(spec)
    pcs = MockCommitmentScheme(spec)
    if kind == "quark":
        proof, r_t, h_r_t = quark_prove(leaves, pcs, acc, t, spec)
        claims = [FElt(int(np.prod([int(v) for v in row], dtype=object)
                           % spec.p), spec) for row in vals]
        out = dict(r_t=r_t, h_r_t=h_r_t)
    else:
        gp = QuarkGrandProduct.construct(leaves, spec)
        claims = gp.claims()
        proof, r = gp.prove_grand_product(acc, t, pcs)
        out = dict(r=r)
    reduced = acc.reduce_and_prove(pcs, t)
    return dict(out, proof=proof, claims=claims, reduced=reduced,
                states=t.state_history, acc=acc)


@pytest.fixture(scope="module")
def frozen_mock():
    return _frozen_mock()


@pytest.fixture(scope="module", params=list(CASES))
def case(request, frozen_mock):
    kind, log_n, seed = CASES[request.param]
    return dict(kind=kind, log_n=log_n, jax=frozen_mock[request.param],
                torch=_prove(kind, log_n, seed))


def test_transcript_proof_and_claims_match_jolt_tpu(case):
    j, p = case["jax"], sfx.mock_record(case["torch"])
    assert sorted(p) == sorted(j)
    for k in ("states", "proof", "claims", "reduced"):
        assert p[k] == j[k], k
    keys = ("r_t", "h_r_t") if case["kind"] == "quark" else ("r",)
    for k in keys:
        assert p[k] == j[k], k
    if case["kind"] == "hybrid":        # four base layers, fewer if short
        assert case["torch"]["proof"].quark is not None
        assert len(case["torch"]["proof"].layers) == \
            min(4, case["log_n"] - 1)


@pytest.mark.slow
def test_frozen_mock_cases_match_a_live_jolt_tpu_prove():
    """jolt_tpu proves the three mock cases live (XLA compiles)."""
    spec = importlib.util.spec_from_file_location(
        "freeze_port_fixtures", ROOT / "scripts" / "freeze_port_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    frozen = _frozen_mock()
    assert sorted(frozen) == sorted(CASES)
    for name, args in CASES.items():
        live = json.loads(json.dumps(mod.quark_mock_case(*args)))
        assert live == frozen[name], name


def _verify(case):
    p = case["torch"]
    spec, proof = fr_spec(), p["proof"]
    pcs = MockCommitmentScheme(spec)
    t = Transcript(LABEL)
    acc = VerifierOpeningAccumulator(pcs, spec)
    if case["kind"] == "quark":
        h_r_t, r_t = quark_verify(proof, p["claims"], acc, t, spec)
        assert sfx.plain((h_r_t, r_t)) == sfx.plain((p["h_r_t"], p["r_t"]))
    else:
        QuarkGrandProduct.verify_grand_product(proof, p["claims"], acc, t,
                                               spec)
    acc.reduce_and_verify(pcs, p["reduced"], t)


def test_verifier_accepts_and_rejects_a_bumped_value(case):
    _verify(case)
    quark = case["torch"]["proof"] if case["kind"] == "quark" \
        else case["torch"]["proof"].quark
    good = quark.helper_values[0][0]
    quark.helper_values[0][0] = good + FElt(1, fr_spec())
    try:
        with pytest.raises(VerificationError):
            _verify(case)
    finally:
        quark.helper_values[0][0] = good


def test_hybrid_claims_equal_the_dense_grand_product():
    vals = sfx.mock_leaves_u64(6, 9)
    leaves = fd.u64_to_mont_device(fr_spec(), vals, "cpu")
    assert sfx.plain(QuarkGrandProduct.construct(leaves).claims()) == \
        sfx.plain(BatchedDenseGrandProduct.construct(leaves).claims())


# ---------------------------------------------------------------------------
# HyperKZG: jolt_tpu's frozen proof
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quark_hyperkzg():
    got, proof, reduced, claims, pcs = sfx.prove_quark_case("cpu")
    with np.load(ROOT / "fixtures" / "port" / "quark_hyperkzg.npz") as z:
        want = {k: z[k] for k in z.files}
    return dict(got=got, want=want, proof=proof, reduced=reduced,
                claims=claims, pcs=pcs)


def test_hyperkzg_case_matches_jolt_tpus_frozen_proof(quark_hyperkzg):
    got, want = quark_hyperkzg["got"], quark_hyperkzg["want"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert (got[k] == want[k]).all(), k


def test_jolt_tpus_bytes_read_back_and_verify(quark_hyperkzg):
    """The port reads jolt_tpu's canonical grand-product bytes, writes
    them back unchanged, and verifies the proof read back; a helper value
    bumped by one is rejected."""
    data = quark_hyperkzg["want"]["gp_bytes"].tobytes()
    proof = ser.deserialize_grand_product(ser.Reader(data))
    w = ser.Writer()
    ser.serialize_grand_product(w, proof)
    assert w.getvalue() == data
    pcs, spec = quark_hyperkzg["pcs"], fr_spec()

    def verify(pr):
        t = Transcript(sfx.QUARK_LABEL)
        acc = VerifierOpeningAccumulator(pcs, spec)
        QuarkGrandProduct.verify_grand_product(pr, quark_hyperkzg["claims"],
                                               acc, t, spec)
        acc.reduce_and_verify(pcs, quark_hyperkzg["reduced"], t)

    verify(proof)
    proof.quark.helper_values[1][1] = \
        proof.quark.helper_values[1][1] + FElt(1, spec)
    with pytest.raises(VerificationError):
        verify(proof)
    with pytest.raises(ValueError, match="quark"):
        _w_gp_proof(bytearray(), quark_hyperkzg["proof"])


# ---------------------------------------------------------------------------
# the grand-product commit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def srs():
    return srs_setup(1 << 8, "cpu")


def test_g_products_are_srs_prefix_sums(srs):
    pts = cd.jacobian_to_host(*srs.g1_jac)
    got = srs.g_products()
    assert len(got) == 9
    acc = G1Jacobian.identity()
    for k in range(9):
        for p in pts[(1 << k) // 2 if k else 0:1 << k]:
            acc = acc.add(p)
        assert got[k].to_affine() == acc.to_affine(), k


def _coeffs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(13)
    if kind == "random":
        return rng.integers(0, 1 << 63, size=64, dtype=np.uint64)
    if kind == "ones_90":
        rest = rng.integers(0, 1 << 63, size=128, dtype=np.uint64)
        return np.where(rng.random(128) < 0.9, np.uint64(1), rest)
    if kind == "all_ones":
        return np.ones(32, dtype=np.uint64)
    return rng.integers(0, 1 << 63, size=48, dtype=np.uint64)   # 48 points


@pytest.mark.parametrize("kind", ["random", "ones_90", "all_ones",
                                  "not_a_power_of_two"])
def test_grand_product_commit_equals_kzg_commit(srs, kind):
    poly = fd.u64_to_mont_device(fr_spec(), _coeffs(kind), "cpu")
    assert kzg_commit_grand_product(srs, poly) == kzg_commit(srs, poly)
