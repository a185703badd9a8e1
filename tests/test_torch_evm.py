"""The port's EVM verifier path and its `cli.py new` against jolt_tpu's.

- The fixture generators (jolt_tpu_torch/evm/fixtures.py) on the CPU:
  `transcript_fixture` and `grand_product_fixture(nv=4)` equal jolt_tpu's
  live output; `transcript_fixture`, `grand_product_fixture` and
  `hyperkzg_fixture` at their defaults equal the committed
  fixtures/evm/*.json field for field (`spartan_fixture`, two proves of
  fibonacci(4) on rv32i_vm() at M = 2^16, is `slow`).
- `gen_r1cs_sol.generate` equals the committed
  evm_verifier/src/subprotocols/R1CSMatrix.sol byte for byte.
- The port's Solidity-subset VM executes the committed Solidity sources on
  tests/test_solidity_vm.py's cases: Fr ops, the transcript against
  fixtures/transcript_vectors.json and against the port's Transcript, the
  sumcheck, grand-product, HyperKZG and Spartan verifiers accepting the
  fixtures and reverting on a tampered value each.
- `cli.py new` writes jolt_tpu's three templates with jolt_tpu ->
  jolt_tpu_torch, and the guest program it writes assembles and traces as
  jolt_tpu's does (no prove on the CPU).

The tolerance is zero.  Nothing here writes outside pytest's tmp_path.
"""
import importlib.util
import json
import random
from pathlib import Path

import pytest
import torch
from jolt_tpu import cli as jcli
from jolt_tpu.evm import fixtures as jfixtures
from jolt_tpu.vm.host import trace_program as j_trace_program
from jolt_tpu.vm.rv32i_vm import rv32i_vm as j_rv32i_vm

from jolt_tpu_torch import cli
from jolt_tpu_torch.curve.bn254 import G1Affine
from jolt_tpu_torch.evm import fixtures as pfixtures
from jolt_tpu_torch.evm.gen_r1cs_sol import generate
from jolt_tpu_torch.evm.solidity_vm import SolidityRevert, load_vm
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.poly.unipoly import UniPoly
from jolt_tpu_torch.transcript import Transcript
from jolt_tpu_torch.vm.host import trace_program
from jolt_tpu_torch.vm.rv32i_vm import rv32i_vm

ROOT = Path(__file__).resolve().parents[1]
FIXDIR = ROOT / "fixtures"
SOL_DIR = ROOT / "evm_verifier" / "src" / "subprotocols"
P = fr_spec().p


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _committed(name: str) -> dict:
    return json.loads((FIXDIR / "evm" / f"{name}.json").read_text())


# ---------------------------------------------------------------------------
# fixture generators
# ---------------------------------------------------------------------------

def test_transcript_fixture_matches_jolt_tpu_and_the_committed_file():
    got = pfixtures.transcript_fixture()
    assert got == jfixtures.transcript_fixture()
    assert got == _committed("transcript")


def test_grand_product_fixture_matches_jolt_tpu_live():
    assert pfixtures.grand_product_fixture(nv=4, device="cpu") == \
        jfixtures.grand_product_fixture(nv=4)


@pytest.mark.parametrize("name", ["grand_product", "hyperkzg"])
def test_fixture_matches_the_committed_file(name):
    assert pfixtures.FIXTURES[name](device="cpu") == _committed(name)


@pytest.mark.slow
def test_spartan_fixture_matches_the_committed_file():
    """Two proves of fibonacci(4) on rv32i_vm() (M = 2^16) on the CPU."""
    assert pfixtures.spartan_fixture(device="cpu") == _committed("spartan")


def test_r1cs_matrix_sol_is_generated_byte_for_byte(tmp_path):
    out = tmp_path / "R1CSMatrix.sol"
    src = generate(str(out))
    assert out.read_text() == src
    assert src == (SOL_DIR / "R1CSMatrix.sol").read_text()


# ---------------------------------------------------------------------------
# the Solidity-subset VM on the committed verifier sources
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vm():
    return load_vm()


def _sol_transcript(vm, label: bytes):
    return vm.call("FiatShamirTranscript.newTranscript",
                   label.ljust(32, b"\x00"))


def test_fr_ops_match_the_host_field(vm):
    a, b = 0x1234567890ABCDEF1234, P - 5
    fa, fb = vm.fr(a), vm.fr(b)
    assert vm.call("frAdd", fa, fb).val == (a + b) % P
    assert vm.call("frSub", fa, fb).val == (a - b) % P
    assert vm.call("frMul", fa, fb).val == (a * b) % P
    assert vm.call("FrLib.invert", fb).val == pow(b, P - 2, P)
    assert vm.call("FrLib.pow", fa, 11).val == pow(a, 11, P)
    assert vm.call("frEq", fa, vm.fr(a)) is True
    assert vm.call("frNeq", fa, fb) is True


def test_transcript_replays_the_frozen_state_history(vm):
    fix = json.loads((FIXDIR / "transcript_vectors.json").read_text())
    g = G1Affine.generator()
    g2 = g.to_jacobian().double().to_affine()
    lib = "FiatShamirTranscript."
    t = None
    for ev in fix["events"]:
        kind = ev["kind"]
        if kind == "init":
            t = _sol_transcript(vm, ev["label"].encode())
        elif kind == "message":
            vm.call(lib + "appendBytes32", t,
                    ev["msg"].encode().ljust(32, b"\x00"))
        elif kind == "u64":
            vm.call(lib + "appendU64", t, ev["value"])
        elif kind == "bytes":
            vm.call(lib + "appendBytes", t, bytes.fromhex(ev["data"]))
        elif kind == "scalar":
            vm.call(lib + "appendScalar", t, int(ev["value"]))
        elif kind == "scalars":
            vm.call(lib + "appendVector", t, [int(v) for v in ev["values"]])
        elif kind == "point":
            vm.call(lib + "appendPoint", t, g.x, g.y)
        elif kind == "point_infinity":
            vm.call(lib + "appendPoint", t, 0, 0)
        elif kind == "points":
            vm.call(lib + "appendPoints", t, [g.x, g.y, g2.x, g2.y])
        elif kind == "challenge_scalar":
            assert vm.call(lib + "challengeScalar", t).val == int(ev["value"])
        elif kind == "challenge_vector":
            cs = vm.call(lib + "challengeVector", t, len(ev["values"]))
            assert [c.val for c in cs] == [int(v) for v in ev["values"]]
        elif kind == "challenge_powers":
            cs = vm.call(lib + "challengeScalarPowers", t, len(ev["values"]))
            assert [c.val for c in cs] == [int(v) for v in ev["values"]]
        else:
            raise AssertionError(f"unknown fixture event {kind}")
        assert t["state"].hex() == ev["state"], f"state diverged at {kind}"


def test_transcript_matches_the_ports_transcript(vm):
    spec = fr_spec()
    py = Transcript(b"sol_parity")
    sol = _sol_transcript(vm, b"sol_parity")
    lib = "FiatShamirTranscript."
    py.append_u64(7)
    vm.call(lib + "appendU64", sol, 7)
    py.append_scalar(FElt(123, spec))
    vm.call(lib + "appendScalar", sol, 123)
    py.append_scalars([FElt(5, spec), FElt(6, spec)])
    vm.call(lib + "appendVector", sol, [5, 6])
    assert py.challenge_scalar(spec).v == \
        vm.call(lib + "challengeScalar", sol).val
    assert sol["state"] == py.state


def _sol_sumcheck_proof(vm, compressed_polys):
    rounds = [vm.make_struct("SumcheckVerifier.CompressedUniPoly",
                             coeffsExceptLinear=[vm.fr(c) for c in coeffs])
              for coeffs in compressed_polys]
    return vm.make_struct("SumcheckVerifier.SumcheckProof", rounds=rounds)


def test_sumcheck_verifier_accepts_and_rejects(vm):
    """A product sumcheck over 3 variables proved on the host with the
    port's UniPoly and Transcript; the executed SumcheckVerifier.sol
    derives the same challenges and final claim, and a tampered round
    changes the claim."""
    spec = fr_spec()
    rng = random.Random(42)
    A = [FElt(rng.randrange(P), spec) for _ in range(8)]
    B = [FElt(rng.randrange(P), spec) for _ in range(8)]
    claim = sum((a * b for a, b in zip(A, B)), FElt(0, spec))
    t = Transcript(b"sc_sol")
    rounds, cur_a, cur_b, e = [], A[:], B[:], claim
    for _ in range(3):
        h = len(cur_a) // 2
        lo_a, hi_a, lo_b, hi_b = cur_a[:h], cur_a[h:], cur_b[:h], cur_b[h:]
        e0 = sum((a * b for a, b in zip(lo_a, lo_b)), FElt(0, spec))
        e1 = sum((a * b for a, b in zip(hi_a, hi_b)), FElt(0, spec))
        e2 = sum(((h2 + h2 - l2) * (hb + hb - lb)
                  for l2, h2, lb, hb in zip(lo_a, hi_a, lo_b, hi_b)),
                 FElt(0, spec))
        poly = UniPoly.from_evals([e0, e1, e2])
        cpoly = poly.compress()
        cpoly.append_to_transcript(t)
        r = t.challenge_scalar(spec)
        cur_a = [l + r * (hh - l) for l, hh in zip(lo_a, hi_a)]
        cur_b = [l + r * (hh - l) for l, hh in zip(lo_b, hi_b)]
        e = poly.evaluate(r)
        rounds.append([c.v for c in cpoly.coeffs_except_linear_term])

    final, _ = vm.call("SumcheckVerifier.verify",
                       _sol_sumcheck_proof(vm, rounds), vm.fr(claim.v), 3, 2,
                       _sol_transcript(vm, b"sc_sol"))
    assert final.val == e.v == (cur_a[0] * cur_b[0]).v
    bad = [list(r) for r in rounds]
    bad[1][0] = (bad[1][0] + 1) % P
    bad_final, _ = vm.call("SumcheckVerifier.verify",
                           _sol_sumcheck_proof(vm, bad), vm.fr(claim.v), 3,
                           2, _sol_transcript(vm, b"sc_sol"))
    assert bad_final.val != e.v
    with pytest.raises(SolidityRevert):
        vm.call("SumcheckVerifier.verify", _sol_sumcheck_proof(vm, bad[:2]),
                vm.fr(claim.v), 3, 2, _sol_transcript(vm, b"sc_sol"))


def _sol_gp_proof(vm, fx):
    layers = [vm.make_struct(
        "GrandProductVerifier.LayerProof",
        sumcheck=_sol_sumcheck_proof(vm, [[int(c, 16) for c in r]
                                          for r in lay["sumcheck"]]),
        leftClaims=[vm.fr(int(c, 16)) for c in lay["left_claims"]],
        rightClaims=[vm.fr(int(c, 16)) for c in lay["right_claims"]])
        for lay in fx["layers"]]
    return vm.make_struct("GrandProductVerifier.GrandProductProof",
                          layers=layers)


def test_grand_product_verifier_accepts_and_reverts(vm):
    fx = _committed("grand_product")
    claims = [vm.fr(int(c, 16)) for c in fx["claims"]]
    _, r_gp = vm.call("GrandProductVerifier.verify", _sol_gp_proof(vm, fx),
                      claims, _sol_transcript(vm, b"test_transcript"))
    assert [x.val for x in r_gp] == [int(v, 16) for v in fx["r_grand_product"]]
    bad = json.loads(json.dumps(fx))
    lc = bad["layers"][1]["left_claims"]
    lc[0] = hex((int(lc[0], 16) + 1) % P)
    with pytest.raises(SolidityRevert):
        vm.call("GrandProductVerifier.verify", _sol_gp_proof(vm, bad),
                claims, _sol_transcript(vm, b"test_transcript"))


def _g1p(vm, d):
    return vm.make_struct("HyperKZG.G1Point", x=int(d["x"], 16),
                          y=int(d["y"], 16))


def _g2p(vm, d):
    # the fixture keeps Fq2 as (real, imaginary); the precompile and the
    # struct take the imaginary part first
    return vm.make_struct("HyperKZG.G2Point",
                          x=[int(d["x"][1], 16), int(d["x"][0], 16)],
                          y=[int(d["y"][1], 16), int(d["y"][0], 16)])


def test_hyperkzg_verifier_accepts_and_reverts(vm):
    fx = _committed("hyperkzg")
    vk = vm.make_struct("HyperKZG.VerifierKey", g1=_g1p(vm, fx["vk"]["g1"]),
                        g2=_g2p(vm, fx["vk"]["g2"]),
                        betaG2=_g2p(vm, fx["vk"]["beta_g2"]))
    proof = vm.make_struct(
        "HyperKZG.HyperKZGProof",
        com=[_g1p(vm, p) for p in fx["proof"]["com"]],
        w=[_g1p(vm, p) for p in fx["proof"]["w"]],
        v=[vm.fr(int(x, 16)) for row in fx["proof"]["v"] for x in row])
    point = [vm.fr(int(x, 16)) for x in fx["point"]]
    opening = int(fx["opening"], 16)
    vm.call("HyperKZG.verify", proof, vk,
            _sol_transcript(vm, b"test_transcript"), point, vm.fr(opening),
            _g1p(vm, fx["commitment"]))
    with pytest.raises(SolidityRevert):
        vm.call("HyperKZG.verify", proof, vk,
                _sol_transcript(vm, b"test_transcript"), point,
                vm.fr((opening + 1) % P), _g1p(vm, fx["commitment"]))


def _sol_spartan_proof(vm, fx, bump: int | None = None):
    evals = [int(c, 16) for c in fx["claimed_witness_evals"]]
    if bump is not None:
        evals[bump] = (evals[bump] + 1) % P
    az, bz, cz = (vm.fr(int(c, 16)) for c in fx["outer_claims"])
    return vm.make_struct(
        "SpartanVerifier.SpartanProof",
        outer=_sol_sumcheck_proof(vm, [[int(c, 16) for c in r]
                                       for r in fx["outer_sumcheck"]]),
        outerClaimAz=az, outerClaimBz=bz, outerClaimCz=cz,
        inner=_sol_sumcheck_proof(vm, [[int(c, 16) for c in r]
                                       for r in fx["inner_sumcheck"]]),
        claimedWitnessEvals=[vm.fr(v) for v in evals])


def test_spartan_verifier_accepts_and_reverts(vm):
    fx = _committed("spartan")
    point = vm.call("SpartanVerifier.verifySpartan",
                    _sol_spartan_proof(vm, fx), fx["steps_bits"],
                    _sol_transcript(vm, b"test_transcript"))
    assert len(point) == fx["steps_bits"]
    with pytest.raises(SolidityRevert):
        vm.call("SpartanVerifier.verifySpartan",
                _sol_spartan_proof(vm, fx, bump=3), fx["steps_bits"],
                _sol_transcript(vm, b"test_transcript"))


# ---------------------------------------------------------------------------
# cli.py new
# ---------------------------------------------------------------------------

def test_new_writes_jolt_tpus_templates_for_the_port(tmp_path):
    proj = tmp_path / "demo"
    cli.main(["new", str(proj), "--pcs", "mock"])
    ctx = {"name": "demo", "pcs": "mock"}
    for fname, template in (("guest.py", jcli._GUEST_TEMPLATE),
                            ("host.py", jcli._HOST_TEMPLATE),
                            ("README.md", jcli._README_TEMPLATE)):
        want = template.replace("jolt_tpu", "jolt_tpu_torch").format(**ctx)
        assert (proj / fname).read_text() == want, fname
    with pytest.raises(SystemExit, match="exists"):
        cli.main(["new", str(proj)])

    # the guest assembles and traces as jolt_tpu's template does
    spec = importlib.util.spec_from_file_location("demo_guest",
                                                  proj / "guest.py")
    guest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(guest)
    steps, io, rows = trace_program(guest.program(), rv32i_vm(), native=False)
    jguest = {}
    exec(jcli._GUEST_TEMPLATE.format(**ctx), jguest)
    jsteps, _, jrows = j_trace_program(jguest["program"](), j_rv32i_vm(),
                                       native=False)
    assert (len(steps), len(rows)) == (len(jsteps), len(jrows))
    key = lambda s: (s.bytecode_row.address, s.instruction_index, s.lookup_x,
                     s.lookup_y, list(s.memory_ops_val))
    assert [key(s) for s in steps] == [key(s) for s in jsteps]
