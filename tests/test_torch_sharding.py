"""The port's multi-device prover (parallel/sharding.py and mesh= through
the provers) on a virtual CPU mesh of 4 shards, against jolt_tpu.

A virtual mesh puts every shard on the CPU: the counterpart of jolt_tpu's
`--xla_force_host_platform_device_count` mesh, which its own
tests/test_sharding.py uses.  Every step still runs once per shard: the
round evaluations per shard and folded mod p, the binds per shard, the
batches zero-padded to the mesh size.  Checked, on numpy inputs from a
seed:

- pad_batch_to and the block, cyclic and replicated layouts against
  jolt_tpu's pad_batch_to and the arrays they split;
- one sharded GKR round at B = 11 (padded to 12) against jolt_tpu's
  _pair_cubic_evals and _pair_bind;
- sharded_msm (the window MSM) and kzg_commit_batch(mesh=) (the bitplane
  MSM, its fold split by sharded_masked_fold) over 16 points against
  jolt_tpu's g1_msm_host;
- the dense grand product at B = 11 against jolt_tpu's unsharded prover
  (state_history, claims, challenges), verified by the port's verifier;
  the toggled one against the port's unsharded prover, with host and
  device Fiat-Shamir;
- prove_arbitrary (n = 128, degree 3, cyclic) and prove_arbitrary_bot
  (block) against jolt_tpu's transcript, challenges and final values;
- surge_prove(mesh=) (XOR, C = 2, M = 2^4, 16 lookups) against
  jolt_tpu's transcript, verified;
  these three against jolt_tpu's outputs frozen in fixtures/port/mesh.npz
  by scripts/freeze_port_fixtures.py (its `mesh` case: about 70 s of XLA
  compiles; the `slow` test reruns it live);
- JoltVM.prove(mesh=) on fib(3) with HyperKZG against jolt_tpu's
  transcript frozen in fixtures/port/fib3_hyperkzg.npz, verified; the
  `slow` case proves fib(8) on rv32i_vm() with the mock PCS against
  fixtures/port/rv32i_fib8_mock.npz (minutes on the CPU);
- the refusals: a mesh that mixes device types, a CUDA mesh without a
  card, a shard on another device than its mesh says.

The tolerance is zero.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.curve.bn254 import G1Jacobian as JG1Jacobian
from jolt_tpu.curve.bn254 import g1_msm_host
from jolt_tpu.field import device as jfd
from jolt_tpu.field import fq_spec as jfq_spec
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.parallel import sharding as jsh
from jolt_tpu.subprotocols import grand_product as jgp
from jolt_tpu_torch import _native as nat
from jolt_tpu_torch import cli
from jolt_tpu_torch.commitment.fixtures import states
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
from jolt_tpu_torch.commitment.kzg import kzg_commit_batch
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.convert import (limbs_from_numpy, limbs_to_numpy,
                                    scalars_to_numpy)
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.instructions import XorInstruction
from jolt_tpu_torch.lasso import SurgePreprocessing, surge_prove, surge_verify
from jolt_tpu_torch.parallel import sharding as sh
from jolt_tpu_torch.subprotocols import grand_product as tgp
from jolt_tpu_torch.subprotocols import sumcheck
from jolt_tpu_torch.transcript import Transcript
from jolt_tpu_torch.vm import fixtures as fx
from jolt_tpu_torch.vm.host import fibonacci_program, trace_program

ROOT = Path(__file__).resolve().parents[1]
JFR, JFQ, FR = jfr_spec(), jfq_spec(), fr_spec()
D = 4
B = 11
ON = {"JOLT_TPU_DEVICE_FS": "1", "JOLT_TPU_CHAIN": "1"}
OFF = {"JOLT_TPU_DEVICE_FS": "0", "JOLT_TPU_CHAIN": "0"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and the
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    return sh.make_mesh(D, device="cpu")


def _freeze_script():
    """scripts/freeze_port_fixtures.py: the inputs, and jolt_tpu's side."""
    spec = importlib.util.spec_from_file_location(
        "freeze_port_fixtures", ROOT / "scripts" / "freeze_port_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return _freeze_script().mesh_inputs()


@pytest.fixture(scope="module")
def frozen():
    with np.load(ROOT / "fixtures" / "port" / "mesh.npz") as z:
        return {k: z[k] for k in z.files}


def _dev(vals: np.ndarray) -> torch.Tensor:
    return fd.ints_to_device(FR, vals.tolist(), "cpu")


def _mont_limbs(rng, shape):
    """Random Montgomery Fr limbs uint32 [16, *shape]."""
    n = int(np.prod(shape))
    words = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64)
    vals = [sum(int(w) << (64 * k) for k, w in enumerate(row)) % JFR.p
            for row in words]
    return jfd.pack_ints(vals, shape)


def _np(t: torch.Tensor) -> np.ndarray:
    return limbs_to_numpy(t)


def _set_modes(monkeypatch, mode):
    for k, v in mode.items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def test_pad_batch_to_matches_jolt_tpu():
    rng = np.random.default_rng(1)
    arr = np.ascontiguousarray(np.moveaxis(_mont_limbs(rng, (B, 8)), 0, 1))
    want = np.asarray(jsh.pad_batch_to(jnp.asarray(arr), D))
    got = sh.pad_batch_to(limbs_from_numpy(arr), D)
    assert want.shape == (12, 16, 8)
    assert (_np(got) == want).all()
    assert sh.pad_batch_to(limbs_from_numpy(arr[:8]), D).shape[0] == 8


@pytest.mark.parametrize("layout", ["block", "cyclic", "replicated"])
def test_hypercube_layouts_gather_back(mesh, layout):
    """Each layout's shards are the slices it names, and gather returns
    the array jolt_tpu shards (its gathered value is the array itself)."""
    rng = np.random.default_rng(2)
    arr = _mont_limbs(rng, (3, 32))
    jarr = np.asarray(jsh.maybe_shard_hypercube(None, jnp.asarray(arr)))
    x = sh.shard_hypercube(mesh, limbs_from_numpy(arr), layout=layout)
    assert len(x.shards) == D and x.layout == layout
    for j, s in enumerate(x.shards):
        want = {"block": arr[..., 8 * j:8 * (j + 1)],
                "cyclic": arr[..., j::D], "replicated": arr}[layout]
        assert (_np(s) == want).all()
    assert (_np(x.gather()) == jarr).all()


def test_batch_sharding_pads_and_gathers(mesh):
    rng = np.random.default_rng(3)
    l = np.ascontiguousarray(np.moveaxis(_mont_limbs(rng, (B, 8)), 0, 1))
    r = np.ascontiguousarray(np.moveaxis(_mont_limbs(rng, (B, 8)), 0, 1))
    sl, sr = sh.maybe_shard_pair(mesh, (limbs_from_numpy(l),
                                        limbs_from_numpy(r)))
    (ll, lr), = sh.shard_gp_pair_layers(mesh, [(limbs_from_numpy(l),
                                                limbs_from_numpy(r))])
    for x, a in ((sl, l), (sr, r), (ll, l), (lr, r)):
        assert [s.shape[0] for s in x.shards] == [3] * D and x.real == B
        want = np.asarray(jsh.pad_batch_to(jnp.asarray(a), D))
        assert (_np(x.gather()) == want).all()
    sums = sh.shard_sumcheck_polys(mesh, [limbs_from_numpy(_mont_limbs(
        rng, (4,)))])                     # too small to split: stays whole
    assert not sh.is_sharded(sums[0])


# ---------------------------------------------------------------------------
# the sharded steps
# ---------------------------------------------------------------------------

def test_sharded_gp_round_matches_jolt_tpu(mesh):
    """B = 11 circuits padded to 12, three per shard: the folded
    evaluations and the bound layers equal jolt_tpu's on the unpadded
    batch; K2 and K3 run once per shard."""
    rng = np.random.default_rng(4)
    s = 16
    l = np.ascontiguousarray(np.moveaxis(_mont_limbs(rng, (B, s)), 0, 1))
    r = np.ascontiguousarray(np.moveaxis(_mont_limbs(rng, (B, s)), 0, 1))
    eq, coeffs = _mont_limbs(rng, (s,)), _mont_limbs(rng, (B,))
    chal = 0x1234567 ** 9 % JFR.p
    want_e = jgp._pair_cubic_evals(JFR, *map(jnp.asarray, (l, r, eq, coeffs)))
    want_l, want_r, want_eq = jgp._pair_bind(
        JFR, *map(jnp.asarray, (l, r, eq)), jfd.scalar_to_device(JFR, chal))

    calls = {"evals": 0, "bind": 0}
    ev, bd = sh.fk.gp_pair_evals, sh.fk.gp_pair_bind

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    pl, pr = sh.maybe_shard_pair(mesh, (limbs_from_numpy(l),
                                        limbs_from_numpy(r)))
    cd = limbs_from_numpy(np.concatenate(
        [coeffs, np.zeros((16, 1), np.uint32)], axis=1))
    mp = pytest.MonkeyPatch()
    mp.setattr(sh.fk, "gp_pair_evals", count("evals", ev))
    mp.setattr(sh.fk, "gp_pair_bind", count("bind", bd))
    try:
        e, nl, nr, neq = sh.sharded_gp_round(
            mesh, FR, pl, pr, limbs_from_numpy(eq), cd,
            fd.scalar_to_device(FR, chal, "cpu"))
    finally:
        mp.undo()
    assert calls == {"evals": D, "bind": D}
    assert (_np(e) == np.asarray(want_e)).all()
    assert (_np(nl.gather())[:B] == np.asarray(want_l)).all()
    assert (_np(nr.gather())[:B] == np.asarray(want_r)).all()
    assert (_np(neq.gather()) == np.asarray(want_eq)).all()
    assert (_np(nl.gather())[B:] == 0).all()


@pytest.fixture(scope="module")
def srs16():
    """16 SRS points (the port's HyperKZG setup, from the committed SRS
    fixture): the port's prover key and jolt_tpu's affine points."""
    pk = HyperKZG.setup(16, device="cpu").pk
    X, Y, Z = (jfd.unpack_ints(_np(t[:, :16])) for t in pk.g1_jac)
    pts = [JG1Jacobian(JFQ.from_mont(int(a)), JFQ.from_mont(int(b)),
                       JFQ.from_mont(int(c))).to_affine()
           for a, b, c in zip(X, Y, Z)]
    return pk, pts


@pytest.mark.parametrize("kind", ["windows", "bitplane"])
def test_sharded_msm_matches_the_host_msm(mesh, srs16, kind):
    pk, pts = srs16
    rng = np.random.default_rng(5)
    scalars = [int(v) for v in rng.integers(0, 1 << 62, 16)]
    scalars[3] = JFR.p - 1
    scalars[7] = 0
    mont = fd.ints_to_device(FR, scalars, "cpu")
    want = g1_msm_host(pts, scalars)
    if kind == "windows":
        got = sh.sharded_msm(mesh, tuple(t[:, :16] for t in pk.g1_jac), mont)
    else:
        assert sh.points_split(mesh, 16)
        got, = kzg_commit_batch(pk, [mont], mesh=mesh)
    assert (got.x, got.y, got.is_infinity) == \
        (want.x, want.y, want.is_infinity)


# ---------------------------------------------------------------------------
# the provers on a mesh
# ---------------------------------------------------------------------------

def test_dense_grand_product_on_a_mesh_matches_jolt_tpu(mesh, monkeypatch,
                                                       inputs, frozen):
    """B = 11 circuits of 16 leaves, padded to 12 over 4 shards: the same
    claims, transcript and layer claims as jolt_tpu's unsharded prover
    (device Fiat-Shamir on: K9's round glue on the folded evaluations),
    and the port's verifier accepts the proof."""
    _set_modes(monkeypatch, ON)
    g = tgp.BatchedDenseGrandProduct.construct(_dev(inputs["gp_leaves"]),
                                               FR, mesh=mesh)
    assert all(sh.is_sharded(x) and x.length == 12 and x.real == B
               for pair in g.layers for x in pair)
    claims = g.claims()
    assert (scalars_to_numpy(claims) == frozen["gp_claims"]).all()
    tt = Transcript(b"gp")
    proof, r = g.prove(tt)
    assert (states(tt) == frozen["gp_states"]).all()
    assert (scalars_to_numpy(r) == frozen["gp_r"]).all()
    assert all(len(lp.left_claims) == B for lp in proof.layers)
    assert (np.concatenate([scalars_to_numpy(lp.left_claims)
                            for lp in proof.layers]) ==
            frozen["gp_left"]).all()
    vt = Transcript(b"gp")
    vt.compare_to(tt)
    _, r_verify = tgp.verify_grand_product(proof, claims, vt)
    assert [x.v for x in r_verify] == [x.v for x in r]


@pytest.mark.parametrize("mode", [OFF, ON], ids=["host_fs", "device_fs"])
def test_toggled_grand_product_on_a_mesh(mesh, monkeypatch, mode):
    """3 memories (6 fingerprint rows, padded to 8) over T = 32: the toggle
    tensors split on the hypercube, the dense layers on the batch; the
    transcript equals the unsharded prover's."""
    _set_modes(monkeypatch, mode)
    rng = np.random.default_rng(7)
    bits = torch.from_numpy(rng.integers(0, 2, (3, 32)).astype(bool))
    fps = limbs_from_numpy(_mont_limbs(rng, (6, 32)))
    out = []
    for m in (None, mesh):
        g = tgp.ToggledBatchedGrandProduct(bits, fps, FR, mesh=m)
        t = Transcript(b"tgp")
        proof, r = g.prove(t)
        out.append((t.state_history, [x.v for x in r],
                    [[x.v for x in lp.right_claims] for lp in proof.layers]))
    assert sh.is_sharded(g.fingerprints) and g.fingerprints.local == 8
    assert out[0] == out[1]


@pytest.mark.parametrize("mode", [OFF, ON], ids=["host_fs", "device_fs"])
@pytest.mark.parametrize("order", ["top", "bot"])
def test_sumcheck_on_a_mesh_matches_jolt_tpu(mesh, monkeypatch, inputs,
                                             frozen, order, mode):
    """n = 128, degree 3 (the product of three MLEs), split cyclic for top
    binding and in blocks for bottom binding: jolt_tpu's transcript,
    challenges and final evaluations, with host and device Fiat-Shamir."""
    _set_modes(monkeypatch, mode)
    name = f"sc_{order}"
    polys = sh.shard_sumcheck_polys(mesh, [_dev(v) for v in inputs[name]],
                                    order=order)
    assert all(p.layout == sh.BIND_LAYOUT[order] for p in polys)
    fn = sumcheck.prove_arbitrary_bot if order == "bot" \
        else sumcheck.prove_arbitrary
    tt = Transcript(name.encode())
    _, r, fin = fn(7, polys, sumcheck.comb_product, 3, tt, FR)
    assert (states(tt) == frozen[f"{name}_states"]).all()
    assert (scalars_to_numpy(r) == frozen[f"{name}_r"]).all()
    assert (scalars_to_numpy(fin) == frozen[f"{name}_finals"]).all()
    other = sh.shard_sumcheck_polys(mesh, [polys[0].gather()],
                                    order="top" if order == "bot" else "bot")
    with pytest.raises(ValueError, match="does not keep"):
        fn(1, other, sumcheck.comb_product, 1, Transcript(b"x"), FR)


def test_surge_on_a_mesh_matches_jolt_tpu(mesh, monkeypatch, inputs, frozen):
    _set_modes(monkeypatch, OFF)
    pre = SurgePreprocessing(XorInstruction, 2, 16, device="cpu")
    proof, tt, _ = surge_prove(pre, MockCommitmentScheme(), inputs["surge_x"],
                               inputs["surge_y"], mesh=mesh)
    assert (states(tt) == frozen["surge_states"]).all()
    surge_verify(pre, proof, debug_transcript=tt)


@pytest.mark.slow
def test_frozen_mesh_fixture_matches_a_live_jolt_tpu_run(frozen):
    want = _freeze_script().mesh_arrays()
    assert sorted(want) == sorted(frozen)
    for k in want:
        assert (np.asarray(want[k]) == frozen[k]).all(), k


def _prove_case_on_mesh(mesh, vm, program, pcs, case_file, **trace_kw):
    steps, io, rows = trace_program(program, vm, **trace_kw)
    pre = vm.preprocess(rows, pcs, device="cpu")
    proof, com, tr, acc = vm.prove(io, steps, pre, mesh=mesh)
    with np.load(ROOT / "fixtures" / "port" / case_file) as z:
        want = {k: z[k] for k in z.files}
    digest = case_file.startswith("rv32i")
    assert fx.differing(fx.proof_arrays(tr, com, digest=digest), want) == []
    vm.verify(pre, proof, com, debug_transcript=tr, debug_accumulator=acc)


def test_jolt_vm_prove_on_a_mesh_matches_jolt_tpu(mesh, monkeypatch):
    """fib(3) on the mini VM (M = 2^8) with HyperKZG: every sumcheck, grand
    product and commit on the mesh; the transcript and commitments equal
    jolt_tpu's frozen ones, and the proof verifies."""
    _set_modes(monkeypatch, OFF)
    monkeypatch.setenv("JOLT_REFERENCE_PARITY", "0")
    vm = cli.fib_vm(fx.M_MINI)
    _prove_case_on_mesh(mesh, vm, fibonacci_program(fx.FIB_N),
                        HyperKZG.setup(fx.SRS_LEN, device="cpu"),
                        "fib3_hyperkzg.npz", max_input_size=32,
                        max_output_size=32)


@pytest.mark.slow
def test_rv32i_prove_on_a_mesh_matches_jolt_tpu(mesh, monkeypatch):
    """fib(8) on rv32i_vm() (M = 2^16) with the mock PCS on the mesh
    against fixtures/port/rv32i_fib8_mock.npz (minutes on the CPU)."""
    from jolt_tpu_torch.vm.rv32i_vm import rv32i_vm
    monkeypatch.setenv("JOLT_REFERENCE_PARITY", "0")
    program, inputs = fx.case_program("rv32i_fib8_mock")
    vm = rv32i_vm()
    steps, io, rows = trace_program(program, vm, inputs=inputs)
    pre = vm.preprocess(rows, MockCommitmentScheme(), device="cpu")
    proof, com, tr, acc = vm.prove(io, steps, pre, mesh=mesh)
    with np.load(ROOT / "fixtures" / "port" / "rv32i_fib8_mock.npz") as z:
        want = {k: z[k] for k in z.files}
    assert fx.differing(fx.proof_arrays(tr, com, digest=True), want) == []
    vm.verify(pre, proof, com, debug_transcript=tr, debug_accumulator=acc)


# ---------------------------------------------------------------------------
# refusals: nothing slides to another device
# ---------------------------------------------------------------------------

def test_meshes_that_would_mix_devices_are_refused(mesh):
    with pytest.raises(ValueError, match="mixes device types"):
        sh.Mesh(["cpu", "cuda:0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sh.make_mesh(2)
        with pytest.raises(RuntimeError):
            sh.make_mesh(2, device="cuda")
    with pytest.raises(ValueError, match="virtual mesh needs"):
        sh.make_mesh(device="cpu")
    t = torch.zeros((16, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="where the mesh puts it"):
        sh.Sharded(mesh, (t, t, t, t.to("meta")), -1, "block", 16)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        nat.require_cuda("mont_mul", t)
