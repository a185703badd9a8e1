"""The port's device-resident Fiat-Shamir against the host transcript and
against jolt_tpu's, on the CPU (the kernels' plain versions), small.

- the plain Keccak events (utils/keccak_device.py) against the host
  Transcript for payloads of 0-68 bytes, and against jolt_tpu's
  transcript_event (live, jitted) on three inputs;
- scalar_be_words, words_to_mont (all-ones digests and digests in [5p,
  2^256) among them) and vinv_mont against host integers;
- fs_round_plain against jolt_tpu's fs_cubic_round_jit over three chained
  rounds, each round starting from jolt_tpu's state carried across by
  convert.fs_state_from_jax;
- the chained-mode glue (challenge_vector_dev, append_scalars_dev,
  layer_events_dev, eq_masked_br, rebuild_rs, fold_lr_dev,
  pair_finals_dev, toggle_finals_dev) against host oracles;
- each sumcheck-shaped prover (the dense and the toggled grand product,
  prove_arbitrary, prove_arbitrary_bot with a claim, the opening reduction
  over polynomials of unequal sizes, the instruction lookups' primary
  sumcheck) with device Fiat-Shamir and the chain on against the same
  prover with them off: proofs and state_history equal;
- the chained dense and toggled grand products against jolt_tpu's run
  with JOLT_TPU_DEVICE_FS=1 JOLT_TPU_CHAIN=1 JOLT_TPU_HOST_TAIL=0, frozen
  in fixtures/port/fs_device.npz by scripts/freeze_port_fixtures.py (its
  `fs_device` case: seconds of XLA compiles; the `slow` test reruns it
  live): transcripts, challenges, claims and span rows;
- a device chain that differs from the host transcript raises;
- `slow`: the whole fib(3) mock prove on the mini VM with device
  Fiat-Shamir and the chain on, whose transcript must equal
  fixtures/port/fib3_mock.npz and whose span rows must equal jolt_tpu's in
  the same mode (fixtures/port/fib3_spans_chain.json); the port's verifier
  accepts it.  It takes about 30-35 s on a CPU core (the plain Keccak is
  some 2.5 ms a permutation); a Surge XOR prove with the chain on against the
  same prove with it off stands in for it in tier 1.

The tolerance is zero.
"""
import importlib.util
import json
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu.utils import keccak_device as jkd
from jolt_tpu_torch import cli
from jolt_tpu_torch.commitment.fixtures import states
from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
from jolt_tpu_torch.convert import (fs_state_from_jax, limbs_from_numpy,
                                    scalars_to_numpy)
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field.host import FElt
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.instructions import (AddInstruction, BeqInstruction,
                                         XorInstruction)
from jolt_tpu_torch.lasso import SurgePreprocessing, surge_prove, surge_verify
from jolt_tpu_torch.poly import mle
from jolt_tpu_torch.poly.opening_proof import ProverOpeningAccumulator
from jolt_tpu_torch.subprotocols import fs_device as fsd
from jolt_tpu_torch.subprotocols import grand_product as gp
from jolt_tpu_torch.subprotocols import sumcheck
from jolt_tpu_torch.subtables.bitwise import XorSubtable
from jolt_tpu_torch.subtables.rv32i import (EqSubtable, IdentitySubtable,
                                            TruncateOverflowSubtable)
from jolt_tpu_torch.transcript import Transcript
from jolt_tpu_torch.utils import keccak_device as kd
from jolt_tpu_torch.utils import profiling
from jolt_tpu_torch.vm import fixtures as fx
from jolt_tpu_torch.vm import instruction_lookups as il
from jolt_tpu_torch.vm.host import fibonacci_program, trace_program

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "fixtures" / "port" / "fs_device.npz"
FR = fr_spec()
ON = {"JOLT_TPU_DEVICE_FS": "1", "JOLT_TPU_CHAIN": "1"}
OFF = {"JOLT_TPU_DEVICE_FS": "0", "JOLT_TPU_CHAIN": "0"}
DEVICE_ONLY = {"JOLT_TPU_DEVICE_FS": "1", "JOLT_TPU_CHAIN": "0"}


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
def frozen():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def inputs():
    return _freeze_script().fs_device_inputs()


def _words(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, "<u4").astype(np.int64))


def _in_modes(monkeypatch, fn):
    """fn() with device Fiat-Shamir and the chain off, with device
    Fiat-Shamir alone, and with both on."""
    out = []
    for mode in (OFF, DEVICE_ONLY, ON):
        for k, v in mode.items():
            monkeypatch.setenv(k, v)
        out.append(fn())
    return out


# ---------------------------------------------------------------------------
# Keccak and the field conversions
# ---------------------------------------------------------------------------

def test_plain_events_match_the_host_transcript():
    host = Transcript(b"keccak")
    state = fsd.state_to_device(host, "cpu")
    for nbytes in range(0, 72, 4):
        data = bytes((7 * i + nbytes) % 256 for i in range(nbytes))
        host.append_bytes(data)
        state = kd.transcript_event(state, _words(data))
        assert fsd.state_bytes(state) == (host.state, host.n_rounds), nbytes


def test_events_match_jolt_tpus_transcript_event():
    """jolt_tpu's transcript_event, jitted, on three inputs."""
    import jax
    event = jax.jit(jkd.transcript_event)
    rng = np.random.default_rng(4)
    for nwords in (0, 8, 8):
        words = rng.integers(0, 1 << 32, size=8, dtype=np.uint64)
        nr = int(rng.integers(0, 1 << 32))
        payload = rng.integers(0, 1 << 32, size=nwords, dtype=np.uint64)
        want = np.asarray(event(words.astype(np.uint32), np.uint32(nr),
                                payload.astype(np.uint32)))
        state = fs_state_from_jax(words, nr)
        got = kd.transcript_event(state, torch.from_numpy(
            payload.astype(np.int64)))
        assert (got[:8].numpy() == want.astype(np.int64)).all()
        assert int(got[8]) == (nr + 1)


def test_scalar_be_words_and_words_to_mont():
    p = FR.p
    vals = [0, 1, p - 1, FR.r, 12345 ** 20 % p]
    got = kd.scalar_be_words(FR, fd.ints_to_device(FR, vals, "cpu"))
    for j, v in enumerate(vals):
        assert got[:, j].numpy().astype("<u4").tobytes() == v.to_bytes(32,
                                                                        "big")
    # digests: all ones, [5p, 2^256), and small
    digests = [(1 << 256) - 1, 5 * p, 5 * p + 99, (1 << 256) - p, 3]
    words = torch.stack([_words(d.to_bytes(32, "big")) for d in digests],
                        dim=1)
    mont = kd.words_to_mont(FR, words)
    assert mont.dtype == torch.int32
    assert [int(v) for v in fd.device_to_ints(FR, mont).tolist()] == \
        [d % p for d in digests]
    one = kd.words_to_mont(FR, _words(((1 << 256) - 1).to_bytes(32, "big")))
    assert fd.to_int(FR, one) == ((1 << 256) - 1) % p


# ---------------------------------------------------------------------------
# K8's and K9's warp Keccak, modelled in numpy on its own lane tables
# ---------------------------------------------------------------------------

U32 = np.uint64(0xFFFFFFFF)


def _cu_array(name: str) -> np.ndarray:
    """A constant array of csrc/keccak.cu, read from the source's text."""
    src = (ROOT / "jolt_tpu_torch" / "csrc" / "keccak.cu").read_text()
    body = re.search(name + r"\[[^=]*= \{(.*?)\};", src, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    return np.array([int(v.rstrip("ul"), 0)
                     for v in re.findall(r"0x[0-9a-fA-F]+ull|\d+", body)],
                    dtype=np.uint64)


def _fsl(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the high word of (hi:lo) << (s mod 32)."""
    v = (hi << np.uint64(32)) | lo
    return ((v << (np.asarray(s, np.uint64) & np.uint64(31)))
            >> np.uint64(32)) & U32


class _WarpKeccak:
    """keccak.cu's keccak_f_warp, kf_load_state and kf_absorb over the 32
    lanes of a warp (lane t holds state lane t): a shuffle from lane src
    is v[src]."""

    def __init__(self):
        tab = _cu_array("KF_TABLE").reshape(32, 16).astype(np.int64)
        self.column, self.left, self.right = tab[:, 0:4], tab[:, 4], tab[:, 5]
        self.chi, self.rot = tab[:, 6:9], tab[:, 9]
        self.rc = _cu_array("KECCAK_RC")
        self.lane = np.arange(32)

    @staticmethod
    def load(words):
        """Lanes 0-24 from a state's 50 words."""
        lo = np.zeros(32, np.uint64)
        hi = np.zeros(32, np.uint64)
        lo[:25], hi[:25] = words[0::2], words[1::2]
        return lo, hi

    def permute(self, lo, hi):
        iota = self.lane == 0
        for rnd in range(24):
            cl, ch = lo.copy(), hi.copy()
            for j in range(4):
                cl ^= lo[self.column[:, j]]
                ch ^= hi[self.column[:, j]]
            ml, mh = cl[self.left], ch[self.left]
            pl, ph = cl[self.right], ch[self.right]
            al = lo ^ ml ^ _fsl(ph, pl, 1)
            ah = hi ^ mh ^ _fsl(pl, ph, 1)
            P, Q = _fsl(al, ah, self.rot), _fsl(ah, al, self.rot)
            swap = self.rot >= 32
            bh, bl = np.where(swap, Q, P), np.where(swap, P, Q)
            rl, rh = self.rc[rnd] & U32, self.rc[rnd] >> np.uint64(32)
            out = []
            for b, rk in ((bl, rl), (bh, rh)):
                c = [b[self.chi[:, j]] for j in range(3)]
                out.append((c[0] ^ np.where(iota, rk, np.uint64(0)))
                           ^ (~c[1] & U32 & c[2]))
            lo, hi = out
        return lo, hi

    def event(self, lo, hi, n, payload):
        """kf_absorb of event n (payload: 8 words, or None) and the
        permutation."""
        t = self.lane
        lo, hi = np.where(t < 4, lo, 0), np.where(t < 4, hi, 0)
        hi[7] = int.from_bytes(int(n).to_bytes(4, "big"), "little")
        if payload is not None:
            lo[8:12], hi[8:12] = payload[0::2], payload[1::2]
        lo[8 if payload is None else 12] ^= np.uint64(1)
        hi[16] ^= np.uint64(0x80000000)
        return self.permute(lo, hi)


def test_warp_keccak_tables_run_keccak_f():
    """One permutation through KF_TABLE's shuffles == keccak_f_plain, on
    random states."""
    wk = _WarpKeccak()
    rng = np.random.default_rng(11)
    for _ in range(3):
        words = rng.integers(0, 1 << 32, size=50, dtype=np.uint64)
        lo, hi = wk.permute(*wk.load(words))
        want = kd.keccak_f_plain(torch.from_numpy(
            words.astype(np.int64))).numpy().astype(np.uint64)
        assert (lo[:25] == want[0::2]).all() and (hi[:25] == want[1::2]).all()


def test_warp_keccak_events_match_transcript_event():
    """kf_load_state, then appends and challenges through kf_absorb and the
    warp permutation: the digest lanes equal transcript_event's state."""
    wk = _WarpKeccak()
    rng = np.random.default_rng(12)
    state = torch.from_numpy(np.append(rng.integers(0, 1 << 32, size=8),
                                       (1 << 32) - 3).astype(np.int64))
    words = np.zeros(50, np.uint64)
    words[:8] = state[:8].numpy()
    lo, hi = wk.load(words)
    n = int(state[8])
    for payload in (rng.integers(0, 1 << 32, size=8, dtype=np.uint64), None,
                    None, rng.integers(0, 1 << 32, size=8, dtype=np.uint64)):
        lo, hi = wk.event(lo, hi, n, payload)
        n = (n + 1) & 0xFFFFFFFF
        state = kd.transcript_event(state, state.new_zeros(0) if payload is
                                    None else torch.from_numpy(
                                        payload.astype(np.int64)))
        digest = np.stack([lo[:4], hi[:4]], 1).reshape(8)
        assert (digest.astype(np.int64) == state[:8].numpy()).all()


def test_merged_layer_events_equal_the_three_calls():
    """A chained layer's one K8 list (appends, r_layer, the next layer's
    coefficients) == the three lists it replaces, run one after another."""
    rng = random.Random(13)
    host = Transcript(b"merged")
    state = fsd.state_to_device(host, "cpu")
    claims = fd.ints_to_device(FR, [rng.randrange(FR.p) for _ in range(6)],
                               "cpu")
    merged = kd.transcript_events_plain(
        FR, state, claims, [(kd.APPEND, 6), (kd.CHALLENGE, 1),
                            (kd.CHALLENGE, 3)])
    s1, _ = kd.transcript_events_plain(FR, state, claims, [(kd.APPEND, 6)])
    s2, r_layer = kd.transcript_events_plain(FR, s1, None,
                                             [(kd.CHALLENGE, 1)])
    s3, coeffs = kd.transcript_events_plain(FR, s2, None,
                                            [(kd.CHALLENGE, 3)])
    assert torch.equal(merged[0], s3)
    assert torch.equal(merged[1], torch.cat([r_layer, coeffs], dim=1))


def test_chained_grand_products_launch_k8_once_per_layer(monkeypatch,
                                                         inputs):
    """K8's calls in the chained grand products: one for the first
    coefficients and one per layer; the toggled one adds its final
    claim appends (its toggle vector rides on the last layer's call)."""
    for k, v in ON.items():
        monkeypatch.setenv(k, v)
    calls = []
    events = kd.transcript_events

    def counted(*args):
        calls.append(args[3])
        return events(*args)
    monkeypatch.setattr(kd, "transcript_events", counted)
    leaves = fd.ints_to_device(FR, inputs["gp_leaves"].tolist(), "cpu")
    fps = fd.ints_to_device(FR, inputs["tg_fps"].tolist(), "cpu")
    dense = gp.BatchedDenseGrandProduct.construct(leaves, FR)
    n_dense = dense.num_layers()
    dense.prove(Transcript(b"gp"))
    assert len(calls) == n_dense + 1
    calls.clear()
    tg = gp.ToggledBatchedGrandProduct(torch.from_numpy(inputs["tg_bits"]),
                                       fps, FR)
    n_tg = len(tg.layers)
    tg.prove(Transcript(b"tg"))
    assert len(calls) == n_tg + 2
    assert calls[-2][-1] == (kd.CHALLENGE, tg.real_batch)


@pytest.mark.parametrize("npts", [2, 3, 4, 9])
def test_vinv_mont_inverts_the_vandermonde_matrix(npts):
    """V^-1 V = I with V[x][j] = x^j (host integers)."""
    p = FR.p
    vinv = [[FR.from_mont(v) for v in row] for row in fsd.vinv_mont(FR, npts)]
    for r in range(npts):
        for c in range(npts):
            acc = sum(vinv[r][k] * pow(k, c, p) for k in range(npts)) % p
            assert acc == int(r == c)


# ---------------------------------------------------------------------------
# the round against jolt_tpu's fs_cubic_round_jit
# ---------------------------------------------------------------------------

def test_fs_round_plain_matches_jolt_tpus_cubic_round(frozen, inputs):
    """Three chained cubic rounds with the hint: each starts from jolt_tpu's
    state of the round before (fs_state_from_jax), and gives jolt_tpu's
    compressed poly, challenge, next claim and state."""
    host = Transcript(b"fs_round")
    state = fsd.state_to_device(host, "cpu")
    prev = fd.ints_to_device(FR, inputs["round_prev"].tolist(), "cpu")[:, 0]
    for j, e023 in enumerate(inputs["round_evals"]):
        evals = fd.ints_to_device(FR, e023.tolist(), "cpu")
        comp, rj, prev_out, state_out = fsd.fs_round_plain(
            FR, evals, prev, state, 3, True)
        for name, got in (("comp", comp), ("rj", rj), ("prev", prev_out)):
            assert torch.equal(got, limbs_from_numpy(
                frozen[f"round{j}_{name}"])), (j, name)
        want = fs_state_from_jax(frozen[f"round{j}_state"],
                                 frozen[f"round{j}_nr"])
        assert torch.equal(state_out, want), j
        # the port's host replay agrees: the round poly's bytes, then rj
        host.append_message(b"UniPoly_begin")
        for v in fd.device_to_ints(FR, comp).tolist():
            host.append_scalar(FElt(int(v), FR))
        host.append_message(b"UniPoly_end")
        assert host.challenge_scalar().v == fd.to_int(FR, rj)
        assert fsd.state_bytes(want) == (host.state, host.n_rounds)
        state, prev = want, limbs_from_numpy(frozen[f"round{j}_prev"])


@pytest.mark.parametrize("degree,use_hint,n",
                         [(2, True, 2), (3, True, 4), (3, False, 4),
                          (5, False, 6), (9, True, 9), (12, False, 13)])
def test_fs_round_plain_matches_the_host_round(degree, use_hint, n):
    """The round poly interpolated on the host (UniPoly), appended to a
    host transcript: the same compressed coefficients, challenge, claim."""
    rng = random.Random(degree * 10 + n)
    evals = [rng.randrange(FR.p) for _ in range(n)]
    prev = rng.randrange(FR.p)
    host = Transcript(b"round")
    comp, rj, prev_out, state = fsd.fs_round_plain(
        FR, fd.ints_to_device(FR, evals, "cpu"),
        fd.scalar_to_device(FR, prev, "cpu"),
        fsd.state_to_device(host, "cpu"), degree, use_hint)
    full = [FElt(v, FR) for v in evals]
    if n == degree:
        full.insert(1, FElt(0, FR))
    if use_hint:
        full[1] = FElt(prev, FR) - full[0]
    poly = sumcheck.UniPoly.from_evals(full)
    cpoly = poly.compress()
    cpoly.append_to_transcript(host)
    r = host.challenge_scalar()
    assert [int(v) for v in fd.device_to_ints(FR, comp).tolist()] == \
        [c.v for c in cpoly.coeffs_except_linear_term]
    assert fd.to_int(FR, rj) == r.v
    assert fd.to_int(FR, prev_out) == poly.evaluate(r).v
    assert fsd.state_bytes(state) == (host.state, host.n_rounds)


# ---------------------------------------------------------------------------
# the chain's glue against host oracles
# ---------------------------------------------------------------------------

def test_chain_glue_against_host_oracles():
    rng = random.Random(3)
    host = Transcript(b"glue")
    state = fsd.state_to_device(host, "cpu")
    coeffs, state = fsd.challenge_vector_dev(FR, state, 3)
    assert [int(v) for v in fd.device_to_ints(FR, coeffs).tolist()] == \
        [c.v for c in host.challenge_vector(3)]
    vals = [rng.randrange(FR.p) for _ in range(5)]
    state = fsd.append_scalars_dev(FR, state, fd.ints_to_device(
        FR, vals, "cpu"), 4)
    for v in vals[:4]:
        host.append_scalar(FElt(v, FR))
    for n_next in (2, 0):       # a layer's claims, r_layer, next coefficients
        claims = [rng.randrange(FR.p) for _ in range(6)]
        c, nxt, state = fsd.layer_events_dev(
            FR, state, fd.ints_to_device(FR, claims, "cpu"), 6, n_next)
        for v in claims:
            host.append_scalar(FElt(v, FR))
        assert fd.to_int(FR, c) == host.challenge_scalar().v
        assert nxt.shape == (16, n_next)
        assert [int(v) for v in fd.device_to_ints(FR, nxt).tolist()] == \
            [x.v for x in host.challenge_vector(n_next)]
    assert fsd.state_bytes(state) == (host.state, host.n_rounds)

    rs_vals = [rng.randrange(FR.p) for _ in range(4)]
    rs = fd.ints_to_device(FR, rs_vals, "cpu")
    for k in range(4):
        want = mle.eq_evals_device_br(FR, [FElt(v, FR) for v in rs_vals[:k]],
                                      "cpu")
        assert torch.equal(fsd.eq_masked_br(FR, rs, k), want)
    r_layer = fd.scalar_to_device(FR, 77, "cpu")
    out = fsd.rebuild_rs(rs, r_layer, 3)
    assert [int(v) for v in fd.device_to_ints(FR, out).tolist()] == \
        rs_vals[:3][::-1] + [77]
    buf = fd.zeros(FR, (3,), "cpu")
    fsd.set_col(buf, r_layer, 1)
    assert [int(v) for v in fd.device_to_ints(FR, buf).tolist()] == [0, 77, 0]

    B = 3
    lv = [rng.randrange(FR.p) for _ in range(B)]
    rv = [rng.randrange(FR.p) for _ in range(B)]
    l = fd.ints_to_device(FR, lv, "cpu").T.reshape(B, 16, 1)
    r = fd.ints_to_device(FR, rv, "cpu").T.reshape(B, 16, 1)
    lefts, rights, inter = fsd.pair_finals_dev(FR, l, r)
    assert [int(v) for v in fd.device_to_ints(FR, inter).tolist()] == \
        [x for pair in zip(lv, rv) for x in pair]
    folded = fsd.fold_lr_dev(FR, lefts, rights, r_layer)
    assert [int(v) for v in fd.device_to_ints(FR, folded).tolist()] == \
        [(a + 77 * (b - a)) % FR.p for a, b in zip(lv, rv)]
    joint = fsd.fold_claims_dev(FR, lefts, rights)
    assert fd.to_int(FR, joint) == sum(a * b for a, b in zip(lv, rv)) % FR.p

    fl = [rng.randrange(2) for _ in range(2)]
    fp = [rng.randrange(FR.p) for _ in range(4)]
    flags = fd.ints_to_device(FR, fl, "cpu").reshape(16, 2, 1)
    fps = fd.ints_to_device(FR, fp, "cpu").reshape(16, 4, 1)
    row = fsd.toggle_finals_dev(FR, flags, fps)
    assert [int(v) for v in fd.device_to_ints(FR, row).tolist()] == \
        [x for b in range(4) for x in (fl[b // 2], fp[b])]


def test_a_diverging_chain_raises():
    host = Transcript(b"diverge")
    state = fsd.state_to_device(host, "cpu")
    comp, _, _, state = fsd.fs_round_plain(
        FR, fd.ints_to_device(FR, [1, 2, 3], "cpu"),
        fd.scalar_to_device(FR, 5, "cpu"), state, 3, True)
    rows = fd.device_to_ints(FR, comp[:, None]).tolist()
    rows[0][0] = (rows[0][0] + 1) % FR.p
    with pytest.raises(RuntimeError, match="my protocol"):
        fsd.replay_and_check(FR, rows, host, state, sumcheck.CompressedUniPoly,
                             "my protocol")


# ---------------------------------------------------------------------------
# the provers, device Fiat-Shamir on against off
# ---------------------------------------------------------------------------

def _gp_record(proof, r, transcript):
    return (transcript.state_history, [x.v for x in r],
            [([c.v for p in lp.proof.compressed_polys
               for c in p.coeffs_except_linear_term],
              [x.v for x in lp.left_claims], [x.v for x in lp.right_claims])
             for lp in proof.layers])


def _field_ints(rng, *shape):
    return _freeze_script().field_ints(rng, *shape)


def test_dense_grand_product_modes_agree(monkeypatch, inputs):
    def run():
        leaves = fd.ints_to_device(FR, inputs["gp_leaves"].tolist(), "cpu")
        t = Transcript(b"gp")
        proof, r = gp.BatchedDenseGrandProduct.construct(leaves, FR).prove(t)
        return _gp_record(proof, r, t)
    off, dev_only, on = _in_modes(monkeypatch, run)
    assert off == dev_only == on


def test_toggled_grand_product_modes_agree(monkeypatch, inputs):
    def run():
        fps = fd.ints_to_device(FR, inputs["tg_fps"].tolist(), "cpu")
        circ = gp.ToggledBatchedGrandProduct(
            torch.from_numpy(inputs["tg_bits"]), fps, FR)
        t = Transcript(b"tg")
        proof, r = circ.prove(t)
        return _gp_record(proof, r, t)
    off, dev_only, on = _in_modes(monkeypatch, run)
    assert off == dev_only == on


def _sumcheck_polys(seed, n=8, k=3):
    vals = _field_ints(np.random.default_rng(seed), k, n)
    return [fd.ints_to_device(FR, row.tolist(), "cpu") for row in vals], vals


def _sc_record(proof, r, finals, transcript):
    return (transcript.state_history, [x.v for x in r], [x.v for x in finals],
            [[c.v for c in p.coeffs_except_linear_term]
             for p in proof.compressed_polys])


def test_prove_arbitrary_modes_agree(monkeypatch):
    def run():
        polys, _ = _sumcheck_polys(1)
        t = Transcript(b"sc")
        proof, r, finals = sumcheck.prove_arbitrary(
            3, polys, sumcheck.comb_product, 3, t, FR)
        return _sc_record(proof, r, finals, t)
    off, dev_only, on = _in_modes(monkeypatch, run)
    assert off == dev_only == on


def test_prove_arbitrary_bot_with_a_claim_modes_agree(monkeypatch):
    def run():
        polys, vals = _sumcheck_polys(2)
        claim = sum(int(a) * int(b) * int(c) for a, b, c in zip(*vals)) % FR.p
        t = Transcript(b"scbot")
        proof, r, finals = sumcheck.prove_arbitrary_bot(
            3, polys, sumcheck.comb_product, 3, t, FR, claim=FElt(claim, FR))
        return _sc_record(proof, r, finals, t)
    off, dev_only, on = _in_modes(monkeypatch, run)
    assert off == dev_only == on


def test_opening_reduction_of_unequal_sizes_modes_agree(monkeypatch):
    """Openings at 3, 2 and 1 variables: the smaller polynomials enter in
    later rounds, their claims folded in as constants until then."""
    def run():
        rng = np.random.default_rng(6)
        acc, t = ProverOpeningAccumulator(FR), Transcript(b"openings")
        for ell in (3, 2, 1):
            point = [FElt(int(x), FR) for x in _field_ints(rng, ell)]
            vals = _field_ints(rng, 2, 1 << ell)
            polys = fd.ints_to_device(FR, vals.tolist(), "cpu")
            acc.append([polys[:, i] for i in range(2)],
                       mle.eq_evals_device(FR, point, "cpu"), point,
                       [mle.evaluate_host([FElt(int(v), FR) for v in row],
                                          point) for row in vals], t)
        red = acc.reduce_and_prove(MockCommitmentScheme(), t)
        return (t.state_history, [x.v for x in red.sumcheck_claims],
                [[c.v for c in p.coeffs_except_linear_term]
                 for p in red.sumcheck_proof.compressed_polys])
    off, dev_only, on = _in_modes(monkeypatch, run)
    assert off == dev_only == on


def test_primary_sumcheck_modes_agree(monkeypatch):
    """prove_instruction_lookups' primary sumcheck (at pre.sumcheck_degree,
    6) on ADD / XOR / BEQ at C = 4, M = 2^8, T = 16 (jolt_tpu's
    tests/test_instruction_lookups.py's set).  Its memory checking, two
    grand products over 2^8 leaves that the tests above and the Surge test
    below cover, is left out here for time."""
    monkeypatch.setattr(il, "_prove_memory_checking", lambda *args: None)
    pre = il.InstructionLookupsPreprocessing(
        [AddInstruction, XorInstruction, BeqInstruction],
        [TruncateOverflowSubtable(32), IdentitySubtable(), XorSubtable(),
         EqSubtable()], 4, 1 << 8, "cpu", FR)
    rng = random.Random(5)
    T = 16
    instr = np.full(T, -1, dtype=np.int64)
    x = np.zeros(T, dtype=np.uint64)
    y = np.zeros(T, dtype=np.uint64)
    for j in range(11):
        instr[j] = rng.randrange(3)
        x[j], y[j] = rng.randrange(1 << 15), rng.randrange(1 << 15)

    polys = il.generate_witness(pre, instr, x, y)
    runs = []
    for mode in (OFF, ON):                # the primary sumcheck has no chain
        for k, v in mode.items():
            monkeypatch.setenv(k, v)
        t = Transcript(b"il")
        ps = il.prove_instruction_lookups(
            pre, polys, ProverOpeningAccumulator(FR), t).primary_sumcheck
        runs.append((t.state_history,
                     [[c.v for c in p.coeffs_except_linear_term]
                      for p in ps.sumcheck_proof.compressed_polys],
                     [v.v for v in ps.openings.E_poly_openings]))
    assert runs[0] == runs[1]
    assert pre.sumcheck_degree == 6


def test_full_vm_primary_degree_fits_k9():
    """K9 sizes its buffers from the round degree: rv32i_vm()'s primary
    sumcheck (degree 8) fits the 48 KiB a block takes without opting in,
    as every degree up to 37 does."""
    from jolt_tpu_torch.vm.rv32i_vm import rv32i_vm
    degree = max(cls().g_poly_degree(4)
                 for cls in rv32i_vm().instruction_classes) + 2
    assert degree == 8
    assert fsd.k9_smem_bytes(degree) <= fsd.k9_smem_bytes(37) <= 48 * 1024
    assert fsd.k9_smem_bytes(38) > 48 * 1024


@pytest.mark.parametrize("degree", [9, 12])
def test_prove_arbitrary_above_degree_8_matches_jolt_tpu(monkeypatch,
                                                        degree):
    """Rounds of degree 9 and 12 (the product of 9 and 12 MLEs over 2^3
    points), which device Fiat-Shamir refused while K9's buffers were
    sized for degree 8: with it on, the same transcript, challenges and
    final values as with it off and as jolt_tpu's (frozen in
    fixtures/port/fs_degree.npz by scripts/freeze_port_fixtures.py, its
    `fs_degree` case: minutes of XLA compiles)."""
    rows = _freeze_script().fs_degree_inputs()[f"deg{degree}"]
    with np.load(ROOT / "fixtures" / "port" / "fs_degree.npz") as z:
        want = {k: z[k] for k in z.files if k.startswith(f"deg{degree}_")}
    runs = []
    for mode in (OFF, DEVICE_ONLY):
        for k, v in mode.items():
            monkeypatch.setenv(k, v)
        polys = [fd.ints_to_device(FR, row.tolist(), "cpu") for row in rows]
        t = Transcript(f"deg{degree}".encode())
        proof, r, finals = sumcheck.prove_arbitrary(
            3, polys, sumcheck.comb_product, degree, t, FR)
        runs.append(_sc_record(proof, r, finals, t))
        assert (states(t) == want[f"deg{degree}_states"]).all()
        assert (scalars_to_numpy(r) == want[f"deg{degree}_r"]).all()
        assert (scalars_to_numpy(finals) == want[f"deg{degree}_finals"]).all()
    assert runs[0] == runs[1]


def test_surge_prove_with_the_chain_equals_the_host_prove(monkeypatch):
    """Surge XOR, 2^4 lookups, C = 2, M = 2^4 (prove_arbitrary and the
    chained grand products): the same transcript in each mode, and the
    chained proof verifies."""
    x, y = cli.surge_inputs(np.random.default_rng(2), 4)

    pre = SurgePreprocessing(XorInstruction, 2, 1 << 4, device="cpu")
    runs = []
    for mode in (OFF, ON):
        for k, v in mode.items():
            monkeypatch.setenv(k, v)
        proof, t, _ = surge_prove(pre, MockCommitmentScheme(), x % 16, y % 16)
        runs.append(t.state_history)
    assert runs[0] == runs[1]
    surge_verify(pre, proof, debug_transcript=t)


# ---------------------------------------------------------------------------
# the chained grand products against jolt_tpu's
# ---------------------------------------------------------------------------

def test_chained_grand_products_match_jolt_tpu(monkeypatch, frozen, inputs):
    for k, v in ON.items():
        monkeypatch.setenv(k, v)
    profiling.reset()
    profiling.enable()
    try:
        leaves = fd.ints_to_device(FR, inputs["gp_leaves"].tolist(), "cpu")
        fps = fd.ints_to_device(FR, inputs["tg_fps"].tolist(), "cpu")
        circuits = {"gp": gp.BatchedDenseGrandProduct.construct(leaves, FR),
                    "tg": gp.ToggledBatchedGrandProduct(
                        torch.from_numpy(inputs["tg_bits"]), fps, FR)}
        for name, circ in circuits.items():
            t = Transcript(name.encode())
            proof, r = circ.prove(t)
            got = {"states": states(t), "r": scalars_to_numpy(r),
                   "left": np.concatenate([scalars_to_numpy(lp.left_claims)
                                           for lp in proof.layers]),
                   "right": np.concatenate([scalars_to_numpy(lp.right_claims)
                                            for lp in proof.layers])}
            for key, arr in got.items():
                want = frozen[f"{name}_{key}"]
                assert arr.shape == want.shape and (arr == want).all(), \
                    (name, key)
    finally:
        profiling.enable(False)
    rows = sorted([n, c, o] for n, c, _, o in profiling.cumulative())
    assert rows == json.loads(str(frozen["spans"]))
    assert {r[0] for r in rows} == {"BatchedDenseGP::chained",
                                    "ToggledGP::chained"}


@pytest.mark.slow
def test_frozen_fs_device_fixture_matches_a_live_jolt_tpu_run(frozen):
    want = _freeze_script().fs_device_arrays()
    assert sorted(want) == sorted(frozen)
    for k in frozen:
        assert (np.asarray(want[k]) == frozen[k]).all(), k


# ---------------------------------------------------------------------------
# the whole path
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_fib3_whole_path_with_the_chain(monkeypatch):
    """fib(3) on the mini VM, the mock PCS, device Fiat-Shamir and the chain
    on: jolt_tpu's transcript (2,639 states) and jolt_tpu's chain-mode span
    rows (BatchedDenseGP::chained, ToggledGP::chained among them); the
    port's verifier accepts."""
    for k, v in {**ON, "JOLT_REFERENCE_PARITY": "0"}.items():
        monkeypatch.setenv(k, v)
    vm = cli.fib_vm(fx.M_MINI)
    steps, io, rows = trace_program(fibonacci_program(fx.FIB_N), vm,
                                    max_input_size=32, max_output_size=32)
    profiling.reset()
    profiling.enable()
    try:
        pre = vm.preprocess(rows, MockCommitmentScheme(), device="cpu")
        proof, com, t, acc = vm.prove(io, steps, pre)
    finally:
        profiling.enable(False)
    got = fx.proof_arrays(t, com)
    with np.load(ROOT / "fixtures" / "port" / "fib3_mock.npz") as z:
        assert sorted(got) == sorted(z.files)
        for k in z.files:
            assert (got[k] == z[k]).all(), k
    spans = sorted([n, c, o] for n, c, _, o in profiling.cumulative())
    want = json.loads((ROOT / "fixtures" / "port" / "fib3_spans_chain.json")
                      .read_text())["rows"]
    assert len(want) == 13        # no BatchedDenseGP::layer in this mode
    assert spans == want
    vm.verify(pre, proof, com, debug_transcript=t, debug_accumulator=acc)
