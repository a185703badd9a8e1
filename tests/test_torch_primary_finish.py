"""The primary sumcheck's round on the port's CPU path against jolt_tpu.

- the finisher's plain version, `primary_finish_plain` (sum_i eq[i] *
  (inner[i] - out[i]) over a round's half), against jolt_tpu's
  `_point_finish_jit` with its mask over the whole half, on strided
  halves as the round hands them over;
- the round kernel's plain version, `primary_round_plain` (the split, the
  extrapolation, the collations through the group plan, the finisher at
  each of the d + 1 points), and its wrapper `primary_round` on CPU
  tensors, against jolt_tpu's `_primary_round_evals_decomposed`, on a
  preprocessing of five instructions of the narrow VM at M = 2^8, on
  random and on edge residues;
- the collations and their sum (`collate_plain`, and through the group
  plan `collate_grouped_plain`) at a round's points against the sum of
  jolt_tpu's `_g_term_jit` terms for the same five instructions: t = 0
  and 1 the lo and hi halves of [16, m, 2H] and [16, NI, 2H] (strided
  views), t >= 2 contiguous tensors;
- the collations' constants (DevF's coerced ints): a second pass of the
  29 collations of rv32i_vm() uploads none, and every result equals the
  pass that uploaded each constant afresh.
Inputs are random field elements from numpy seeds; the tolerance is zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jolt_tpu.field import device as jfd
from jolt_tpu.field import fr_spec as jfr_spec
from jolt_tpu.instructions import RV32I_INSTRUCTIONS as J_INSTRUCTIONS
from jolt_tpu.vm import instruction_lookups as jil
from jolt_tpu.vm.rv32i_vm import RV32I_SUBTABLES as J_SUBTABLES
from jolt_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field import generic
from jolt_tpu_torch.field.generic import DevF
from jolt_tpu_torch.field.spec import fr_spec
from jolt_tpu_torch.instructions import RV32I_INSTRUCTIONS
from jolt_tpu_torch.vm import collation
from jolt_tpu_torch.vm import instruction_lookups as il
from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES

FR, JFR = fr_spec(), jfr_spec()
C, M_NARROW = 4, 1 << 8
# five of the narrow VM's instructions (tests/test_torch_rv32i.py's
# narrow_program runs 23): sums, bitwise concatenations, a signed and an
# unsigned comparison, and a shift, so that their collations differ
ROUND_INSTRUCTIONS = ("add", "xor", "slt", "sltu", "sll")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, shape) -> np.ndarray:
    """Canonical limbs uint32[16, *shape] of random residues mod FR.p (their
    Montgomery reading is as random), with 0 and p - 1 among them."""
    n = int(np.prod(shape))
    words = rng.integers(0, 1 << 64, size=(n, 4), dtype=np.uint64)
    vals = [sum(int(w) << (64 * k) for k, w in enumerate(row)) % FR.p
            for row in words]
    vals[:2] = [0, FR.p - 1][:n]
    return jfd.pack_ints(vals, shape)


@pytest.mark.parametrize("H", [1, 8, 64])
def test_primary_finish_plain_matches_point_finish(H):
    """eq, out: the lo halves of [16, 2H] tensors (strided views); inner
    a full [16, H] tensor; jolt_tpu's mask covers all H entries."""
    rng = np.random.default_rng(H)
    eq2, out2, inner = _rand(rng, (2 * H,)), _rand(rng, (2 * H,)), \
        _rand(rng, (H,))
    want = jil._point_finish_jit(JFR)(jnp.asarray(eq2[:, :H]),
                                      jnp.asarray(out2[:, :H]),
                                      jnp.asarray(inner), np.int32(H))
    teq, tout = limbs_from_numpy(eq2)[:, :H], limbs_from_numpy(out2)[:, :H]
    got = il.primary_finish_plain(FR, teq, tout, limbs_from_numpy(inner))
    assert (limbs_to_numpy(got) == np.asarray(want)).all()


def _classes(instructions):
    by = {c.name: c for c in instructions}
    return [by[name] for name in ROUND_INSTRUCTIONS]


def _round_pres():
    pre = il.InstructionLookupsPreprocessing(
        _classes(RV32I_INSTRUCTIONS), RV32I_SUBTABLES, C, M_NARROW, "cpu", FR)
    jpre = jil.InstructionLookupsPreprocessing(
        _classes(J_INSTRUCTIONS), J_SUBTABLES, C, M_NARROW, JFR)
    assert pre.instruction_to_memory_indices == \
        jpre.instruction_to_memory_indices
    return pre, jpre


def _check_round(pre, jpre, eq, out, fl, e, H):
    want = jil._primary_round_evals_decomposed(
        JFR, jpre.meta_key(), jpre.sumcheck_degree, *map(jnp.asarray,
                                                         (eq, out, fl, e)), H)
    ts = list(map(limbs_from_numpy, (eq, out, fl, e)))
    got = il.primary_round_plain(pre, *ts)
    assert got.shape == (16, pre.sumcheck_degree + 1)
    assert (limbs_to_numpy(got) == np.asarray(want)).all()
    assert torch.equal(il.primary_round(pre, *ts), got)


def test_primary_round_evals_match_decomposed():
    """One round at H = 4 (8 hypercube points) on random eq, out, flags
    and memories: [16, degree + 1] equal, point for point."""
    pre, jpre = _round_pres()
    H = 4
    rng = np.random.default_rng(12)
    eq, out = _rand(rng, (2 * H,)), _rand(rng, (2 * H,))
    fl = _rand(rng, (pre.num_instructions, 2 * H))
    e = _rand(rng, (pre.num_memories, 2 * H))
    _check_round(pre, jpre, eq, out, fl, e, H)


def test_primary_round_plain_matches_decomposed_on_edge_residues():
    """The same round's shapes (no new XLA program) with every input
    drawn from 0, 1, 2, p - 1, p - 2 and (p +- 1) / 2, so that hi - lo
    and the extrapolated points wrap around p."""
    pre, jpre = _round_pres()
    H = 4
    rng = np.random.default_rng(13)
    pool = [0, 1, 2, FR.p - 1, FR.p - 2, (FR.p - 1) // 2, (FR.p + 1) // 2]

    def edge(shape):
        vals = [pool[i] for i in rng.integers(0, len(pool),
                                              int(np.prod(shape)))]
        return jfd.pack_ints(vals, shape)

    _check_round(pre, jpre, edge((2 * H,)), edge((2 * H,)),
                 edge((pre.num_instructions, 2 * H)),
                 edge((pre.num_memories, 2 * H)), H)


def test_collate_matches_g_term_jit():
    """The three kinds of point a round collates: the lo and hi
    halves of e [16, m, 2H], flags [16, NI, 2H], and a contiguous t >= 2
    point; against jolt_tpu's terms summed mod p on the host.  H = 4, the
    round's shape above, whose five programs that test compiled."""
    H = 4
    pre = il.InstructionLookupsPreprocessing(
        _classes(RV32I_INSTRUCTIONS), RV32I_SUBTABLES, C, M_NARROW, "cpu", FR)
    rng = np.random.default_rng(104)
    e = _rand(rng, (pre.num_memories, 2 * H))
    fl = _rand(rng, (pre.num_instructions, 2 * H))
    e2 = _rand(rng, (pre.num_memories, H))
    fl2 = _rand(rng, (pre.num_instructions, H))
    te, tfl = limbs_from_numpy(e), limbs_from_numpy(fl)
    points = [(e[..., :H], fl[..., :H], te[..., :H], tfl[..., :H]),
              (e[..., H:], fl[..., H:], te[..., H:], tfl[..., H:]),
              (e2, fl2, limbs_from_numpy(e2), limbs_from_numpy(fl2))]
    for j_e, j_f, t_e, t_f in points:
        terms = [jfd.unpack_ints(np.asarray(jil._g_term_jit(
            JFR, cls, tuple(pre.instruction_to_memory_indices[k]), k, C,
            M_NARROW)(jnp.asarray(j_e), jnp.asarray(j_f))))
            for k, cls in enumerate(_classes(J_INSTRUCTIONS))]
        want = [sum(int(t[i]) for t in terms) % FR.p for i in range(H)]
        got = collation.collate_plain(pre, t_e, t_f)
        assert got.shape == (16, H) and got.is_contiguous()
        assert [int(v) for v in jfd.unpack_ints(limbs_to_numpy(got))] == want
        assert torch.equal(collation.collate_grouped_plain(pre, t_e, t_f),
                           got)


def _collations(vals_of):
    """Each of rv32i_vm()'s 29 instructions' collation at C = 4, M = 2^16
    on DevF tensors [16, 3] (vals_of(k, j): memory j's values)."""
    out = []
    for k, cls in enumerate(RV32I_INSTRUCTIONS):
        n_mem = sum(len(idx) for _, idx in cls().subtables(C, 1 << 16))
        vals = [DevF(vals_of(k, j), FR) for j in range(n_mem)]
        out.append(cls().combine_lookups(vals, C, 1 << 16).limbs)
    return out


def test_collation_constants_upload_once(monkeypatch):
    """The 29 collations with every constant uploaded afresh, then twice
    through DevF's cache: the first cached pass uploads each distinct
    constant once, the second none, and all three agree bit for bit."""
    assert len(RV32I_INSTRUCTIONS) == 29
    rng = np.random.default_rng(29)
    pool = limbs_from_numpy(_rand(rng, (64, 3)))
    vals_of = lambda k, j: pool[:, (5 * k + j) % 64]      # noqa: E731
    uploads = []
    scalar_to_device = fd.scalar_to_device

    def counted(spec, x, device):
        uploads.append(x)
        return scalar_to_device(spec, x, device)

    monkeypatch.setattr(fd, "scalar_to_device", counted)
    monkeypatch.setattr(generic, "const_limbs", counted)   # no cache
    fresh = _collations(vals_of)
    fresh_uploads = list(uploads)
    monkeypatch.undo()
    monkeypatch.setattr(fd, "scalar_to_device", counted)
    generic.const_limbs.cache_clear()
    uploads.clear()
    first = _collations(vals_of)
    assert sorted(uploads) == sorted(set(fresh_uploads))
    assert len(fresh_uploads) > len(uploads)
    uploads.clear()
    second = _collations(vals_of)
    assert uploads == []
    for a, b, c in zip(fresh, first, second):
        assert torch.equal(a, b) and torch.equal(b, c)
