"""K2's launch plan (field/kernels.py `gp_evals_plan`), the primary
round kernel's (vm/instruction_lookups.py `round_plan`, the group plan's
threads and shared memory) and K14-K17's (`toggle_plan`, `toggle_chunks`,
`reduction_plan`, the K15, K16 and K17 launches' caps) on the CPU.

The kernel (csrc/gp_pair.cu `gp_pair_evals_kernel`) maps block k, warp w
and lane to circuit group g = (k % shared) * per_block + w % per_block,
tile (k // shared + j * tile_blocks) * tiles_per_block + w // per_block
for j = 0, 1, ..., pair index tile * 32 + lane, and circuits g, g + groups,
...  `_cells` below walks that map for a plan, so these tests show that
every (circuit, pair index) is covered exactly once, within the kernel's
limits, for every batch size the provers use and every round size, and
that a batch above one launch's cap is split so that each circuit is
summed once.  For the round kernel: every (tile, point) of a round is
taken by exactly one block, the blocks' threads are 32 per group, at most
256, and the group plan's shared memory, as csrc/collate.cu computes it,
fits the H100's 227 KB for rv32i_vm(), the narrow VM and the mini VM.
For K14 (csrc/sumcheck_ops.cu `toggle_evals_kernel`): warp w of block k
takes tasks k * 8 + w, + 8 * blocks, ..., task = tile * groups + group,
and group g the memories g, g + groups, ...: every (pair index, memory)
once.  K16's threads take pair indices by grid stride, K15's and K17's
elements likewise; the wrappers' launches take each tensor, pair or
polynomial once.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jolt_tpu_torch import _native as nat
from jolt_tpu_torch.curve import kernels as ck  # noqa: F401 (registers K5-K7)
from jolt_tpu_torch.field import arith
from jolt_tpu_torch.field import device as fd
from jolt_tpu_torch.field import kernels as fk
from jolt_tpu_torch.field.spec import fr_spec

HS = sorted({*range(1, 40), 63, 64, 65, 100, 255, 256, 257, 1000,
             *(1 << k for k in range(20)), (1 << 19) - 1, (1 << 14) + 3})


def _cells(B, h, groups, blocks):
    """Count of visits per (group, tile) and the circuits of each group."""
    per_block = min(groups, fk.GP_WARPS)
    tpb = fk.GP_WARPS // per_block
    shared = groups // per_block
    tile_blocks = blocks // shared
    tiles = -(-h // fk.GP_TILE)
    k = np.arange(blocks)[:, None]
    w = np.arange(fk.GP_WARPS)[None, :]
    g = (k % shared) * per_block + w % per_block
    visits = np.zeros((groups, tiles), dtype=np.int64)
    tc = k // shared
    while True:
        live = tc * tpb < tiles
        if not live.any():
            break
        tile = tc * tpb + w // per_block
        ok = np.broadcast_to(live, tile.shape) & (tile < tiles)
        gg = np.broadcast_to(g, tile.shape)[ok]
        np.add.at(visits, (gg, tile[ok]), 1)
        tc = tc + tile_blocks
    circuits = [list(range(x, B, groups)) for x in range(groups)]
    return visits, circuits


@pytest.mark.parametrize("B", [1, 7, 8, 43, 64, 65, 81, 110, 128])
def test_plan_covers_each_pair_once(B):
    for h in HS:
        groups, blocks = fk.gp_evals_plan(B, h)
        per_block = min(groups, fk.GP_WARPS)
        assert groups in (1, 2, 4, 8) or groups % fk.GP_WARPS == 0
        assert groups <= fk.GP_MAX_B and 1 <= blocks <= fk.GP_MAX_BLOCKS
        assert blocks % (groups // per_block) == 0
        visits, circuits = _cells(B, h, groups, blocks)
        assert (visits == 1).all(), (B, h, groups, blocks)
        assert sorted(b for c in circuits for b in c) == list(range(B))
        if h <= 1 << 8:      # small rounds: one circuit per thread
            assert max(len(c) for c in circuits) == 1, (B, h, groups)


def test_plan_fills_the_card_at_the_fib_gp_round():
    groups, blocks = fk.gp_evals_plan(43, 1 << 14)
    assert blocks >= 132                     # a block on each of 132 SMs
    assert (1 << 14) // fk.GP_TILE * groups <= fk.GP_WAVE_WARPS


def test_plan_rejects_what_the_kernel_refuses():
    for B, h in ((0, 8), (fk.GP_MAX_B + 1, 8), (8, 0)):
        with pytest.raises(ValueError):
            fk.gp_evals_plan(B, h)


@pytest.mark.parametrize("B", [1, 64, 128, 129, 200, 256, 300])
def test_batches_above_the_cap_split_into_launches(B):
    """Each circuit lies in one launch, every launch has a plan, and the
    launches are as few as the cap allows."""
    chunks = fk.gp_batch_chunks(B)
    assert [b for b0, b1 in chunks for b in range(b0, b1)] == list(range(B))
    assert len(chunks) == -(-B // fk.GP_MAX_B)
    for b0, b1 in chunks:
        assert 1 <= b1 - b0 <= fk.GP_MAX_B
        fk.gp_evals_plan(b1 - b0, 1 << 10)


def test_split_evals_sum_to_the_whole_batch():
    """K2's evals are linear in the circuits: summed mod p over the
    launches' slices, as the wrapper adds them, they equal the
    whole batch's (plain versions on the CPU, B = 200 over two slices)."""
    spec = fr_spec()
    B, s = 200, 4
    g = torch.Generator().manual_seed(7)

    def rand(*shape):
        vals = torch.randint(0, 1 << 62, (int(np.prod(shape)),), generator=g)
        return fd.ints_to_device(spec, vals.tolist(), "cpu", shape)

    l = rand(B, s).movedim(0, 1).contiguous()
    r = rand(B, s).movedim(0, 1).contiguous()
    eq, coeffs = rand(s), rand(B)
    parts = [fk.gp_pair_evals_plain(spec, l[b0:b1], r[b0:b1], eq,
                                    coeffs[:, b0:b1])
             for b0, b1 in fk.gp_batch_chunks(B)]
    assert len(parts) == 2
    total = arith.add(spec, parts[0], parts[1])
    assert torch.equal(total, fk.gp_pair_evals_plain(spec, l, r, eq, coeffs))


def _constexprs(src: str) -> dict[str, int]:
    vals: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        vals[name] = int(eval(expr, {}, dict(vals)))
    return vals


def test_launch_constants_match_the_sources():
    """Each kernel's CUDA function and threads per block, K2's plan
    constants, K11's block and blocks an SM (its wave), K8's and K9's
    limits (segments, the events K8's shared memory holds, K9's shared
    memory at each degree) and the round
    kernel's groups, slots, operand encoding and shared memory, as the
    Python side keeps them, agree with the sources."""
    from jolt_tpu_torch.subprotocols import fs_device  # noqa: F401 (K9)
    from jolt_tpu_torch.utils import keccak_device  # noqa: F401 (K8)
    from jolt_tpu_torch.vm import collation
    from jolt_tpu_torch.vm import instruction_lookups as il  # the round
    csrc = Path(nat.__file__).resolve().parent / "csrc"
    assert len(nat.KERNELS) == 16
    for k in nat.KERNELS:
        src = (csrc / f"{k.source}.cu").read_text()
        fn = k.function.split("<")[0]
        m = re.search(r"__launch_bounds__\((\w+)[^\n]*\n" + fn + r"\(", src)
        assert m, k.name
        assert int(_constexprs(src).get(m[1], m[1])) == k.threads, k.name
    c = _constexprs((csrc / "gp_pair.cu").read_text())
    assert (c["GP_WARPS"], c["GP_MIN_BLOCKS"], c["GP_MAX_B"]) == \
        (fk.GP_WARPS, fk.GP_MIN_BLOCKS, fk.GP_MAX_B)
    c = _constexprs((csrc / "sumcheck_ops.cu").read_text())
    assert (c["TOGGLE_THREADS"], c["TOGGLE_MIN_BLOCKS"], c["TOGGLE_MAX_M"],
            c["OPS_THREADS"], c["REDUCE_MIN_BLOCKS"], c["BIND_MAX"],
            c["REDUCE_MAX_PAIRS"], c["RLC_MAX"]) == \
        (32 * fk.TOGGLE_WARPS, fk.TOGGLE_MIN_BLOCKS, fk.TOGGLE_MAX_M,
         fk.OPS_THREADS, fk.REDUCE_MIN_BLOCKS, fk.BIND_MAX,
         fk.REDUCE_MAX_PAIRS, fk.RLC_MAX)
    assert fk.TOGGLE_EVALS.threads == 32 * fk.TOGGLE_WARPS
    assert {k.threads for k in (fk.BIND_HALVES, fk.REDUCTION_EVALS,
                                fk.RLC)} == {fk.OPS_THREADS}
    c = _constexprs((csrc / "field_ops.cu").read_text())
    assert (c["SUM_THREADS"], c["SUM_MIN_BLOCKS"]) == \
        (fk.SUM_THREADS, fk.SUM_MIN_BLOCKS)
    src = (csrc / "keccak.cu").read_text()
    c = _constexprs(src)
    assert (c["MAX_SEGS"], c["K8_SMEM_EVENTS"]) == \
        (keccak_device.MAX_SEGS, keccak_device.SMEM_EVENTS)
    body = re.search(r"k9_smem_bytes\(long long degree\) \{\s*return ([^;]+);",
                     src)[1]
    for d in (1, 2, 3, 8, 9, 12, 37, 38, 80):
        assert eval(" ".join(body.split()), {}, {"degree": d}) == \
            fs_device.k9_smem_bytes(d)
    src = (csrc / "collate.cu").read_text()
    c = _constexprs(src)
    assert (c["MAX_SLOTS"], c["KIND_SHIFT"], c["MAX_GROUPS"], c["TILE"]) == \
        (collation.MAX_SLOTS, collation.KIND_SHIFT, collation.MAX_GROUPS, 32)
    assert c["ROUND_THREADS"] == il.PRIMARY_ROUND.threads == \
        32 * collation.MAX_GROUPS
    assert (c["K_CONST"], c["K_SLOT"]) == (collation.CONST, collation.SLOT)
    assert collation.STAGE not in (collation.CONST, collation.SLOT)
    body = re.search(r"round_smem_bytes\([^)]*\) \{\s*return ([^;]+);",
                     src)[1]
    for pre in _round_pres().values():
        plan = collation.program(pre).plan
        assert eval(" ".join(body.split()), {}, {
            "n_stage": len(plan.stage), "n_slots": plan.n_slots,
            "n_consts": len(plan.consts)}) == plan.smem_bytes()


def _round_pres():
    """What the round reads of rv32i_vm()'s, the narrow VM's and the mini
    VM's lookup preprocessing (C = 4; M = 2^16, 2^8, 2^8)."""
    from types import SimpleNamespace
    from jolt_tpu_torch.instructions import RV32I_INSTRUCTIONS
    from jolt_tpu_torch.vm import instruction_lookups as il
    from jolt_tpu_torch.vm.fixtures import narrow_instructions
    from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES
    by = {c.name: c for c in RV32I_INSTRUCTIONS}
    out = {}
    for name, classes, M in (
            ("rv32i", list(RV32I_INSTRUCTIONS), 1 << 16),
            ("narrow", narrow_instructions(RV32I_INSTRUCTIONS), 1 << 8),
            ("fib", [by["add"], by["bne"]], 1 << 8)):
        out[name] = SimpleNamespace(
            instruction_classes=classes, C=4, M=M, spec=fr_spec(),
            instruction_to_memory_indices=il.memory_layout(
                classes, RV32I_SUBTABLES, 4, M)[3],
            sumcheck_degree=max(c().g_poly_degree(4) for c in classes) + 2)
    return out


@pytest.mark.parametrize("vm", ["rv32i", "narrow", "fib"])
def test_round_plan_takes_each_point_of_each_tile_once(vm):
    """Block b of the grid takes tile b // split and the points b % split,
    b % split + split, ...: every (tile, point) once, each block at least
    one point, at every round size from 2 to 2^21 entries; at h = 2^15
    one block a tile, at h <= 2^7 one block a point; the block's threads
    and shared memory within the card's limits."""
    from jolt_tpu_torch.vm import collation
    from jolt_tpu_torch.vm import instruction_lookups as il
    pre = _round_pres()[vm]
    plan = collation.program(pre).plan
    assert 32 * plan.n_groups <= il.PRIMARY_ROUND.threads
    assert plan.smem_bytes() <= collation.SMEM_LIMIT
    for n in [2, 4, 6, 62, 64, 66, 1000, *(1 << k for k in range(1, 22))]:
        points, split, tiles, blocks = il.round_plan(pre, n)
        assert points == pre.sumcheck_degree + 1
        assert tiles == -(-(n // 2) // 32) and blocks == tiles * split
        assert 1 <= split <= points
        seen = np.zeros((tiles, points), dtype=np.int64)
        for b in range(min(blocks, 4096)):
            t = list(range(b % split, points, split))
            assert t
            seen[b // split, t] += 1
        if blocks <= 4096:
            assert (seen == 1).all()
        if n == 1 << 16:
            assert split == 1
        if n <= 1 << 8:
            assert split == points


def _toggle_visits(m, h, groups, blocks):
    """Visits per (memory, pair index) of K14's task walk."""
    tiles = -(-h // 32)
    visits = np.zeros((m, tiles * 32), dtype=np.int64)
    nwarps = blocks * fk.TOGGLE_WARPS
    for w0 in range(nwarps):
        for task in range(w0, tiles * groups, nwarps):
            tile, g = divmod(task, groups)
            visits[g::groups, tile * 32:(tile + 1) * 32] += 1
    return visits[:, :h]


@pytest.mark.parametrize("m", [1, 2, 3, 29, 55, 81, 110, fk.TOGGLE_MAX_M])
def test_toggle_plan_covers_each_memory_and_pair_once(m):
    """Every (memory, pair index) once, at every round size of a toggle
    GP down to s = 2, within the kernel's limits; about a wave of warps
    where the tiles allow it, and every group a memory."""
    for h in [1, 2, 5, 31, 32, 33, 1000, *(1 << k for k in range(6, 17))]:
        groups, blocks = fk.toggle_plan(m, h)
        assert 1 <= groups <= m and 1 <= blocks <= fk.TOGGLE_WAVE
        per = -(-m // groups)
        assert (groups - 1) * per < m          # no empty group
        tiles = -(-h // 32)
        assert tiles * groups <= max(tiles, fk.TOGGLE_WAVE * fk.TOGGLE_WARPS)
        if tiles * groups <= 1 << 14:
            assert (_toggle_visits(m, h, groups, blocks) == 1).all(), \
                (m, h, groups, blocks)
    assert fk.toggle_plan(55, 1 << 15) == (2, 256)   # a warp a task
    assert fk.toggle_plan(55, 1)[0] == 55


def test_toggle_plan_and_chunks_refuse_or_split():
    for m, h in ((0, 8), (fk.TOGGLE_MAX_M + 1, 8), (8, 0)):
        with pytest.raises(ValueError):
            fk.toggle_plan(m, h)
    for m in (1, 55, 128, 129, 300):
        chunks = fk.toggle_chunks(m)
        assert [j for j0, j1 in chunks for j in range(j0, j1)] == \
            list(range(m))
        assert len(chunks) == -(-m // fk.TOGGLE_MAX_M)


@pytest.mark.parametrize("h", [1, 2, 255, 256, 257, 1 << 15, 1 << 18,
                               (1 << 20) + 3])
def test_reduction_plan_takes_each_pair_index_once(h):
    blocks = fk.reduction_plan(h)
    assert 1 <= blocks <= fk.REDUCE_WAVE
    step = blocks * fk.OPS_THREADS
    firsts = np.arange(min(step, h))
    counts = -(-(h - firsts) // step)          # x = first, first + step, ..
    assert counts.sum() == h
    if h <= step:
        assert blocks == -(-h // fk.OPS_THREADS)


def test_reduction_evals_chunks_add_up():
    """Past REDUCE_MAX_PAIRS pairs the launches' outputs add mod p: the
    plain version over the pairs in two slices, the constant in the
    first, equals it over all of them (the wrapper's split)."""
    spec = fr_spec()
    A, n = fk.REDUCE_MAX_PAIRS + 3, 4
    g = torch.Generator().manual_seed(9)

    def rand(*shape):
        vals = torch.randint(0, 1 << 62, (int(np.prod(shape)),), generator=g)
        return fd.ints_to_device(spec, vals.tolist(), "cpu", shape)

    polys = [rand(n) for _ in range(A)]
    eqs = [rand(n) for _ in range(A)]
    coeffs, k = fk.host_limbs(spec, range(7, 7 + A)), fk.host_limbs(spec, [5])
    zero = fk.host_limbs(spec, [0])[:, 0]
    q = fk.REDUCE_MAX_PAIRS
    parts = arith.add(
        spec, fk.reduction_evals(spec, polys[:q], eqs[:q], coeffs[:, :q],
                                 k[:, 0]),
        fk.reduction_evals(spec, polys[q:], eqs[q:], coeffs[:, q:], zero))
    assert torch.equal(parts, fk.reduction_evals(spec, polys, eqs, coeffs,
                                                 k[:, 0]))
