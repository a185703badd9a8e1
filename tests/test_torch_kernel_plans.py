"""K2's launch plan (field/kernels.py `gp_evals_plan`) on the CPU.

The kernel (csrc/gp_pair.cu `gp_pair_evals_kernel`) maps block k, warp w
and lane to circuit group g = (k % shared) * per_block + w % per_block,
tile (k // shared + j * tile_blocks) * tiles_per_block + w // per_block
for j = 0, 1, ..., pair index tile * 32 + lane, and circuits g, g + groups,
...  `_cells` below walks that map for a plan, so these tests show that
every (circuit, pair index) is covered exactly once, within the kernel's
limits, for every batch size the provers use and every round size.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from jolt_tpu_torch import _native as nat
from jolt_tpu_torch.curve import kernels as ck  # noqa: F401 (registers K5-K7)
from jolt_tpu_torch.field import kernels as fk

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


@pytest.mark.parametrize("B", [1, 7, 8, 43, 64])
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
    for B, h in ((0, 8), (65, 8), (8, 0)):
        with pytest.raises(ValueError):
            fk.gp_evals_plan(B, h)


def _constexprs(src: str) -> dict[str, int]:
    vals: dict[str, int] = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        vals[name] = int(eval(expr, {}, dict(vals)))
    return vals


def test_launch_constants_match_the_sources():
    """Each kernel's CUDA function and threads per block, and K2's plan
    constants, as the Python side keeps them, agree with the sources'
    launch bounds."""
    csrc = Path(nat.__file__).resolve().parent / "csrc"
    assert len(nat.KERNELS) == 7
    for k in nat.KERNELS:
        src = (csrc / f"{k.source}.cu").read_text()
        fn = k.function.split("<")[0]
        m = re.search(r"__launch_bounds__\((\w+)[^\n]*\n" + fn + r"\(", src)
        assert m, k.name
        assert int(_constexprs(src).get(m[1], m[1])) == k.threads, k.name
    c = _constexprs((csrc / "gp_pair.cu").read_text())
    assert (c["GP_WARPS"], c["GP_MIN_BLOCKS"], c["GP_MAX_B"]) == \
        (fk.GP_WARPS, fk.GP_MIN_BLOCKS, fk.GP_MAX_B)
