"""K2's launch plan (field/kernels.py `gp_evals_plan`) on the CPU.

The kernel (csrc/gp_pair.cu `gp_pair_evals_kernel`) maps block k, warp w
and lane to circuit group g = (k % shared) * per_block + w % per_block,
tile (k // shared + j * tile_blocks) * tiles_per_block + w // per_block
for j = 0, 1, ..., pair index tile * 32 + lane, and circuits g, g + groups,
...  `_cells` below walks that map for a plan, so these tests show that
every (circuit, pair index) is covered exactly once, within the kernel's
limits, for every batch size the provers use and every round size, and
that a batch above one launch's cap is split so that each circuit is
summed once.
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
    constants, K8's and K9's limits (segments, the events K8's shared
    memory holds, K9's shared memory at each degree) and K13's slots and
    operand encoding, as the Python side keeps them, agree with the
    sources."""
    from jolt_tpu_torch.subprotocols import fs_device  # noqa: F401 (K9)
    from jolt_tpu_torch.utils import keccak_device  # noqa: F401 (K8)
    from jolt_tpu_torch.vm import collation  # K13
    from jolt_tpu_torch.vm import instruction_lookups  # noqa: F401 (K12)
    csrc = Path(nat.__file__).resolve().parent / "csrc"
    assert len(nat.KERNELS) == 13
    for k in nat.KERNELS:
        src = (csrc / f"{k.source}.cu").read_text()
        fn = k.function.split("<")[0]
        m = re.search(r"__launch_bounds__\((\w+)[^\n]*\n" + fn + r"\(", src)
        assert m, k.name
        assert int(_constexprs(src).get(m[1], m[1])) == k.threads, k.name
    c = _constexprs((csrc / "gp_pair.cu").read_text())
    assert (c["GP_WARPS"], c["GP_MIN_BLOCKS"], c["GP_MAX_B"]) == \
        (fk.GP_WARPS, fk.GP_MIN_BLOCKS, fk.GP_MAX_B)
    src = (csrc / "keccak.cu").read_text()
    c = _constexprs(src)
    assert (c["MAX_SEGS"], c["K8_SMEM_EVENTS"]) == \
        (keccak_device.MAX_SEGS, keccak_device.SMEM_EVENTS)
    body = re.search(r"k9_smem_bytes\(long long degree\) \{\s*return ([^;]+);",
                     src)[1]
    for d in (1, 2, 3, 8, 9, 12, 37, 38, 80):
        assert eval(" ".join(body.split()), {}, {"degree": d}) == \
            fs_device.k9_smem_bytes(d)
    c = _constexprs((csrc / "collate.cu").read_text())
    assert (c["MAX_SLOTS"], c["KIND_SHIFT"]) == (collation.MAX_SLOTS,
                                                 collation.KIND_SHIFT)
