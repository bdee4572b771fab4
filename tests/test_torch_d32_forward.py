"""The head-dim-32 forward's host plan, on the CPU.

``csrc/attention.cu`` serves head dim 32 with three kernels of its own
(``flash_fwd32`` for T > 64, ``flash_fwd32_short`` for T <= 64,
``attn_mean32``) whose grids, mean chunk and shared memory the host picks
(``plan32``). ``ops/attention.py::d32_plan`` mirrors that plan; the
kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``, which also holds the library's plan against this mirror).
Here: the units each kernel's blocks and warpgroups take, mirrored from
their index arithmetic, cover every (plane, query tile) and every mean tile
exactly once; no 64-row unit starts at or past T; shared memory fits; the
waves at Swin's and the decoder heads' shapes.
"""

from __future__ import annotations

import math

import pytest
import torch

from attentionshift_torch.ops import attention

TILE = 64
SMS = 132  # an H100 SXM
# blocks per SM as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports
# them for the kernels as built (an H100 80GB HBM3; chip_smoke.py prints the
# library's plan beside this mirror's)
PER_SM = {"flash_fwd32": 2, "flash_fwd32_short": 4, "attn_mean32<true>": 1,
          "attn_mean32<false>": 1}


def per_sm(kernel, smem):
    return PER_SM[kernel]


def flash_units(b, h, t, plan):
    """(plane, query tile) -> the (block, warpgroup) that computes it, from
    the kernels' index arithmetic: flash_fwd32's block (x, y, z) is plane
    z * H + y, its warpgroup w the query tile 2x + w while that tile starts
    below T; flash_fwd32_short's block i walks planes i, i + grid, ..."""
    units = {}
    if plan["flash"] == "flash_fwd32":
        for z in range(b):
            for y in range(h):
                for x in range(plan["flash_blocks"]):
                    row0 = 2 * TILE * x
                    consumers = 2 if row0 + TILE < t else 1
                    for w in range(consumers):
                        units.setdefault((z * h + y, 2 * x + w), []).append(((x, y, z), w))
    else:
        for i in range(plan["flash_blocks"]):
            for p in range(i, b * h, plan["flash_blocks"]):
                units.setdefault((p, 0), []).append(((i,), 0))
    return units


def mean_tiles(b, t, plan):
    """(image, query tile, key tile) -> the (block, warpgroup) that writes
    that mean tile: attn_mean32's block (x, y, z) holds key tiles [x c,
    min(x c + c, ntiles)), its warpgroup w the tiles w, w + W, ... of them."""
    ntiles, c, W = -(-t // TILE), plan["mean_chunk"], attention.D32_MEAN_WARPGROUPS
    tiles = {}
    for z in range(b):
        for y in range(ntiles):
            for x in range(plan["mean_chunks"]):
                c0, cn = x * c, min(c, ntiles - x * c)
                for w in range(W):
                    for kt in range(c0 + w, c0 + cn, W):
                        tiles.setdefault((z, y, kt), []).append(((x, y, z), w))
    return tiles


SHAPES = [(1, 24, 1276), (512, 8, 50), (128, 8, 196), (2, 8, 1), (3, 24, 63), (1, 8, 64),
          (1, 8, 65), (2, 40, 190), (1, 8, 4301), (4, 3, 129), (3, 1, 128), (1, 33, 1276)]


@pytest.mark.parametrize("b,h,t", SHAPES)
def test_d32_plan_covers_every_unit_once(b, h, t):
    """Every (plane, query tile) is computed by exactly one warpgroup, none
    of whose 64 rows start at or past T; every (query tile, key tile) of
    the mean is written by exactly one warpgroup; T <= 64 takes the short
    kernel on at most one block per plane."""
    plan = attention.d32_plan(b, h, t, SMS, per_sm)
    nq = -(-t // TILE)
    units = flash_units(b, h, t, plan)
    assert sorted(units) == [(p, i) for p in range(b * h) for i in range(nq)]
    assert all(len(who) == 1 for who in units.values())
    assert all(i * TILE < t for _, i in units)
    assert (plan["flash"] == "flash_fwd32_short") == (t <= TILE)
    if t <= TILE:
        assert plan["flash_blocks"] == min(b * h, SMS * PER_SM["flash_fwd32_short"])
    tiles = mean_tiles(b, t, plan)
    assert sorted(tiles) == [(z, y, x) for z in range(b) for y in range(nq) for x in range(nq)]
    assert all(len(who) == 1 for who in tiles.values())


@pytest.mark.parametrize("h", [1, 8, 24, 31, 32, 33, 40, 96])
def test_d32_shared_memory_fits(h):
    """Every d = 32 kernel's block fits the 227 KB a block may use; the
    mean pass keeps the query tiles up to 32 heads (H x 4 KB within
    MEAN_RESIDENT_BYTES, the kernel's own limit since PR 14) and streams
    them above, so that 40 heads stream."""
    plan = attention.d32_plan(1, h, 1276, SMS, per_sm)
    assert plan["flash_smem"] <= attention.SMEM_LIMIT
    assert plan["mean_smem"] <= attention.SMEM_LIMIT
    assert plan["mean"] == ("attn_mean32<true>" if h <= 32 else "attn_mean32<false>")
    for kernel in attention.D32_KERNELS:
        assert attention.d32_smem(kernel, h if kernel == "attn_mean32<true>" and h <= 32 else 1) \
            <= attention.SMEM_LIMIT


def test_d32_plan_waves_at_the_users_shapes():
    """The waves the plan gives where the kernels' users run them: Swin's
    (1, 24, 1276) is 240 flash blocks in one wave of 264 slots and 100
    mean blocks of 4 key tiles (one per warpgroup) in one wave of 132; the
    box head's (512, 8, 50) is 528 persistent blocks over 4096 planes (8
    rounds at most, 7.8 on average); the mask head's (128, 8, 196) is 2048
    flash blocks, 7.8 waves."""
    swin = attention.d32_plan(1, 24, 1276, SMS, per_sm)
    assert swin["flash"] == "flash_fwd32" and swin["flash_blocks"] == 10
    assert math.ceil(10 * 24 / (SMS * swin["flash_per_sm"])) == 1
    assert (swin["mean"], swin["mean_chunk"], swin["mean_chunks"]) == ("attn_mean32<true>", 4, 5)
    assert math.ceil(5 * 20 / (SMS * swin["mean_per_sm"])) == 1
    box = attention.d32_plan(512, 8, 50, SMS, per_sm)
    assert box["flash"] == "flash_fwd32_short" and box["flash_blocks"] == 528
    assert math.ceil(4096 / box["flash_blocks"]) == 8
    mask = attention.d32_plan(128, 8, 196, SMS, per_sm)
    assert mask["flash"] == "flash_fwd32" and mask["flash_blocks"] == 2
    assert 2 * 8 * 128 / (SMS * mask["flash_per_sm"]) == pytest.approx(7.76, abs=0.01)

