"""The plan of the variants' wide route (head dims above 128), on the CPU.

``ops/attention_variants.py::wide_variant_plan`` mirrors the host's plan
of ``csrc/attention_variants.cu`` (``wide_plan``; the card test
``tests/test_torch_gpu.py::test_wide_variant_plan_on_card`` holds the
library's ``attn_wide_plan`` equal to it). These tests hold the plan to
what its kernels need at every padded width KD the tool's ``--dim`` above
128 gives, head count and T: each block's shared memory and threads within
the card's limits, every (query tile, plane, slab) of ``out`` and every
(query tile, key tile, image) of the mean written by exactly one block, and
S computed once per key tile at the widths the kernel table times.
"""

from __future__ import annotations

import numpy as np
import pytest

from attentionshift_torch.ops import attention_variants as av

WIDE_KDS = (256, 384, 512, 640, 1024)
WIDE_HEADS = (1, 3, 6, 12, 25)
WIDE_TS = (1, 63, 64, 301, 4301)
SMS = 132  # an H100 SXM's SMs


def plans(kd: int):
    """(b, h, t, variant, plan) at every head count, T and variant (B = 2
    at T = 63: two images)."""
    for h in WIDE_HEADS:
        for t in WIDE_TS:
            b = 2 if t == 63 else 1
            for name in av.VARIANTS:
                yield b, h, t, name, av.wide_variant_plan(b, h, t, kd, name, SMS)


@pytest.mark.parametrize("kd", WIDE_KDS)
def test_wide_plan_fits_the_card(kd):
    """Every kernel's shared memory within the 232,448 bytes a block may
    use and its threads within 1,024; the ring holds at least the four
    slots Q streams beside; at most three consumer warpgroups (four and the
    producer warp leave 96 registers a thread, where the products
    serialize); v5's clusters portable and no larger than 4."""
    for b, h, t, name, p in plans(kd):
        case = (b, h, t, kd, name)
        for key in ("out_smem", "mean_smem", "v5_smem"):
            assert 0 < p[key] <= av.SMEM_LIMIT, (case, key, p[key])
        assert p["slabs"] * 128 + av.W_PRODUCER <= 1024, case
        assert 2 * 128 + av.W_PRODUCER <= 1024
        assert 1 <= p["slabs"] <= 3, case
        assert p["slots"] >= 4, case
        assert 1 <= p["lanes"] <= p["slabs"], case
        assert 1 <= p["cluster"] <= 4 and p["v5_x"] == p["cluster"], case


@pytest.mark.parametrize("kd", WIDE_KDS)
def test_wide_plan_writes_out_once(kd):
    """The out pass's grid (query tiles, slab groups, planes) and v5's
    (ranks taking heads r, r + C, ..., query tiles, images) each write
    every (query tile, plane, slab) of ``out`` exactly once, and every
    group holds at least one slab."""
    ns = kd // 128
    for b, h, t, name, p in plans(kd):
        nq = -(-t // 64)
        assert (p["out_x"], p["out_z"], p["v5_y"], p["v5_z"]) == (nq, b * h, nq, b)
        groups = [range(y * p["slabs"], min(ns, (y + 1) * p["slabs"])) for y in range(p["out_y"])]
        assert all(len(g) > 0 for g in groups), (b, h, t, name)
        seen = np.zeros((nq, b * h, ns), np.int32)
        for x in range(p["out_x"]):
            for g in groups:
                seen[x, :, g.start:g.stop] += 1
        assert (seen == 1).all(), (b, h, t, name)
        seen[:] = 0
        for img in range(b):
            for rank in range(p["cluster"]):
                for head in range(rank, h, p["cluster"]):
                    for g in groups:
                        seen[:, img * h + head, g.start:g.stop] += 1
        assert (seen == 1).all(), (b, h, t, name)


@pytest.mark.parametrize("kd", WIDE_KDS)
def test_wide_plan_writes_the_mean_once(kd):
    """The mean pass's grid (chunks of ``chunk`` key tiles, pairs of query
    tiles, images) and v5's sweep 2 (rank r's key tiles [r nk / C, (r + 1)
    nk / C), lane l taking every ``lanes``-th of them from the l-th) each
    write every (query tile, key tile, image) of the mean exactly once."""
    for b, h, t, name, p in plans(kd):
        nq = nk = -(-t // 64)
        seen = np.zeros((nq, nk, b), np.int32)
        for x in range(p["mean_x"]):
            tiles = range(x * p["chunk"], min(nk, (x + 1) * p["chunk"]))
            assert len(tiles) > 0, (b, h, t, name)
            for y in range(p["mean_y"]):
                rows = [r for r in (2 * y, 2 * y + 1) if r < nq]
                for img in range(p["mean_z"]):
                    seen[rows, tiles.start:tiles.stop, img] += 1
        assert (seen == 1).all(), (b, h, t, name)
        seen[:] = 0
        c = p["cluster"]
        for y in range(p["v5_y"]):
            for rank in range(c):
                kt0, kt1 = rank * nk // c, (rank + 1) * nk // c
                for lane in range(p["lanes"]):
                    seen[y, kt0 + lane:kt1:p["lanes"], :] += 1
        assert (seen == 1).all(), (b, h, t, name)


@pytest.mark.parametrize("kd", [256, 384])
def test_wide_plan_computes_s_once_at_the_timed_widths(kd):
    """At the kernel table's widths (d = 256, 384) one slab group holds
    every output slab, so the out pass computes S once per (query tile,
    image, head, key tile); at the tool's (1, 6, 4301) v5 runs on clusters
    of more than one block."""
    for b, h, t, name, p in plans(kd):
        assert p["groups"] == 1 and p["slabs"] == kd // 128, (b, h, t, name)
        assert p["qstream"] == 0, (b, h, t, name)
    assert av.wide_variant_plan(1, 6, 4301, kd, "v5-batched", SMS)["cluster"] > 1
