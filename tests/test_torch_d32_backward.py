"""The head-dim-32 backward on the CPU: its host plan, and its plain
version against the Pallas backward.

``csrc/attention_bwd.cu`` serves head dim 32 with three kernels of its own
(``bwd32_dq`` and ``bwd32_dkv`` for T > 64, ``bwd32_short`` for T <= 64,
which gives dq, dk and dv in one pass) whose route, grids and shared memory
the host picks (``plan_b32``). ``ops/attention.py::d32_bwd_plan`` mirrors
that plan; the kernels themselves run only on the card
(``tests/test_torch_gpu.py -k d32_backward``, ``chip_smoke.py``, which also
holds the library's plan against this mirror). Here: the units each
kernel's blocks and warpgroups take, mirrored from their index arithmetic,
cover every (plane, tile) exactly once, and none starts at or past T;
shared memory fits; the waves at Swin's and the decoder heads' shapes; and
the plain backward (what a CPU tensor takes, and what the kernels are held
to on the card) against ``jax.vjp`` of the JAX package's Pallas ops in
interpret mode at the heads' shapes and with a gap, f32, at 2e-5 of each
gradient's largest magnitude (``tests/test_torch_attention_shapes.py``'s
tolerance).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import close  # noqa: E402

from attentionshift_torch.ops import attention  # noqa: E402

TILE = 64
SMS = 132  # an H100 SXM
# blocks per SM as cudaOccupancyMaxActiveBlocksPerMultiprocessor reports them
# for the kernels as built (an H100 80GB HBM3; chip_smoke.py prints the
# library's plan beside this mirror's)
PER_SM = {"bwd32_dq": 4, "bwd32_dq<kept>": 3, "bwd32_dkv": 4, "bwd32_short": 3}
REL = 2e-5


def per_sm(kernel, smem):
    return PER_SM[kernel]


def tile_units(b, h, t, blocks):
    """(plane, tile) -> the blocks of bwd32_dq (query tiles) or bwd32_dkv
    (key tiles) that take it, from the kernels' index arithmetic (units32,
    unit32): block i walks units i, i + blocks, ...; unit u is tile u %
    ntiles of plane u // ntiles."""
    n = -(-t // TILE)
    units = {}
    for i in range(blocks):
        for u in range(i, b * h * n, blocks):
            units.setdefault((u // n, u % n), []).append(i)
    return units


def short_units(b, h, blocks):
    """plane -> the blocks of bwd32_short that take it: block i walks
    planes i, i + grid, ..."""
    units = {}
    for i in range(blocks):
        for p in range(i, b * h, blocks):
            units.setdefault(p, []).append(i)
    return units


SHAPES = [(1, 24, 1276), (512, 8, 50), (128, 8, 196), (2, 8, 1), (3, 24, 63), (1, 8, 64),
          (1, 8, 65), (2, 40, 190), (1, 8, 4301), (4, 3, 129), (3, 1, 128), (1, 33, 1276),
          (1, 6, 256), (2, 6, 257)]


@pytest.mark.parametrize("b,h,t", SHAPES)
def test_d32_bwd_plan_covers_every_unit_once(b, h, t):
    """Every (plane, query tile) of pass A and every (plane, key tile) of
    pass B is taken by exactly one persistent block, no tile starting at or
    past T; no kernel launches more blocks than are resident at once, or
    than it has units; T <= 64 takes the one-pass kernel, whose persistent
    blocks take every plane exactly once; pass A keeps p exactly where T <=
    256."""
    plan = attention.d32_bwd_plan(b, h, t, SMS, per_sm)
    n = -(-t // TILE)
    assert plan["route"] == ("short" if t <= TILE else "pair")
    assert plan["units"] == b * h * n
    assert plan["dq_blocks"] == min(plan["units"], SMS * PER_SM[plan["dq"]])
    assert plan["dkv_blocks"] == min(plan["units"], SMS * PER_SM["bwd32_dkv"])
    for blocks in (plan["dq_blocks"], plan["dkv_blocks"]):
        units = tile_units(b, h, t, blocks)
        assert sorted(units) == [(p, i) for p in range(b * h) for i in range(n)]
        assert all(len(who) == 1 for who in units.values())
        assert all(i * TILE < t for _, i in units)
    assert plan["short_blocks"] == min(b * h, SMS * PER_SM["bwd32_short"])
    planes = short_units(b, h, plan["short_blocks"])
    assert sorted(planes) == list(range(b * h)) and all(len(w) == 1 for w in planes.values())
    assert ("kept" in plan["dq"]) == (t <= 4 * TILE)


@pytest.mark.parametrize("h", [1, 8, 24, 31, 32, 33, 40, 96])
def test_d32_bwd_shared_memory_fits(h):
    """Every d = 32 backward kernel's block fits the 227 KB a block may use,
    at any head count (none of them keeps a head's tiles beside another's),
    and as many blocks as its registers allow (three of one warpgroup, one
    of four) fit an SM, also where pass A keeps p."""
    for t in (1, 50, 64, 65, 196, 256, 257, 1276, 4301):
        plan = attention.d32_bwd_plan(1, h, t, SMS, per_sm)
        for key in ("short", "dq", "dkv"):
            kernel = {"short": "bwd32_short", "dq": plan["dq"], "dkv": "bwd32_dkv"}[key]
            assert plan[f"{key}_smem"] <= attention.SMEM_LIMIT
            assert (plan[f"{key}_smem"] + 1024) * PER_SM[kernel] <= attention.SM_SMEM
    assert attention.d32_bwd_smem("bwd32_dq<kept>", 256) == \
        attention.d32_bwd_smem("bwd32_dq") + 4 * 8192


def test_d32_bwd_plan_waves_at_the_users_shapes():
    """The rounds the plan gives where the kernels' users run them: Swin's
    (1, 24, 1276) is 480 query tiles and 480 key tiles, each pass on 480 of
    its 528 resident blocks (four per SM): one round; the box head's (512,
    8, 50) is 4096 planes on 396 one-pass blocks (11 rounds at most, 10.3 on
    average); the mask head's (128, 8, 196) is 4096 query tiles on 396
    blocks of pass A (three per SM: it keeps its four key tiles of p) and
    4096 key tiles on 528 of pass B (7.8 rounds)."""
    swin = attention.d32_bwd_plan(1, 24, 1276, SMS, per_sm)
    assert (swin["route"], swin["dq"], swin["units"]) == ("pair", "bwd32_dq", 480)
    assert swin["dq_blocks"] == swin["dkv_blocks"] == 480
    box = attention.d32_bwd_plan(512, 8, 50, SMS, per_sm)
    assert box["route"] == "short" and box["short_blocks"] == 396
    assert math.ceil(4096 / box["short_blocks"]) == 11
    mask = attention.d32_bwd_plan(128, 8, 196, SMS, per_sm)
    assert (mask["route"], mask["dq"], mask["units"]) == ("pair", "bwd32_dq<kept>", 4096)
    assert (mask["dq_blocks"], mask["dkv_blocks"]) == (396, 528)
    assert 4096 / 528 == pytest.approx(7.76, abs=0.01)


@pytest.mark.parametrize("d,t,want", [
    (32, 50, ("attention_bwd_d32_short",)), (24, 64, ("attention_bwd_d32_short",)),
    (32, 65, ("attention_bwd_dq_d32", "attention_bwd_dkv_d32")),
    (64, 50, ("attention_bwd_dq", "attention_bwd_dkv")), (36, 10, ()),
])
def test_backward_records_name_the_route(d, t, want):
    """The records the ops' backward counts on the card: the one-pass
    kernel's at head dim 32 (8-32 padded onto it) and T <= 64, else the
    pair's of the instance; none where the plain version runs (d % 8)."""
    assert attention.backward_records(d, t) == want


def _inputs(b, h, t, gap, seed):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(b, h, t, 32).astype(np.float32) for _ in range(4))
    if gap is not None:  # the gap's rows have no consumer in the model
        g[:, :, gap[0]:gap[1]] = 0.0
    return q, k, v, g


# the box head's and the mask head's planes (fewer RoIs), and Swin's heads at
# a ragged T with a gap across the first key tile's edge
CASES = [(4, 8, 50, None), (2, 8, 196, None), (1, 24, 190, (60, 70))]


@pytest.mark.parametrize("b,h,t,gap", CASES)
def test_plain_d32_backward_matches_the_pallas_kernels(b, h, t, gap):
    """``attention_backward_reference`` (the plain backward the kernels are
    held to) against ``jax.vjp`` of the Pallas op in interpret mode (the
    JAX package's ``_bwd_kernel_dq`` and ``_bwd_kernel_dkv``), each of dq,
    dk, dv within 2e-5 of its largest magnitude; gap columns of dk and dv
    exactly 0 on both sides; the port's op on a CPU tensor takes exactly
    this plain backward."""
    from attentionshift_tpu.ops import attention as jatt

    q, k, v, g = _inputs(b, h, t, gap, seed=t)
    _, vjp = jax.vjp(lambda q, k, v: jatt.attention_no_capture(q, k, v, True, True, gap),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = attention.attention_backward_reference(*map(torch.from_numpy, (q, k, v, g)), gap)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float64)
        close(np.asarray(a, np.float64), w, REL * max(np.abs(w).max(), 1e-30), what=name)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = attention.attention_no_capture(*leaves, gap)
    for a, w in zip(torch.autograd.grad(out, leaves, torch.from_numpy(g)), got):
        assert torch.equal(a, w)
    if gap is not None:
        for a, w in zip(got[1:], want[1:]):
            assert float(a[:, :, gap[0]:gap[1]].abs().max()) == 0.0
            assert float(np.abs(np.asarray(w)[:, :, gap[0]:gap[1]]).max()) == 0.0
