"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one; they import no JAX, so they run on a GPU machine with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from attentionshift_torch.ops import attention, attention_variants, ccl, meanshift_kernel  # noqa: E402


def ccl_planes(m, h, w, seed=0):
    """Blob planes plus a serpentine (slow to converge) and an empty one."""
    from scipy import ndimage

    rs = np.random.RandomState(seed)
    planes = [ndimage.gaussian_filter(rs.rand(h, w), 2.0) > 0.5 for _ in range(m - 2)]
    snake = np.zeros((h, w), bool)
    snake[::2] = True
    for r in range(1, h, 2):
        snake[r, -1 if (r // 2) % 2 == 0 else 0] = True
    planes += [snake, np.zeros((h, w), bool)]
    return np.stack(planes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# (H, W): the bench plane; a single row; a single column; ragged rows
# against a warp's 32 lanes; the plane the JAX kernel runs transposed; one
# too large for shared memory (device-memory path)
CCL_SHAPES = [(50, 84), (1, 84), (50, 1), (33, 300), (100, 168), (200, 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("max_iters", [1, 2, 64])
@pytest.mark.parametrize("h,w", CCL_SHAPES)
def test_ccl_kernel_on_card(cuda, h, w, max_iters):
    """CCL kernel vs the plain version, exact at every sweep cap (cut
    fixpoints included): blob planes, a serpentine, an empty and a full
    plane."""
    planes = ccl_planes(5, h, w)
    masks = torch.from_numpy(np.concatenate([planes, np.ones((1, h, w), bool)])).to(cuda)
    got = ccl.connected_components_batch(masks, max_iters)
    assert torch.equal(got, ccl.connected_components(masks, max_iters))


@pytest.mark.gpu
def test_ccl_kernel_at_the_coco_configs_plane_count(cuda):
    """The COCO configs' batch for CCL: 12 captured layers x ``max_gt`` 40
    = 480 planes of 50x84 per image (800x1344 at stride 16), exact against
    the plain version at the configs' sweep cap 64 and at 2 (cut
    fixpoints)."""
    planes = ccl_planes(480, 50, 84, seed=3)
    masks = torch.from_numpy(planes).to(cuda)
    for max_iters in (64, 2):
        got = ccl.connected_components_batch(masks, max_iters)
        assert torch.equal(got, ccl.connected_components(masks, max_iters))


@pytest.mark.gpu
@pytest.mark.parametrize("max_iters", [64, 2])
def test_ccl_kernel_at_the_point_decoding_planes(cuda, max_iters):
    """``point2bbox``'s batch: 100 token planes of 100x168 (800x1344 at cam
    stride 8), exact against the plain version at the sweep cap 64 and at
    2 (cut fixpoints)."""
    planes = ccl_planes(100, 100, 168, seed=5)
    masks = torch.from_numpy(planes).to(cuda)
    got = ccl.connected_components_batch(masks, max_iters)
    assert torch.equal(got, ccl.connected_components(masks, max_iters))


@pytest.mark.gpu
def test_ccl_plane_bytes_agree(cuda):
    """The wrapper's plane buffer size (its shared-memory or device-memory
    choice, and the scratch it allocates) is the kernel's own."""
    import ctypes

    from attentionshift_torch.ops._build import library

    fn = library("ccl").ccl_plane_bytes
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    for h, w in CCL_SHAPES + [(7, 9), (800, 1344)]:
        assert fn(h, w) == ccl._plane_bytes(h, w)


def _meanshift_inputs(g, k, n, d, seed, cuda):
    """Seeded inputs; instance 1's mask is all zero, instance 2's one cell."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    f = torch.randn((n, d), generator=gen, device=cuda)
    prot0 = torch.randn((g, k, d), generator=gen, device=cuda)
    mask = (torch.rand((g, n), generator=gen, device=cuda) > 0.4).float()
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2, n // 2] = 1.0
    return prot0, mask, f


# (K, N, D, n_shift): every KP template (8, 16, 24, 32); N ragged against
# the 64-feature tiles and the cluster split (300, 301, 4200); D of ViT-S,
# ViT-B and a narrow one; no, one and ten iterations; a plane that only
# clusters of 16 blocks hold (bf16; f32 takes 8)
MEANSHIFT_CASES = [
    (8, 300, 64, 10),
    (16, 301, 384, 1),
    (20, 4200, 384, 10),
    (20, 4200, 384, 0),
    (24, 300, 768, 10),
    (32, 4200, 768, 10),
    (20, 4200, 768, 1),
    (8, 46000, 64, 2),
]


@pytest.mark.gpu
@pytest.mark.parametrize("matmul_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("k,n,d,n_shift", MEANSHIFT_CASES)
def test_meanshift_kernel_on_card(cuda, k, n, d, n_shift, matmul_dtype):
    """Mean-shift kernel vs the plain version: f32 1e-4 (summation order);
    bf16 operands 2e-3 (an f32 last-bit difference can move a bf16
    rounding of a weight or prototype by 2^-8); both relative to the
    largest entry. An all-zero and a single-cell mask among the instances."""
    prot0, mask, f = _meanshift_inputs(5, k, n, d, k + n + d, cuda)
    tol = 1e-4 if matmul_dtype is None else 2e-3
    want = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f,
                                               n_shift=n_shift, matmul_dtype=matmul_dtype)
    got = meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, n_shift=n_shift,
                                                 matmul_dtype=matmul_dtype)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=tol * float(b.abs().max()), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("matmul_dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("d", [384, 768])
def test_meanshift_kernel_at_the_coco_configs_instance_count(cuda, d, matmul_dtype):
    """The COCO configs' mean-shift: G = 40 instances (``max_gt``) of K = 20
    grid prototypes over N = 4200 features, D = 384 (ViT-S) and 768
    (ViT-B), ten iterations, against the plain version, instance by
    instance (``meanshift_kernel.fixpoint_verdict``): within the floor of
    ``test_meanshift_kernel_on_card`` (1e-4 in f32, 2e-3 with bf16
    operands, here of each instance's largest prototype entry), or within
    twice the plain version's own spread under reordered sums, or within
    the floor of one reordered plain version. A plain version with the
    temperature 10 % off moves the prototypes of some instance beyond that
    instance's limit."""
    prot0, mask, f = _meanshift_inputs(40, 20, 4200, d, 40 + d, cuda)
    floor = 1e-4 if matmul_dtype is None else 2e-3
    kw = dict(n_shift=10, matmul_dtype=matmul_dtype)
    got = meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, **kw)
    want = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f, **kw)
    off = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f, temp=0.11, **kw)
    # the control's similarities put equal to the plain version's: its
    # prototypes alone have to fail
    v, ctl = meanshift_kernel.fixpoint_verdict([got, (off[0], want[1])], prot0, mask, f, floor,
                                               **kw)
    assert bool(v["ok"].all()), {k: x.tolist() if torch.is_tensor(x) else x for k, x in v.items()}
    assert not bool(ctl["ok"].all())


@pytest.mark.gpu
@pytest.mark.parametrize("matmul_dtype", [None, torch.bfloat16])
def test_meanshift_kernel_is_deterministic(cuda, matmul_dtype):
    """No atomics: two calls on the same inputs give bitwise equal outputs."""
    prot0, mask, f = _meanshift_inputs(5, 20, 4200, 384, 3, cuda)
    runs = [meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, matmul_dtype=matmul_dtype)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_meanshift_plan_on_card(cuda):
    """The wrapper's shared-memory count is the kernel's own, and the bench
    shape (G = 20, K = 20, N = 4200, D = 384, bf16) runs in one wave."""
    import ctypes

    from attentionshift_torch.ops._build import library

    fn = library("meanshift").meanshift_smem_bytes
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int] * 5
    for kp in (8, 16, 24, 32):
        for bf16 in (0, 1):
            for d, tb, stages in ((64, 1, 1), (384, 11, 2), (768, 17, 2), (1024, 3, 1)):
                assert fn(kp, bf16, d, tb, stages) == meanshift_kernel._smem_bytes(
                    kp, bool(bf16), d, tb, stages)
    (c, tb, stages, smem), active = meanshift_kernel.launch_plan(20, 20, 4200, 384, True, cuda)
    assert active(c, smem) >= 20


# (B, H, T, gap): one tile; one row past two tiles; a ragged T with and
# without a gap; a gap across the tile boundary at 128; an odd T (the
# mean's unpaired last column, as at the microbenchmark's 4301); the bench
# shape; ViT-B's 12 heads with the bench gap; the mean pass's 16-head limit;
# the evaluation path's token counts without a gap (VOC config, no padding):
# the aug-test scales of a 500x375 image and the single-scale test bucket
ATTENTION_CASES = [
    (1, 3, 64, None),
    (1, 3, 129, None),
    (2, 3, 300, (250, 270)),
    (2, 3, 300, None),
    (2, 3, 300, (120, 140)),
    (1, 3, 301, None),
    (1, 6, 4352, (4201, 4252)),
    (1, 12, 4352, (4201, 4252)),
    (1, 16, 301, None),
    (1, 6, 985, None),
    (1, 6, 2001, None),
    (1, 6, 2533, None),
    (1, 6, 3173, None),
    (1, 6, 3501, None),
]


def _lse2_reference(q, k, gap):
    """Each row's log2-sum-exp of the masked logits, from the plain
    version's f32 logits."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if gap is not None:
        logits[..., gap[0]:gap[1]] = float("-inf")
    return torch.logsumexp(logits, dim=-1) * 1.4426950408889634


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,gap", ATTENTION_CASES)
def test_attention_forward_kernels_on_card(cuda, b, h, t, gap):
    """Both forward kernels (flash pass and mean pass) vs the plain version
    at the backward's shapes: the edges of the 64-row tiles, of the ring
    and of the mean pass's key chunks, with and without a gap. ``out``
    within 4 bf16 ulps of the largest |out| (bf16 output, bf16
    probabilities in PV), ``mean`` within 1e-4 + 1e-2 relative (one bf16
    rounding of the stored mean), the row log2-sum-exp within 1e-4 of
    ``logsumexp`` of the plain version's f32 logits times log2(e) (f32
    summation order only), and gap columns of ``mean`` exactly zero."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((b, h, t, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    ref_out, ref_mean = attention.attention_reference(q, k, v, gap)
    out, mean = attention.attention_with_capture(q, k, v, gap)
    out2 = attention.attention_no_capture(q, k, v, gap)
    out3, lse = attention.flash_forward(q, k, v, gap, with_lse=True)
    torch.cuda.synchronize()
    tol = _ulps(ref_out, 4)
    for got in (out, out2, out3):
        torch.testing.assert_close(got.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mean.float(), ref_mean.float(), atol=1e-4, rtol=1e-2)
    torch.testing.assert_close(lse, _lse2_reference(q, k, gap), atol=1e-4, rtol=0)
    if gap is not None:
        assert float(mean[:, :, gap[0]:gap[1]].float().abs().max()) == 0.0
        no_gap = attention.attention_reference(q, k, v, None)[0]
        assert float((out.float() - no_gap.float()).abs().max()) > tol


@pytest.mark.gpu
def test_attention_forward_kernels_are_deterministic(cuda):
    """No atomics: two forward calls on the same inputs give bitwise equal
    ``out``, row log2-sum-exp and ``mean``."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (torch.randn((2, 3, 300, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    runs = []
    for _ in range(2):
        out, lse = attention.flash_forward(q, k, v, (120, 140), with_lse=True)
        runs.append((out, lse, attention.attention_with_capture(q, k, v, (120, 140))[1]))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [48, 16, 128])
def test_attention_kernels_refuse_other_head_dims(cuda, d):
    """A CUDA tensor launches the kernel or raises: a head dim without an
    instance (not 64 or 32) raises ``ValueError`` in every op, forward and
    backward, and launches nothing; no path gives way to the plain
    version."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    reset_launches()
    q = torch.zeros((1, 2, 64, d), device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64), device=cuda)
    for call in (lambda: attention.attention_with_capture(q, q, q),
                 lambda: attention.attention_no_capture(q, q, q),
                 lambda: attention.attention_backward_dq(q, q, q, lse, q),
                 lambda: attention.attention_backward_dkv(q, q, q, lse, lse, q)):
        with pytest.raises(ValueError, match="head dim 64 or 32"):
            call()
    assert not any(k.launches for k in KERNELS.values())


# (B, H, T, d, gap) of the cases beyond the ViT's (head dim 64, at most 16
# heads): single 64-row tiles at head dim 32 first (one key tile: each
# product of the 64-byte swizzle alone, then a ragged tile and two);
# Swin's global blocks at 896x1344 (24 heads of 32, T = 1276); head dim 32
# at the bench T with its gap; more heads than the mean pass keeps at d =
# 64 (24 and 17: query tiles streamed, two images) and at d = 32 (40).
HEAD_SHAPE_CASES = [
    (1, 1, 64, 32, None),
    (1, 2, 40, 32, None),
    (2, 3, 130, 32, (70, 90)),
    (1, 24, 1276, 32, None),
    (1, 6, 4352, 32, (4201, 4252)),
    (1, 24, 1276, 64, None),
    (2, 17, 300, 64, None),
    (1, 40, 190, 32, None),
    # the MAE ViT-B encoder at 896x1344 (split attention, window 14): 24
    # windows of 196 tokens, and its global blocks at 4704 without a gap;
    # the MIM ViT-S at 224 (batch 8, cls + 196 patches)
    (24, 12, 196, 64, None),
    (1, 12, 4704, 64, None),
    (8, 6, 197, 64, None),
]


def _check_attention_pair(q, k, v, g, gap):
    """The forward pair (out within 4 bf16 ulps of the largest |out|; every
    mean entry within ``capture_mean_limit``; the row log2-sum-exp within
    1e-4) and the backward pair (4 bf16 ulps of each gradient's largest
    entry) against the plain versions, with the controls: a mean without
    its last head, and a mean whose logits are scaled 1.1x, must both fail
    the mean limit."""
    ref_out, ref_mean = attention.attention_reference(q, k, v, gap)
    out, mean = attention.attention_with_capture(q, k, v, gap)
    out2 = attention.attention_no_capture(q, k, v, gap)
    _, lse = attention.flash_forward(q, k, v, gap, with_lse=True)
    torch.cuda.synchronize()
    tol = _ulps(ref_out, 4)
    for got in (out, out2):
        torch.testing.assert_close(got.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, _lse2_reference(q, k, gap), atol=1e-4, rtol=0)
    limit = attention.capture_mean_limit(ref_mean)
    over = _mean_over(mean, ref_mean, limit)
    assert over <= 1.0, f"a mean entry at {over:.3f}x its limit"
    h = q.shape[1]
    for name, ctl in (("one head off", attention.attention_reference(
                          q[:, : h - 1], k[:, : h - 1], v[:, : h - 1], gap)[1] if h > 1 else None),
                      ("temperature off", attention.attention_reference(
                          (q.float() * 1.1).bfloat16(), k, v, gap)[1])):
        if ctl is not None:
            assert _mean_over(mean, ctl, attention.capture_mean_limit(ctl)) > 1.0, name
    if gap is not None:
        assert float(mean[:, :, gap[0]:gap[1]].float().abs().max()) == 0.0
    want = attention.attention_backward_reference(q, k, v, g, gap)
    for op in (attention.attention_no_capture, attention.attention_with_capture):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = op(*leaves, gap)
        o = o[0] if isinstance(o, tuple) else o
        got = torch.autograd.grad(o, leaves, g)
        for name, a, w in zip("qkv", got, want):
            torch.testing.assert_close(a.float(), w.float(), atol=_ulps(w, 4), rtol=0,
                                       msg=f"d{name}")
        if gap is not None:
            assert float(got[1][:, :, gap[0]:gap[1]].float().abs().max()) == 0.0
            assert float(got[2][:, :, gap[0]:gap[1]].float().abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,gap", HEAD_SHAPE_CASES)
def test_attention_kernels_at_other_head_shapes_on_card(cuda, b, h, t, d, gap):
    """Both pairs at head dim 32 and above the mean pass's resident heads,
    counted under the instance's own name."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, g = (torch.randn((b, h, t, d), generator=gen, device=cuda).bfloat16()
                  for _ in range(4))
    reset_launches()
    _check_attention_pair(q, k, v, g, gap)
    suffix = "" if d == 64 else f"_d{d}"
    assert KERNELS["attention_capture" + suffix].launches == 2
    assert KERNELS["attention_plain" + suffix].launches == 2
    assert KERNELS["attention_bwd_dq" + suffix].launches == 2
    assert KERNELS["attention_bwd_dkv" + suffix].launches == 2


@pytest.mark.gpu
@pytest.mark.parametrize("seed", range(16))
def test_attention_kernels_at_24_heads_of_32_over_seeds(cuda, seed):
    """(1, 24, 190, 32): Swin's heads at a short ragged T, sixteen seeds."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, g = (torch.randn((1, 24, 190, 32), generator=gen, device=cuda).bfloat16()
                  for _ in range(4))
    _check_attention_pair(q, k, v, g, None)


@pytest.mark.gpu
@pytest.mark.parametrize("h,d", [(24, 32), (17, 64), (40, 32)])
def test_attention_head_shape_kernels_are_deterministic(cuda, h, d):
    """No atomics at the new instances either: two calls give bitwise equal
    out, mean and gradients."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, g = (torch.randn((1, h, 190, d), generator=gen, device=cuda).bfloat16()
                  for _ in range(4))
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out, mean = attention.attention_with_capture(*leaves)
        runs.append((out, mean, *torch.autograd.grad(out, leaves, g)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,gap", ATTENTION_CASES)
def test_attention_backward_kernels_on_card(cuda, b, h, t, gap):
    """Both backward kernels (through the custom ops' backward) vs the plain
    backward at shapes that reach the edges of the 64-row tiles and of the
    two-slot ring (one tile, one row past two, 300 = 4 tiles of 64 + 44,
    an odd 301, the bench shape's 68 tiles), with and without a gap, one
    gap across a tile boundary. bf16 gradients: 4 bf16 ulps of each gradient's largest
    entry (the kernels normalise with the forward's row statistic and take
    D from the bf16 ``out``; the plain version recomputes both in f32). Gap
    columns of dk and dv are exactly zero, and a plain backward that
    ignores the gap exceeds the limit."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, g = (torch.randn((b, h, t, 64), generator=gen, device=cuda).bfloat16()
                  for _ in range(4))
    want = attention.attention_backward_reference(q, k, v, g, gap)
    for op in (attention.attention_no_capture, attention.attention_with_capture):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = op(*leaves, gap)
        out = out[0] if isinstance(out, tuple) else out
        got = torch.autograd.grad(out, leaves, g)
        for name, a, w in zip("qkv", got, want):
            torch.testing.assert_close(a.float(), w.float(), atol=_ulps(w, 4), rtol=0,
                                       msg=f"d{name}")
        if gap is not None:
            assert float(got[1][:, :, gap[0]:gap[1]].float().abs().max()) == 0.0
            assert float(got[2][:, :, gap[0]:gap[1]].float().abs().max()) == 0.0
            no_gap = attention.attention_backward_reference(q, k, v, g, None)
            assert float((got[2].float() - no_gap[2].float()).abs().max()) > _ulps(want[2], 4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 32])
def test_attention_backward_on_keys_with_a_common_component(cuda, d):
    """q, k and v each sharing a common component per head, as a trained
    model's do (the learning check's keys on an H100: common part 2.8x
    their spread):
    dq, dk, dv of both ops within 4 bf16 ulps of the plain version's. Pass A
    sums D = sum_s p * dP in f32 from the bf16 p, as the plain version and
    the TPU kernel do. The control, the plain version with D from the bf16
    ``out`` (rowsum(dO * out)), returns out's rounding in dq times the mean
    key and must fail the dq limit."""
    gen = torch.Generator(device=cuda).manual_seed(12)

    def shared():
        base = torch.randn((1, 6, 1125, d), generator=gen, device=cuda) * 0.5
        return (base + torch.randn((1, 6, 1, d), generator=gen, device=cuda)).bfloat16()

    q, k, v = shared(), shared(), shared()
    g = torch.randn((1, 6, 1125, d), generator=gen, device=cuda).bfloat16()
    want = attention.attention_backward_reference(q, k, v, g)
    for op in (attention.attention_no_capture, attention.attention_with_capture):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = op(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        got = torch.autograd.grad(out, leaves, g)
        for name, a, w in zip("qkv", got, want):
            torch.testing.assert_close(a.float(), w.float(), atol=_ulps(w, 4), rtol=0,
                                       msg=f"d{name}")
    pm = torch.softmax(attention._logits(q, k), -1).bfloat16().float()
    gp = g.float() @ v.float().transpose(-1, -2)
    dd = (g.float() * attention.attention_reference(q, k, v)[0].float()).sum(-1, keepdim=True)
    ctl = ((pm * (gp - dd)).bfloat16().float() @ k.float()) * d**-0.5
    assert float((ctl - want[0].float()).abs().max()) > _ulps(want[0], 4)


@pytest.mark.gpu
def test_attention_backward_kernels_are_deterministic(cuda):
    """No atomics: two backward calls on the same inputs give bitwise equal
    dq, D, dk and dv."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, g = (torch.randn((2, 3, 300, 64), generator=gen, device=cuda).bfloat16()
                  for _ in range(4))
    _, lse = attention.flash_forward(q, k, v, (120, 140), with_lse=True)
    runs = []
    for _ in range(2):
        dq, dd = attention.attention_backward_dq(q, k, v, lse, g, (120, 140))
        runs.append((dq, dd, *attention.attention_backward_dkv(q, k, v, lse, dd, g, (120, 140))))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _ulps(ref, n):
    top = float(ref.float().abs().max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


# the variants on the TMA + wgmma design: every one of the tool's five
HOPPER_VARIANTS = ("v2-bf16e", "v3-nomin", "v4-mxsum", "v5-batched", "v6-fusedsum")

# (B, H, T) of the variant kernels' card cases: every variant at a ragged
# T (300 = 4 key tiles of 64 + 44) and at an odd one (301: the mean's last
# column has no partner to be stored with, as at the tool's default 4301);
# also at the design's edges: a whole number of key tiles, less than one
# tile, two images (plane b*H + h), one head, and more heads than the mean
# pass keeps resident (24: query tiles streamed; two key tiles, the second
# ragged; for v5 also beyond its 8-head first design).
VARIANT_CASES = ([pytest.param(2, 3, t, name, id=f"2x3x{t}-{name}")
                  for t in (300, 301) for name in attention_variants.VARIANTS]
                 + [pytest.param(b, h, t, name, id=f"{b}x{h}x{t}-{name}")
                    for b, h, t in ((1, 6, 256), (1, 3, 40), (2, 2, 130), (1, 1, 200),
                                    (1, 24, 190))
                    for name in HOPPER_VARIANTS])


def _mean_over(mean, want, limit) -> float:
    """The largest |mean - want| / limit over the entries (<= 1: within)."""
    return float(((mean.float() - want.float()).abs() / limit).max())


def _check_variant(q, k, v, variant, out, mean):
    """``out`` within 4 bf16 ulps of the plain version's largest |out|, every
    ``mean`` entry within ``attention_variants.mean_limit`` (its docstring
    derives it); returns the out limit."""
    want_out, want_mean = attention_variants.variant_reference(q, k, v, variant)
    out_tol = _ulps(want_out, 4)
    torch.testing.assert_close(out.float(), want_out.float(), atol=out_tol, rtol=0)
    over = _mean_over(mean, want_mean, attention_variants.mean_limit(q, k, variant, want_mean))
    assert over <= 1.0, f"{variant}: a mean entry at {over:.3f}x its limit"
    return out_tol


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,variant", VARIANT_CASES)
def test_attention_variant_kernels_on_card(cuda, b, h, t, variant):
    """Each design variant's kernel vs its plain version at (B, H, T) of
    ``VARIANT_CASES``, on random inputs and on the clamp input (two shifted
    logits of one row in (100, 127)). bf16 outputs: ``out`` within 4 bf16
    ulps of the largest |out|, each ``mean`` entry within ``mean_limit``
    (5.5 bf16 steps of the entry: one step of a tensor-core e moves each
    positive term, and so the entry, by less than 2^-6 of itself, then
    the stores). Control: on the clamp input the plain version of the
    other clamp behaviour (v3's for the clamped variants, v2's for v3)
    exceeds both limits, on at least one entry of the mean, so the check
    sees whether the kernel clamps."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((b, h, t, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    other = "v2-bf16e" if variant == "v3-nomin" else "v3-nomin"
    for case in ((q, k, v), attention_variants.clamp_case(q, k, v)):
        out, mean = attention_variants.attention_variant(*case, variant)
        torch.cuda.synchronize()
        out_tol = _check_variant(*case, variant, out, mean)
    ctl_out, ctl_mean = attention_variants.variant_reference(*case, other)
    assert float((out.float() - ctl_out.float()).abs().max()) > out_tol
    assert _mean_over(mean, ctl_mean, attention_variants.mean_limit(case[0], case[1], other,
                                                                    ctl_mean)) > 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("variant", HOPPER_VARIANTS)
def test_attention_variant_kernels_24_heads_over_seeds(cuda, variant):
    """The 24-head case (1, 24, 190) (query tiles streamed, a ragged second
    key tile; its mean is flat, so a one-step rounding of an entry near
    the largest is common) on the card generator's seeds 0-15: ``out``
    within 4 bf16 ulps, every mean entry within ``mean_limit``."""
    for seed in range(16):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        q, k, v = (torch.randn((1, 24, 190, 64), generator=gen, device=cuda).bfloat16()
                   for _ in range(3))
        out, mean = attention_variants.attention_variant(q, k, v, variant)
        torch.cuda.synchronize()
        _check_variant(q, k, v, variant, out, mean)


@pytest.mark.gpu
@pytest.mark.parametrize("defines", [(), ("VAR_V6_N72=1",)], ids=["n64+n8", "n72"])
@pytest.mark.parametrize("b,h,t", [(1, 6, 301), (2, 3, 130), (1, 24, 190)])
def test_v6_kernel_reads_the_columns_it_is_given(cuda, b, h, t, defines):
    """``attn_variant_forward`` (variant 6, through ``variant_library()``,
    as built and with PV as one n72 product) with a 72-column V whose column 64 holds 2.0 and columns 65-71 hold
    3.0-9.0 (exact in bf16), against the plain arithmetic on that V: out =
    (e @ V[:, :64]) / (e @ V[:, 64]) within 4 bf16 ulps of the largest
    |out|, and the mean sum_h e_h / (H e_h @ V[:, 64]) within
    ``mean_limit``. A kernel that read another of the 8 columns, read its
    column slot transposed, or made its own ones is off by a third or more
    (controls: the plain arithmetic with column 66 or with ones as the
    denominator exceeds the out limit)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((b, h, t, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    cols = torch.arange(2, 10, device=cuda, dtype=torch.bfloat16).expand(b, h, t, 8)
    v72 = torch.cat([v, cols], dim=-1).contiguous()
    out, mean = torch.empty_like(q), torch.empty((b, t, t), device=cuda, dtype=q.dtype)
    work = torch.empty((b, h, t), device=cuda, dtype=torch.float32)
    lib = attention_variants.variant_library(defines)
    err = lib.attn_variant_forward(6, q.data_ptr(), k.data_ptr(), v72.data_ptr(), out.data_ptr(),
                                   mean.data_ptr(), work.data_ptr(), b, h, t,
                                   float(attention_variants._q_scale(q)),
                                   torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0

    e = torch.exp2(attention_variants._logits(q, k).clamp(max=100.0)).bfloat16().float()
    osum = torch.matmul(e, v72.float())

    def plain(den):
        recip = 1.0 / den.clamp_min(1e-30)
        want_mean = sum(e[:, hh] * (recip[:, hh] * (1.0 / h)) for hh in range(h))
        return (osum[..., :64] * recip).bfloat16(), want_mean.bfloat16()

    want_out, want_mean = plain(osum[..., 64:65])
    out_tol = _ulps(want_out, 4)
    torch.testing.assert_close(out.float(), want_out.float(), atol=out_tol, rtol=0)
    over = _mean_over(mean, want_mean, attention_variants.mean_limit(q, k, "v6-fusedsum",
                                                                    want_mean))
    assert over <= 1.0, f"a mean entry at {over:.3f}x its limit"
    for den in (osum[..., 66:67], e.sum(-1, keepdim=True)):
        assert float((out.float() - plain(den)[0].float()).abs().max()) > out_tol


@pytest.mark.gpu
@pytest.mark.parametrize("h", [6, 24])
@pytest.mark.parametrize("variant", HOPPER_VARIANTS)
def test_attention_variant_kernels_repeat_bitwise(cuda, variant, h):
    """The TMA + wgmma variants write every output element once, in a fixed
    order: two calls on the same inputs give bitwise equal ``out`` and
    ``mean``, with the query tiles resident (6 heads) and streamed (24), at
    an odd T with a ragged last tile."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((1, h, 301, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    first = attention_variants.attention_variant(q, k, v, variant)
    second = attention_variants.attention_variant(q, k, v, variant)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.gpu
def test_attention_variant_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA tensor launches the kernel or raises: f32 inputs and a head
    dim other than 64 are refused; v5 runs 9 and 24 heads (above its first
    design's 8) within the limits of the variants' test, and 40 (recips in
    the workspace, above 24)."""
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(ValueError):
        attention_variants.attention_variant(q, q, q, "v2-bf16e")
    q = torch.zeros((1, 2, 64, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention_variants.attention_variant(q, q, q, "v4-mxsum")
    for h in (9, 24, 40):
        gen = torch.Generator(device=cuda).manual_seed(h)
        q, k, v = (torch.randn((1, h, 130, 64), generator=gen, device=cuda).bfloat16()
                   for _ in range(3))
        out, mean = attention_variants.attention_variant(q, k, v, "v5-batched")
        torch.cuda.synchronize()
        _check_variant(q, k, v, "v5-batched", out, mean)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [4, 8])
@pytest.mark.parametrize("b,h,t", [(1, 3, 40), (2, 2, 130), (1, 30, 190), (1, 8, 40),
                                   (1, 32, 190)])
def test_v5_kernel_with_more_ranks_than_key_tiles(cuda, b, h, t, cluster):
    """v5 built with its cluster size forced (``V5_CLUSTER``) above the key
    tiles a query tile has (T = 40: one tile; 130: three; 190 with 30 or
    32 heads: three, the recips in the workspace): the ranks without a
    sweep-2 chunk, and in sweep 1 the ranks without a head (2 and 3 heads
    in clusters of 4 and 8), still join every barrier; 30 heads in
    clusters of 4 and 8 give the ranks unequal head counts.
    ``attn_v5_cluster`` reports the forced size; out and mean within the
    variants' limits, on random inputs and on the clamp input."""
    lib = attention_variants.variant_library((f"V5_CLUSTER={cluster}",))
    assert lib.attn_v5_cluster(b, h, t) == cluster
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v = (torch.randn((b, h, t, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    for case in ((q, k, v), attention_variants.clamp_case(q, k, v)):
        out, mean = attention_variants.attention_variant(*case, "v5-batched", lib=lib)
        torch.cuda.synchronize()
        _check_variant(*case, "v5-batched", out, mean)


@pytest.mark.gpu
def test_microbenchmark_tool_on_card(cuda):
    """The tool at a small odd shape on the card: a finite time for every
    name, every line names the card, each kernel-backed name launched its
    kernel (2 chains of 2 calls + the warm-up chain), and on the tool's own
    inputs at that shape every variant's kernel agrees with its plain
    version (limits as in the variants' test)."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.tools.analysis import microbench_attention as tool

    lines = []
    reset_launches()
    res = tool.run_variants(t=301, heads=3, inner=2, iters=2, device=cuda, log=lines.append)
    assert list(res) == list(tool.VARIANT_NAMES)
    assert all(np.isfinite(ms) and ms > 0 for ms in res.values())
    assert all(torch.cuda.get_device_name(cuda) in line for line in lines)
    for kernel, _ in attention_variants.VARIANTS.values():
        assert KERNELS[kernel].launches == 6
    assert KERNELS["attention_capture"].launches == KERNELS["attention_plain"].launches == 6
    q, k, v = tool.make_inputs(t=301, heads=3, device=cuda)
    for variant in attention_variants.VARIANTS:
        out, mean = attention_variants.attention_variant(q, k, v, variant)
        torch.cuda.synchronize()
        _check_variant(q, k, v, variant, out, mean)


@pytest.mark.gpu
def test_simple_test_on_card(cuda):
    """Inference of a narrow bf16 model on the card: 0 capture launches and
    one plain launch per block and image batch, well-formed outputs, boxes
    inside the true extent; the box head's scores agree with the same
    model on the CPU (f32, plain versions) within bf16 tolerance."""
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.train import make_eval_step

    kw = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, point_tokens=16, cam_layer=3,
              out_indices=(0, 1, 2, 3), num_proposals=50, test_max_per_img=10,
              test_score_thr=0.02, pad_tokens_to=128)
    gpu = AttnShiftDetector(device=cuda, dtype=torch.bfloat16, **kw).init_weights(seed=0)
    cpu = AttnShiftDetector(device="cpu", **kw).init_weights(seed=0)
    rs = np.random.RandomState(0)
    img = torch.from_numpy(rs.randn(2, 64, 96, 3).astype(np.float32))
    wh = torch.tensor([[96.0, 64.0], [80.0, 50.0]])
    reset_launches()
    out = make_eval_step(gpu)(img.to(cuda), wh.to(cuda))
    torch.cuda.synchronize()
    assert KERNELS["attention_plain"].launches == 4
    assert sum(k.launches for k in KERNELS.values()) == 4
    assert out.dets.boxes.shape == (2, 10, 4) and out.mask_probs.shape == (2, 10, 28, 28)
    assert bool(torch.isfinite(out.dets.boxes).all())
    b = out.dets.boxes.cpu()
    for i in range(2):
        assert bool((b[i] >= 0).all())
        assert bool((b[i][:, 0::2] <= wh[i, 0]).all() and (b[i][:, 1::2] <= wh[i, 1]).all())
    assert bool(((out.mask_probs >= 0) & (out.mask_probs <= 1)).all())
    rois = torch.tensor([[[4.0, 4.0, 60.0, 50.0], [30.0, 10.0, 90.0, 60.0]]]).repeat(2, 1, 1)
    sg, _ = gpu.roi_test(img.to(cuda), rois.to(cuda), wh.to(cuda))
    sc, _ = cpu.roi_test(img, rois, wh)
    torch.testing.assert_close(sg.cpu(), sc, atol=2e-2, rtol=0)


@pytest.mark.gpu
def test_aug_tester_on_card(cuda):
    """Multi-scale + flip testing on the card. (1) The tester's own device
    work (the merge of every augmentation's proposals, the flips, scale
    arithmetic, averages, both NMS) against the CPU path, on the same
    per-stage outputs (the CPU f32 model's, handed to the card): the
    tolerances of the CPU parity test (``tests/test_torch_eval.py``),
    validity and labels exactly, boxes 1e-3 px + 1e-5 of the coordinate,
    scores and mask probabilities 1e-4. (2) A narrow bf16 model on the
    card: one ``flash_fwd`` launch per block, stage and augmentation and no
    other kernel, well-formed detections inside the original frame."""
    from types import SimpleNamespace

    from attentionshift_torch.eval import AugTester
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    kw = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, point_tokens=16, cam_layer=3,
              out_indices=(0, 1, 2, 3), num_proposals=48, test_score_thr=0.02)
    scales = [(96, 160), (64, 128)]
    cpu = AttnShiftDetector(device="cpu", **kw).init_weights(seed=0)
    rs = np.random.RandomState(0)
    img = (rs.rand(120, 160, 3) * 80 + 60).astype(np.uint8)
    img[30:60, 32:80] = (220, 40, 40)

    def on(dev, fn):
        """Run a CPU stage on inputs from the card and hand its outputs back."""
        def run(*args):
            out = fn(*(a.cpu() for a in args))
            if not isinstance(out, tuple):
                return out.to(dev)
            moved = [t.to(dev) for t in out]
            return type(out)(*moved) if hasattr(out, "_fields") else tuple(moved)
        return run

    proxy = SimpleNamespace(device=cuda, num_proposals=cpu.num_proposals,
                            test_score_thr=cpu.test_score_thr, test_iou_thr=cpu.test_iou_thr,
                            rpn_test=on(cuda, cpu.rpn_test), roi_test=on(cuda, cpu.roi_test),
                            mask_test=on(cuda, cpu.mask_test))
    want = AugTester(cpu, scales)(img, max_dets=8)
    got = AugTester(proxy, scales)(img, max_dets=8)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert want["valid"].sum() >= 3
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-4, rtol=0)
    v = want["valid"]
    np.testing.assert_allclose(got["mask_probs"][v], want["mask_probs"][v], atol=1e-4, rtol=0)

    gpu = AttnShiftDetector(device=cuda, dtype=torch.bfloat16, **kw).init_weights(seed=0)
    reset_launches()
    out = AugTester(gpu, scales)(img, max_dets=8)
    torch.cuda.synchronize()
    assert KERNELS["attention_plain"].launches == len(scales) * 2 * 3 * kw["depth"]
    assert sum(k.launches for k in KERNELS.values()) == KERNELS["attention_plain"].launches
    assert out["boxes"].shape == (8, 4) and out["mask_probs"].shape == (8, 28, 28)
    b = out["boxes"][out["valid"]]
    assert np.isfinite(out["boxes"]).all() and (b >= 0).all()
    assert (b[:, 0::2] <= 160).all() and (b[:, 1::2] <= 120).all()
    assert ((out["mask_probs"] >= 0) & (out["mask_probs"] <= 1)).all()


@pytest.mark.gpu
def test_train_step_under_a_world_size_one_group_on_card(cuda, monkeypatch):
    """The train step of a narrow bf16 model at batch 2 under a world-size-1
    NCCL group (``parallel.mesh.init_distributed`` from torchrun's variables)
    against the same step without a group, from the same init and generator
    seed. A mean over one rank is the identity, so the two are equal
    bitwise: every loss, every gradient the optimizer receives and every
    parameter after the update. The group's all-reduces are counted (4
    normalisers, the gradients, the metrics), and the kernels launch as at
    batch 2 without a group: attention once per block and batch, CCL and
    mean-shift once per image."""
    import socket

    import torch.distributed as dist

    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.parallel import mesh
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step

    kw = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, point_tokens=16, cam_layer=3,
              out_indices=(0, 1, 2, 3), max_gt=4, pad_tokens_to=128, num_proposals=100,
              rpn_nms_pre=200, rcnn_samples=64, mask_sample_cap=16)
    rs = np.random.RandomState(0)
    batch = dict(img=torch.from_numpy(rs.randn(2, 64, 96, 3).astype(np.float32)),
                 gt_points=torch.tensor([[[20.0, 20.0], [60.0, 40.0], [80.0, 30.0], [0, 0]]] * 2),
                 gt_labels=torch.tensor([[1, 3, 5, 0], [2, 4, 6, 0]], dtype=torch.int32),
                 gt_valid=torch.tensor([[True, True, True, False], [True, True, False, False]]),
                 img_wh=torch.tensor([[96.0, 64.0], [96.0, 64.0]]))
    batch = {k: v.to(cuda) for k, v in batch.items()}

    def run(group):
        model = AttnShiftDetector(device=cuda, dtype=torch.bfloat16, **kw).init_weights(seed=0)
        opt = build_optimizer(model, accumulate_steps=1, depth=4)
        seen, inner = [], opt.step
        opt.step = lambda grads: (seen.append([  # an unused parameter's None counts as 0
            torch.zeros_like(p) if g is None else g.clone() for g, p in zip(grads, opt.params)]),
            inner(grads))[1]
        gen = torch.Generator(device=cuda).manual_seed(3)
        reset_launches()
        _, metrics = make_train_step(model, group)(TrainState.create(model, opt), batch,
                                                   generator=gen)
        torch.cuda.synchronize()
        return (dict(metrics={k: v.float() for k, v in metrics.items()}, grads=seen[0],
                     params=[p.detach().clone() for p in model.parameters()]),
                {n: k.launches for n, k in KERNELS.items() if k.launches})

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    rank, world, dev = mesh.init_distributed(cuda)
    try:
        assert (rank, world, dev.type) == (0, 1, "cuda") and dist.get_backend() == "nccl"
        mesh.COUNTS.clear()
        grouped, launches = run(dist.group.WORLD)
        assert mesh.COUNTS == {"normalisers": 4, "gradients": 1, "metrics": 1}
    finally:
        dist.destroy_process_group()
    alone, alone_launches = run(None)
    assert launches == alone_launches == {"attention_capture": 3, "attention_plain": 5,
                                          "attention_bwd_dq": 4, "attention_bwd_dkv": 4,
                                          "ccl_batch": 2, "meanshift_fixpoint": 2}
    assert set(grouped["metrics"]) == set(alone["metrics"])
    for k, v in alone["metrics"].items():
        assert torch.equal(grouped["metrics"][k], v), (k, grouped["metrics"][k], v)
    for what in ("grads", "params"):
        assert len(grouped[what]) == len(alone[what]) > 0
        for a, b in zip(grouped[what], alone[what]):
            assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.gpu
def test_refine_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """The refinement stage's TINY Mask R-CNN step (f32, ResNet depths
    (1, 1, 1, 1), batch 2 at 128 x 128, 50 proposals, 32 RCNN samples, 8
    mask RoIs) on the card against the same step on the CPU, from the same
    seeded init, batch and draws (made on the CPU): every loss within 2e-4
    of max(1, |loss|), the sampled positives exactly, every trainable
    parameter's gradient within 2e-3 of that tensor's largest entry (the
    train step's tolerances), and no hand-written kernel launched. cuDNN's
    TF32 (which PyTorch's default allows for convolutions) is turned off
    for the comparison, so that both sides compute in f32."""
    from attentionshift_torch.models.mask_rcnn import MaskRCNN
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.train import TrainState, build_sgd_optimizer, make_refine_train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kw = dict(num_classes=5, num_proposals=50, rpn_nms_pre=100, rcnn_samples=32,
              mask_sample_cap=8, depths=(1, 1, 1, 1), test_max_per_img=10)
    rs = np.random.RandomState(1)
    boxes = np.asarray([[[8, 8, 60, 70], [50, 40, 120, 100], [10, 60, 50, 126], [0, 0, 0, 0]],
                        [[20, 4, 90, 50], [64, 64, 127, 127], [4, 30, 40, 90], [0, 0, 0, 0]]],
                       np.float32)
    masks = np.zeros((2, 4, 32, 32), np.uint8)
    for i in range(2):
        for j, (x1, y1, x2, y2) in enumerate(boxes[i, :3].astype(int) // 4):
            masks[i, j, y1:y2, x1:x2] = 1
    batch = dict(img=torch.from_numpy(rs.randn(2, 128, 128, 3).astype(np.float32)),
                 gt_boxes=torch.from_numpy(boxes), gt_masks=torch.from_numpy(masks),
                 gt_labels=torch.tensor([[1, 2, 3, 0], [4, 0, 2, 0]], dtype=torch.int32),
                 gt_valid=torch.tensor([[True, True, True, False]] * 2),
                 img_wh=torch.tensor([[128.0, 128.0]] * 2))
    gen = torch.Generator().manual_seed(5)
    n_anchors = 3 * sum(s * s for s in (32, 16, 8, 4, 2))
    draws = [dict(rpn_u_pos=torch.rand(n_anchors, generator=gen),
                  rpn_u_neg=torch.rand(n_anchors, generator=gen),
                  rcnn_u_pos=torch.rand(54, generator=gen), rcnn_u_neg=torch.rand(54, generator=gen),
                  mask_u=torch.rand(32, generator=gen)) for _ in range(2)]

    def run(dev):
        model = MaskRCNN(device=dev, **kw).init_weights(seed=0)
        opt = build_sgd_optimizer(model, steps_per_epoch=10)
        seen, inner = [], opt.step
        opt.step = lambda grads: (seen.append({n: g.detach().cpu() for n, g in
                                               zip(opt.names, grads)}), inner(grads))[1]
        pos = []
        fwd = model.forward
        model.forward = lambda *a, **k: (lambda out: (pos.append(out[1]["pos"].cpu()), out)[1])(
            fwd(*a, **k))
        reset_launches()
        _, metrics = make_refine_train_step(model)(
            TrainState.create(model, opt), {k: v.to(dev) for k, v in batch.items()}, draws=draws)
        return {k: float(v) for k, v in metrics.items()}, seen[0], pos[0]

    card, card_grads, card_pos = run(cuda)
    torch.cuda.synchronize()
    assert not any(k.launches for k in KERNELS.values())
    host, host_grads, host_pos = run(torch.device("cpu"))
    assert set(card) == set(host) and "loss_mask" in card
    for name, ref in host.items():
        assert abs(card[name] - ref) <= 2e-4 * max(1.0, abs(ref)), (name, card[name], ref)
    assert torch.equal(card_pos, host_pos) and card_pos.sum() > 0
    assert set(card_grads) == set(host_grads)
    for name, ref in host_grads.items():
        tol = 2e-3 * float(ref.abs().max()) + 1e-12
        assert float((card_grads[name] - ref).abs().max()) <= tol, name


# ------------------------------------------------- the modules of the A7-A10 slice


def _rel_close(got, ref, rel, what=""):
    ref = ref.detach().float().cpu()
    tol = rel * max(float(ref.abs().max()), 1e-30)
    err = float((got.detach().float().cpu() - ref).abs().max())
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.gpu
def test_point2bbox_on_card(cuda):
    """``point2bbox`` with 100 tokens on a 50x84 grid: one CCL launch on the
    card; its boxes equal (1e-4 px) ``bbox_from_labels_batch`` on the CPU
    over the card's planes, scores and labels equal the CPU's."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.pseudo.cam import bbox_from_labels_batch
    from attentionshift_torch.pseudo.point2bbox import point2bbox, point_planes

    rs = np.random.RandomState(0)
    p, hp, wp = 100, 50, 84
    cls = torch.from_numpy((rs.randn(p, 20) * 3).astype(np.float32))
    reg = torch.from_numpy(rs.rand(p, 2).astype(np.float32))
    rows = torch.from_numpy(rs.rand(p, 1 + hp * wp + p).astype(np.float32) ** 8)
    wh = torch.tensor([1300.0, 760.0])
    reset_launches()
    got = point2bbox(cls.to(cuda), reg.to(cuda), rows.to(cuda), (hp, wp), wh.to(cuda))
    torch.cuda.synchronize()
    launches = KERNELS["ccl_batch"].launches
    planes = point_planes(rows.to(cuda), (hp, wp)).cpu()
    labels = ccl.connected_components(planes, 64)
    boxes = bbox_from_labels_batch(labels, reg * wh / 8) * 8
    boxes = torch.stack([boxes[:, 0].clamp(0, wh[0]), boxes[:, 1].clamp(0, wh[1]),
                         boxes[:, 2].clamp(0, wh[0]), boxes[:, 3].clamp(0, wh[1])], -1)
    torch.testing.assert_close(got.boxes.cpu(), boxes, atol=1e-4, rtol=0)
    want = point2bbox(cls, reg, rows, (hp, wp), wh)
    torch.testing.assert_close(got.scores.cpu(), want.scores, atol=1e-6, rtol=0)
    assert torch.equal(got.labels.cpu(), want.labels) and torch.equal(got.valid.cpu(), want.valid)
    assert launches == 1


@pytest.mark.gpu
def test_crf_on_card(cuda):
    """``mean_field_refine`` (1e-4) and ``water_fill`` (equal slots) on the
    card against the CPU."""
    from attentionshift_torch.pseudo.crf import mean_field_refine, water_fill

    rs = np.random.RandomState(1)
    maps = torch.from_numpy(rs.rand(5, 12, 16).astype(np.float32))
    feats = torch.from_numpy(rs.randn(12 * 16, 32).astype(np.float32))
    got = mean_field_refine(maps.to(cuda), feats.to(cuda), num_iter=10)
    torch.testing.assert_close(got.cpu(), mean_field_refine(maps, feats, num_iter=10), atol=1e-4,
                               rtol=0)
    sim = torch.from_numpy((rs.rand(40, 40) * 0.6 + 0.2).astype(np.float32))
    attn = torch.from_numpy((rs.rand(40) > 0.5).astype(np.float32))
    f = torch.from_numpy(rs.randn(40, 6).astype(np.float32))
    for thr in (None, 0.55):
        gp, gv = water_fill(f.to(cuda), sim.to(cuda), attn.to(cuda), n_iter=6, thr=thr)
        wp, wv = water_fill(f, sim, attn, n_iter=6, thr=thr)
        assert torch.equal(gp.cpu(), wp) and torch.equal(gv.cpu(), wv)


@pytest.mark.gpu
def test_point_generator_and_sampling_on_card(cuda):
    """``grid_sample_bilinear`` (both modes, 1e-5), hull masks (equal) and
    the generator's outputs on the card against the CPU."""
    from attentionshift_torch.models.point_generator import (SupervisionPointGenerator,
                                                             convex_hull_mask)
    from attentionshift_torch.ops.sampling import grid_sample_bilinear

    rs = np.random.RandomState(2)
    img = torch.from_numpy(rs.randn(3, 9, 11).astype(np.float32))
    grid = torch.from_numpy((rs.rand(5, 7, 2) * 2.4 - 1.2).astype(np.float32))
    for ac in (False, True):
        torch.testing.assert_close(grid_sample_bilinear(img.to(cuda), grid.to(cuda), ac).cpu(),
                                   grid_sample_bilinear(img, grid, ac), atol=1e-5, rtol=0)
    pts = torch.from_numpy(rs.uniform(4, 60, (20, 9, 2)).astype(np.float32))
    assert torch.equal(convex_hull_mask(pts.to(cuda), (64, 64)).cpu(), convex_hull_mask(pts, (64, 64)))
    field = torch.from_numpy((rs.randn(18, 6, 8) * 1.5).astype(np.float32))
    init = torch.from_numpy((rs.rand(12, 2) * [128, 96]).astype(np.float32))
    obj = torch.arange(12) // 4
    valid = torch.from_numpy(rs.rand(12) > 0.1)
    gen = SupervisionPointGenerator(point_thr=0.3, mask_thr=0.5)
    got = gen(field.to(cuda), init.to(cuda), obj.to(cuda), valid.to(cuda), 3)
    want = gen(field, init, obj, valid, 3)
    torch.testing.assert_close(got.pred_points.cpu(), want.pred_points, atol=1e-4, rtol=0)
    assert torch.equal(got.core_regions.cpu(), want.core_regions)
    assert torch.equal(got.keep.cpu(), want.keep)


@pytest.mark.gpu
def test_deformable_attention_on_card(cuda):
    """Output and every gradient on the card against the CPU, f32, 1e-4 of
    each one's largest entry."""
    from attentionshift_torch.models.deformable_attention import DeformableConvAttention

    m = DeformableConvAttention(32, 4, device=cuda).init_weights(seed=0)
    mc = DeformableConvAttention(32, 4, device="cpu")
    mc.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 9, 13, 32).astype(np.float32))
    res = []
    for mod, dev in ((m, cuda), (mc, torch.device("cpu"))):
        xx = x.to(dev).requires_grad_(True)
        y = mod(xx)
        (y * torch.arange(y.numel(), device=dev).reshape(y.shape).sin()).sum().backward()
        res.append([y, xx.grad] + [p.grad for p in mod.parameters()])
    for i, (a, r) in enumerate(zip(*res)):
        _rel_close(a, r, 1e-4, f"tensor {i}")


def _backbone_on_both(make, img, cuda, mask=None):
    """The bf16 module on the card (kernels), the same module with plain
    attention on the card (bf16) and its f32 copy on the CPU: outputs and
    the image gradient of a fixed weighted sum, and the launch counts."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    card = make(torch.bfloat16, cuda, True)
    res = {}
    for name, mod in (("card", card), ("plain", make(torch.bfloat16, cuda, False)),
                      ("cpu", make(torch.float32, "cpu", False))):
        mod.load_state_dict(card.state_dict())
        dev = next(mod.parameters()).device
        x = img.to(dev).requires_grad_(True)
        reset_launches()
        outs = mod(x) if mask is None else mod(x, mask.to(dev))
        outs = outs if isinstance(outs, tuple) else (outs,)
        sum((o.float() * torch.linspace(-1, 1, o.numel(), device=dev).reshape(o.shape)).sum()
            for o in outs).backward()
        torch.cuda.synchronize()
        res[name] = ([o.detach().float().cpu() for o in outs], x.grad.cpu(),
                     {k: v.launches for k, v in KERNELS.items() if v.launches})
    return res


def _check_backbone(res):
    """Outputs within 5e-2 of the largest value of the f32 CPU module's; the
    image gradient no further from the CPU's (relative norm) than 1.5x the
    bf16 plain module's own distance (bf16 rounding moves a network's
    input gradient by several %, so the plain bf16 module is the witness)."""
    for a, r in zip(res["card"][0], res["cpu"][0]):
        _rel_close(a, r, 5e-2, "outputs")

    def dist(a, r):
        return float((a.float() - r.float()).norm() / r.float().norm())

    noise = dist(res["plain"][1], res["cpu"][1])
    assert dist(res["card"][1], res["cpu"][1]) <= 1.5 * noise, noise


@pytest.mark.gpu
def test_mae_encoder_on_card(cuda):
    """A narrow split-attention MAE encoder with LayerScale (depth 4, 2 heads
    of 64, window 2 on a 4x6 grid): 4 flash launches forward, 4 + 4
    backward; the pyramid and the image gradient against the f32 module
    on the CPU (``_check_backbone``)."""
    from attentionshift_torch.models.mae_encoder import MAEVisionTransformer

    kw = dict(embed_dim=128, depth=4, num_heads=2, out_indices=(0, 1, 2, 3), init_values=0.1,
              split_attn_freq=2, window=2)
    img = torch.from_numpy(np.random.RandomState(4).randn(1, 64, 96, 3).astype(np.float32))
    res = _backbone_on_both(lambda dt, dev, k: MAEVisionTransformer(
        **kw, use_kernel=k, dtype=dt, device=dev).init_weights(seed=1), img, cuda)
    _check_backbone(res)
    assert res["card"][2] == dict(attention_plain=4, attention_bwd_dq=4, attention_bwd_dkv=4)


@pytest.mark.gpu
def test_mim_vit_and_heads_on_card(cuda):
    """A narrow MIM ViT (depth 2) with a mask on the card against the f32 CPU
    module (``_check_backbone``), 2 + 2 + 2 launches; the iBOT and DINO
    heads on the card's tokens against the CPU (1e-4 of the largest
    logit)."""
    from attentionshift_torch.models.ssl import DINOHead, IBOTHead, MIMViT

    img = torch.from_numpy(np.random.RandomState(5).randn(2, 48, 64, 3).astype(np.float32))
    mask = torch.from_numpy(np.random.RandomState(6).rand(2, 12) < 0.4)
    res = _backbone_on_both(lambda dt, dev, k: MIMViT(
        embed_dim=128, depth=2, num_heads=2, img_size=64, use_kernel=k, dtype=dt, device=dev)
        .init_weights(seed=2), img, cuda, mask)
    _check_backbone(res)
    assert res["card"][2] == dict(attention_plain=2, attention_bwd_dq=2, attention_bwd_dkv=2)
    tokens = res["card"][0][0]
    for make in (lambda dev: IBOTHead(128, 64, patch_out_dim=96, hidden_dim=64, bottleneck_dim=32,
                                      device=dev),
                 lambda dev: DINOHead(128, 256, hidden_dim=64, bottleneck_dim=32, device=dev)):
        hc = make(cuda).init_weights(seed=3)
        hh = make("cpu")
        hh.load_state_dict({k: v.cpu() for k, v in hc.state_dict().items()})
        got, want = hc(tokens.to(cuda)), hh(tokens)
        for a, r in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            _rel_close(a, r, 1e-4, "head logits")


@pytest.mark.gpu
def test_det_cams_on_card(cuda):
    """EigenCAM (rank one + 1 % noise) and FeatmapAM on the card against the
    CPU; grad-CAM of a narrow bf16 detector's top detection against the
    CPU's f32 heads on the card's backbone outputs, within 1e-3."""
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.utils.det_cam import eigen_cam, featmap_am, grad_cam, grad_cam_from_feats

    g = torch.Generator().manual_seed(7)
    acts = (torch.randn(64, 1, 1, generator=g) * torch.rand(1, 10, 12, generator=g)
            + 0.01 * torch.randn(64, 10, 12, generator=g))
    torch.testing.assert_close(eigen_cam(acts.to(cuda)).cpu(), eigen_cam(acts), atol=1e-3, rtol=0)
    torch.testing.assert_close(featmap_am(acts.to(cuda)).cpu(), featmap_am(acts), atol=1e-5, rtol=0)
    kw = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, point_tokens=16, cam_layer=3,
              out_indices=(0, 1, 2, 3), num_proposals=50, test_max_per_img=10, test_score_thr=0.02)
    model = AttnShiftDetector(device=cuda, dtype=torch.bfloat16, **kw).init_weights(seed=0)
    img = torch.from_numpy(np.random.RandomState(8).randn(1, 64, 96, 3).astype(np.float32)).to(cuda)
    wh = torch.tensor([[96.0, 64.0]], device=cuda)
    with torch.no_grad():
        out, roi_map, _ = model._extract(img, with_features=True, capture=False)
        dets = model.test_from_feats(out, roi_map, wh, (64, 96)).dets
    assert bool(dets.valid[0].any())
    k = int(dets.valid[0].int().argmax())
    fb, fl = dets.boxes[0, k:k + 1].float(), dets.labels[0, k:k + 1]
    cam = grad_cam(model, img, wh, fb, fl)
    assert tuple(cam.shape) == (4, 6) and bool(torch.isfinite(cam).all())
    host = AttnShiftDetector(device="cpu", **kw)
    host.load_state_dict(model.state_dict())
    want = grad_cam_from_feats(host, {"feature": tuple(f.float().cpu() for f in out["feature"])},
                               roi_map.float().cpu(), wh.cpu(), (64, 96), fb.cpu(), fl.cpu())
    torch.testing.assert_close(cam.cpu(), want, atol=1e-3, rtol=0)


# ------------------------------------------------------- the learning tools


@pytest.mark.gpu
def test_debug_overfit_on_card(cuda, monkeypatch, capsys):
    """``tools.debug_overfit`` on the card, its own checks at 20 steps: the
    flagship's ``loss_total`` and ``loss_point_cls``, averaged over the last
    8 steps, below their averages over the first 8."""
    from attentionshift_torch.tools import debug_overfit

    monkeypatch.setattr(debug_overfit, "STEPS", 20)
    res = debug_overfit.main([])
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        f"OK: the model learns on {torch.cuda.get_device_name(cuda)}")
    assert res["last"]["loss_total"] < res["first"]["loss_total"]


@pytest.mark.gpu
def test_learning_check_rows_on_card(cuda, capsys):
    """``tools.analysis.learning_check`` on the card for 4 steps on the
    lobes corpus with the detection chain: both milestone rows well-formed,
    their IoUs and mAPs in [0, 1], the step-4 loss finite."""
    from attentionshift_torch.tools.analysis import learning_check

    summary = learning_check.main(["--steps", "4", "--milestones", "0", "4", "--det-eval",
                                   "--train-images", "2", "--eval-images", "2",
                                   "--corpus", "lobes"])
    rows = summary["table"]
    assert [r["step"] for r in rows] == [0, 4]
    for r in rows:
        assert list(r) == ["step", "loss", "pseudo_box_iou", "pseudo_mask_iou", "mAP25", "mAP50",
                           "mAP75", "n_det"]
        assert all(0.0 <= r[k] <= 1.0 for k in list(r)[2:7]) and 0 <= r["n_det"] <= 200
    assert np.isfinite(rows[1]["loss"])


@pytest.mark.gpu
def test_learning_check_refuses_no_pallas_on_card(cuda):
    """The port has no plain path on the card: ``--no-pallas`` raises there."""
    from attentionshift_torch.tools.analysis import learning_check

    with pytest.raises(ValueError, match="no plain path on the card"):
        learning_check.main(["--no-pallas", "--steps", "1"])


@pytest.mark.gpu
def test_kernels_on_the_learning_paths_inputs(cuda):
    """One train step of the learning check's flagship (512x512: T = 1 +
    32 * 32 + 100 = 1125 tokens, no pad gap) with the inputs of the capture
    attention and of CCL recorded: both attention pairs on the path's own
    q, k, v (a seeded upstream gradient) and CCL on its own planes against
    their plain versions."""
    from types import SimpleNamespace
    from unittest import mock

    from attentionshift_torch.models import layers
    from attentionshift_torch.pseudo import engine
    from attentionshift_torch.tools.analysis import learning_check as lc
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step

    seen = {}

    def keep(module, name):
        fn = getattr(module, name)

        def record(*args, **kwargs):
            seen[name] = ([a.detach().clone() if torch.is_tensor(a) else a for a in args], kwargs)
            return fn(*args, **kwargs)

        return mock.patch.object(module, name, record)

    model = lc.build_model(SimpleNamespace(f32=False), cuda)
    s = lc.make_sample(np.random.RandomState(0), 0, "lobes")
    batch = dict(zip(("img", "gt_points", "gt_labels", "gt_valid"), lc._on(cuda, *s[:4])),
                 img_wh=torch.tensor([[512.0, 512.0]], device=cuda))
    state = TrainState.create(model, build_optimizer(model, accumulate_steps=1, warmup_iters=20))
    with keep(layers, "attention_with_capture"), keep(engine, "connected_components_batch"):
        make_train_step(model)(state, batch, generator=torch.Generator(device=cuda).manual_seed(42))
    (q, k, v, *pad), akw = seen["attention_with_capture"]
    gap = akw.get("pad_interval", pad[0] if pad else None)
    assert tuple(q.shape) == (1, 6, 1125, 64) and q.dtype == torch.bfloat16 and gap is None
    # views of the fused qkv; the autograd op copies them contiguous, as here
    q, k, v = (x.contiguous() for x in (q, k, v))
    g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda).bfloat16()
    _check_attention_pair(q, k, v, g, gap)
    (planes, *rest), ckw = seen["connected_components_batch"]
    iters = ckw.get("max_iters", rest[0] if rest else 256)
    assert tuple(planes.shape) == (7 * 8, 32, 32)
    assert torch.equal(ccl.connected_components_batch(planes, iters),
                       ccl.connected_components(planes, iters))


@pytest.mark.gpu
@pytest.mark.parametrize("capture", [False, True])
def test_attention_custom_ops_on_card(cuda, capture):
    """The attention custom ops on CUDA tensors: ``opcheck`` holds the fake
    implementation and the autograd registration to the CUDA one; q, k, v
    as head-split views of one qkv buffer (made contiguous in the graph)
    give the plain backward's gradients within 4 bf16 ulps, also when
    ``torch.utils.checkpoint`` runs the op again for the backward; each
    forward counts one launch."""
    from torch.utils.checkpoint import checkpoint

    from attentionshift_torch.ops._build import KERNELS, reset_launches

    op = torch.ops.attentionshift.attention_capture if capture else \
        torch.ops.attentionshift.attention_plain
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = torch.randn((1, 300, 3, 6, 64), generator=gen, device=cuda).bfloat16()
    g = torch.randn((1, 6, 300, 64), generator=gen, device=cuda).bfloat16()
    torch.library.opcheck(op, tuple(x.contiguous() for x in qkv.permute(2, 0, 3, 1, 4)) + (250, 270))
    fn = attention.attention_with_capture if capture else attention.attention_no_capture
    plain = [x.transpose(1, 2) for x in qkv.unbind(2)]
    want = attention.attention_backward_reference(*plain, g, (250, 270))
    for remat in (False, True):
        leaf = qkv.clone().requires_grad_(True)
        q, k, v = (x.transpose(1, 2) for x in leaf.unbind(2))
        reset_launches()

        def run(q, k, v):
            out = fn(q, k, v, (250, 270))
            return out[0] if capture else out

        out = checkpoint(run, q, k, v, use_reentrant=False) if remat else run(q, k, v)
        (grad,) = torch.autograd.grad(out, leaf, g)
        torch.cuda.synchronize()
        name = "attention_capture" if capture else "attention_plain"
        assert KERNELS[name].launches == (2 if remat else 1)
        for i, w in enumerate(want):
            torch.testing.assert_close(grad[:, :, i].transpose(1, 2).float(), w.float(),
                                       atol=_ulps(w, 4), rtol=0, msg=f"d{'qkv'[i]}")


@pytest.mark.gpu
def test_export_round_trip_on_card(cuda, tmp_path, capsys):
    """``export_program`` on the card (a narrow bf16 detector, head dim 64):
    the program round-trips at 1e-5 and one run of the reloaded program
    launches ``flash_fwd`` once per block and nothing else."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.tools.deployment import export_program

    cfg = tmp_path / "narrow.py"
    cfg.write_text("model = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, "
                   "out_indices=(0, 1, 2, 3), point_tokens=16, cam_layer=3, max_gt=4, "
                   "num_proposals=50, test_max_per_img=10)\n"
                   "data = dict(test_scale=(96, 160), max_gt=4)\n")
    out = tmp_path / "det.pt2"
    res = export_program.main([str(cfg), "--out", str(out), "--scale", "96", "160"])
    assert "round-trip check OK" in capsys.readouterr().out
    program = torch.export.load(str(out)).module()
    reset_launches()
    with torch.no_grad():
        program(torch.zeros((1, 96, 160, 3), device=cuda), res["args"][-1])
    torch.cuda.synchronize()
    assert KERNELS["attention_plain"].launches == 4
    assert sum(k.launches for k in KERNELS.values()) == 4


# tensor, sequence and pipeline parallelism: two ranks share the card over
# gloo (NCCL refuses two ranks on one device); the kernels run on the card in
# each rank, the collectives through the host
def _two_ranks(case: str, out: str) -> None:
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(case, out, port), nprocs=2)


def _vit_s(dev, dtype, **kw):
    """ViT-S (6 heads of 64) with 100 point tokens, seeded init."""
    from attentionshift_torch.models import AttnShiftDetector

    return AttnShiftDetector(device=dev, dtype=dtype, max_gt=4, use_remat=False,
                             **kw).init_weights(0).backbone


def _rank(rank: int, case: str, out: str, port: int) -> None:
    import os

    torch.set_num_threads(1)
    from unittest import mock

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port), ATTNSHIFT_DIST_BACKEND="gloo")
    import torch.distributed as dist

    from attentionshift_torch.models import layers
    from attentionshift_torch.models.vit import vit_forward_pp
    from attentionshift_torch.parallel import collectives, mesh as pmesh, pp as pp_mod
    from attentionshift_torch.parallel.tp import TPContext, scatter_to_sp, shard_params_tp

    _, _, dev = pmesh.init_distributed(torch.device("cuda"))
    assert dist.get_backend() == "gloo"
    mesh = pmesh.make_mesh(1, 2)
    tp = TPContext(mesh.model_group, 2, rank)
    res = {}
    if case == "capture":
        g = torch.Generator(device=dev).manual_seed(3)
        q, k, v = (torch.randn((1, 6, 4352, 64), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        gap = (4201, 4252)
        mine = [t[:, 3 * rank:3 * rank + 3].contiguous() for t in (q, k, v)]
        out_l, mean = attention.attention_with_capture_sharded(*mine, gap, tp)
        res = dict(out=out_l, mean=mean, local=attention.attention_with_capture(*mine, gap)[1])
        res["want"] = attention.attention_with_capture(q, k, v, gap)
    else:
        img = torch.from_numpy(np.random.RandomState(0).randn(2, 224, 224, 3)
                               .astype(np.float32)).to(dev)
        single = _vit_s(dev, torch.bfloat16)
        with torch.no_grad():
            res["single"] = [single(img[b:b + 1]) for b in range(2)]
            ref = _vit_s(dev, torch.float32)
            for blk in ref.blocks:
                blk.attn.use_kernel = False
            res["ref32"] = [ref(img[b:b + 1]) for b in range(2)]
            if case == "sp":
                sp = _vit_s(dev, torch.bfloat16, sequence_parallel=True)
                shard_params_tp(sp, mesh)
                res["got"] = [sp(img[b:b + 1]) for b in range(2)]
                # the control: the row-parallel partial sums sliced to the
                # rank's tokens instead of reduce-scattered
                with mock.patch.object(layers, "reduce_scatter_sp", scatter_to_sp):
                    res["control"] = [sp(img[b:b + 1]) for b in range(2)]
            else:
                def per_image(pp):
                    return [{k: v[b:b + 1] if k != "attns" else v[:, b:b + 1]
                             for k, v in pp.items() if torch.is_tensor(v)} for b in range(2)]

                res["got"] = per_image(vit_forward_pp(single, img, tp, num_microbatches=2))
                staged = dict(collectives.STAGING)
                # the control: the two stages swapped
                with mock.patch.object(pp_mod, "shard_stage_params",
                                       lambda st, tpc: {n: t[1 - tpc.rank] for n, t in st.items()}):
                    res["control"] = per_image(vit_forward_pp(single, img, tp,
                                                              num_microbatches=2))
        res["staging"] = staged if case == "pp" else dict(collectives.STAGING)
    if rank == 0:
        torch.save({k: v for k, v in res.items()}, out)
    dist.destroy_process_group()


@pytest.mark.gpu
def test_tensor_parallel_capture_attention_on_card(cuda, tmp_path):
    """Two ranks on one card, each the capture kernel on 3 of the 6 heads
    of (1, 6, 4352, 64) bf16 q, k, v with the bench gap: the rank's heads'
    output within one bf16 step of the single-rank kernel's, and the head
    mean rebuilt with one all-reduce within ``capture_mean_limit`` per
    entry; the control, the rank's own 3-head mean, misses it."""
    from attentionshift_torch.ops.numerics import bf16_steps

    out = str(tmp_path / "r0.pt")
    _two_ranks("capture", out)
    r = torch.load(out, weights_only=True)
    want_out, want_mean = r["want"]
    limit = attention.capture_mean_limit(want_mean)
    assert float(((r["mean"].float() - want_mean.float()).abs() / limit).max()) <= 1.0
    assert float(((r["local"].float() - want_mean.float()).abs() / limit).max()) > 1.0
    heads = want_out[:, :3].float()
    assert bool(((r["out"].float() - heads).abs() <= bf16_steps(heads)).all())


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _within_rounding(r: dict) -> None:
    """Each image's outputs no further from the f32 plain path than 1.5x
    the single-rank bf16 path is, plus 1e-3 of the largest value: what bf16
    rounding alone gives is the witness. The control's outputs must fail
    the same limit."""
    keys = ("point_tokens", "outputs_class", "outputs_coord", "last_feat", "attns")
    for got, ctl, single, ref in zip(r["got"], r["control"], r["single"], r["ref32"]):
        limit = {key: 1.5 * _rel(single[key], ref[key]) + 1e-3 for key in keys}
        for key in keys:
            assert _rel(got[key], ref[key]) <= limit[key], key
        assert _rel(ctl["last_feat"], ref["last_feat"]) > limit["last_feat"]


@pytest.mark.gpu
def test_sequence_parallel_forward_on_card(cuda, tmp_path):
    """ViT-S at 224x224 (T = 297: shards of 149 and 148 tokens) with tensor
    and sequence parallelism over two ranks on one card, against the
    single-rank path (``_within_rounding``); the control, the row-parallel
    partial sums sliced instead of reduce-scattered, misses it."""
    out = str(tmp_path / "r0.pt")
    _two_ranks("sp", out)
    _within_rounding(torch.load(out, weights_only=True))


@pytest.mark.gpu
def test_pipeline_parallel_forward_on_card(cuda, tmp_path):
    """``vit_forward_pp``: ViT-S at 224x224 over two stages (one per rank on
    one card) x two microbatches, against the single-rank path
    (``_within_rounding``); the activations went through the host. The
    control, the two stages swapped, misses it."""
    out = str(tmp_path / "r0.pt")
    _two_ranks("pp", out)
    r = torch.load(out, weights_only=True)
    _within_rounding(r)
    assert r["staging"]["calls"] > 0


@pytest.mark.gpu
def test_profiling_twins_on_card(cuda, capsys):
    """The profiling twins on the card at reduced sizes, one timed call
    after the warm-up: ``profile_seed`` at 256 x 384 launches per call
    exactly what its stage runs (7 capture + 5 plain for the backbone,
    one CCL more for Stage A, one mean-shift more for the whole path);
    ``profile_backbone`` at (1, 6, 301, 64): its summed capture maps' rows
    each sum to 7 (seven softmax means; each entry is rounded to bf16 once
    in the mean and once per addition, at most 14 roundings of 2^-8 of
    entries summing to 7: within 7 x 14 x 2^-8 = 0.39), its outputs
    finite; every line printed."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches
    from attentionshift_torch.tools.analysis import profile_backbone, profile_seed

    reset_launches()
    res = profile_seed.main(["--height", "256", "--width", "384", "--steps", "1"])
    got = {k: v.launches for k, v in KERNELS.items() if v.launches}
    assert got == {"attention_capture": 3 * 7 * 2, "attention_plain": 3 * 5 * 2,
                   "ccl_batch": 2 * 2, "meanshift_fixpoint": 2}
    assert list(res["times"]) == list(profile_seed.LABELS)
    reset_launches()
    res = profile_backbone.main(["--tokens", "301", "--steps", "1"])
    assert {k: v.launches for k, v in KERNELS.items() if v.launches} == {
        "attention_capture": 14, "attention_plain": 10}
    out, acc = res["outputs"][profile_backbone.LAYERS[0][0]]
    assert torch.isfinite(out.float()).all()
    assert (acc.float().sum(-1) - 7.0).abs().max() <= 7 * 14 * 2.0**-8
    assert len([x for x in capsys.readouterr().out.splitlines() if x.endswith("ms/layer)")]) == 3


@pytest.mark.gpu
def test_diagnosis_twins_on_card(cuda, tmp_path, capsys):
    """``diagnose_det`` (2 steps, 1 held-out image) and ``probe_rpn`` (2 steps
    with ``--save-ckpt``, then ``--ckpt``) on the card: the rows carry the
    JAX tools' keys with values in range, and the restored probe's two
    reports equal the trained run's."""
    from attentionshift_torch.tools.analysis import diagnose_det, probe_rpn

    rows = diagnose_det.main(["--steps", "2", "--train-images", "2", "--eval-images", "1"])
    assert len(rows) == 1 and 0 <= rows[0]["n_det"] <= 100
    assert all(0.0 <= x <= 1.0 for x in rows[0]["rpn_recall"] + rows[0]["truebox_p_bg"])
    ckpt = tmp_path / "probe.pt"
    first = probe_rpn.main(["--steps", "2", "--save-ckpt", str(ckpt)])
    again = probe_rpn.main(["--ckpt", str(ckpt)])
    assert first == again and [r["tag"] for r in first] == ["train0", "held0"]
    assert all(r["cand_nan_scores"] == 0 == r["cand_nan_boxes"] for r in first)
    ckpt.unlink()


@pytest.mark.gpu
def test_fidelity_study_on_card(cuda, tmp_path):
    """``fidelity_study`` on the card (1 inline step, 1 image, ``--count-cut``):
    the report's sections, bf16 on the card, the CCL planes cut per
    configuration counted (the exact config's (56, 512, 512) planes at 256
    sweeps among them), the markdown only at ``--out`` and
    ``FIDELITY.md`` left as it was."""
    import hashlib
    import os

    from attentionshift_torch.tools.analysis import fidelity_study

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    md = os.path.join(repo, "FIDELITY.md")
    before = hashlib.sha256(open(md, "rb").read()).hexdigest()
    out = tmp_path / "fidelity.md"
    rep = fidelity_study.main(["--train-steps", "1", "--eval-images", "1", "--count-cut",
                               "--out", str(out)])
    assert rep["dtype"] == "bfloat16" and rep["end_to_end"]["n"] == 2
    assert "512x512 cap 256" in rep["ccl_planes_cut"]
    assert all(0 <= c <= n for c, n in rep["ccl_planes_cut"].values())
    assert out.read_text().startswith("# FIDELITY") and os.listdir(tmp_path) == ["fidelity.md"]
    assert hashlib.sha256(open(md, "rb").read()).hexdigest() == before


@pytest.mark.gpu
def test_meanshift_on_profile_seed_inputs(cuda, capsys):
    """The mean-shift kernel on the inputs ``profile_seed``'s whole
    ``seed_pseudo_gt`` hands it (ViT-S, ``init_weights(0)``, the JAX tool's
    800 x 1344 image, bf16), printed: per instance and per iteration count
    1-10, the kernel's deviation from the plain version
    (``instance_deviation``, prototypes and similarities apart), with bf16
    operands and in f32; the nearest of 512 reordered plain versions; the
    kernel built with other reduction splits (``MS_ROW_PARTS`` 2 and 8,
    ``MS_ROUND_BOXES`` 2); the plain version on the tensor cores. Asserted:
    every instance passes the fixpoint verdict with ``chip_smoke``'s budget
    (floor 2e-3 bf16, 1e-4 f32, up to 64 witnesses, ``MS_WITNESS_MAX``),
    and the plain version with the temperature 10 % off (a faulty kernel)
    fails some instance."""
    from attentionshift_torch.ops import _build
    from attentionshift_torch.pseudo import meanshift
    from attentionshift_torch.tools.analysis import profile_seed

    variants = (("MS_ROW_PARTS=2",), ("MS_ROW_PARTS=8",), ("MS_ROUND_BOXES=2",))
    _build.build_all([("meanshift", d) for d in variants])
    args = profile_seed.parse_args([])
    model = profile_seed.build_model(args, cuda)
    inp = profile_seed.make_inputs(args.height, args.width, args.max_gt, cuda)
    seen = {}
    inner = meanshift.cosine_shift_fixpoint

    def record(*a, **kw):
        seen["args"] = ([x.detach().clone() if torch.is_tensor(x) else x for x in a], dict(kw))
        return inner(*a, **kw)

    meanshift.cosine_shift_fixpoint = record
    try:
        model.seed_pseudo_gt(*inp, generator=torch.Generator(device=cuda).manual_seed(5))
    finally:
        meanshift.cosine_shift_fixpoint = inner
    (prot0, mask, f, *_), kw = seen["args"]
    kw = {k: v for k, v in kw.items() if k not in ("lib", "n_shift")}

    def rounded(x):
        return [round(float(v), 6) for v in x[:8]]

    bad = []
    for mm, floor in ((torch.bfloat16, 2e-3), (None, 1e-4)):
        kw["matmul_dtype"] = mm
        for n in range(1, 11):
            got = meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, n_shift=n, **kw)
            want = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f,
                                                       n_shift=n, **kw)
            dp = meanshift_kernel.instance_deviation((got[0], want[1]), want)
            ds = meanshift_kernel.instance_deviation((want[0], got[1]), want)
            print(f"meanshift {mm} n_shift {n}: prototypes {rounded(dp)} sim {rounded(ds)}")
        near = None
        for seed in range(8):
            for w in meanshift_kernel.reordered_witnesses(prot0, mask, f, n_shift=10, orders=64,
                                                          seed=100 + seed, f64=False, **kw):
                d = meanshift_kernel.instance_deviation(got, w)
                near = d if near is None else torch.minimum(near, d)
        print(f"meanshift {mm} kernel's nearest of 512 reordered plain versions: {rounded(near)}")
        tc = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f, n_shift=10,
                                                 tensor_cores=True, **kw)
        print(f"meanshift {mm} kernel from the plain version on the tensor cores: "
              f"{rounded(meanshift_kernel.instance_deviation(got, tc))}")
        for defines in variants:
            var = meanshift_kernel.cosine_shift_fixpoint(
                prot0, mask, f, n_shift=10, lib=_build.library("meanshift", defines), **kw)
            print(f"meanshift {mm} kernel built with {defines}: from the plain version "
                  f"{rounded(meanshift_kernel.instance_deviation(var, want))}, from the kernel as "
                  f"built {rounded(meanshift_kernel.instance_deviation(var, got))}")
        off = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f, n_shift=10,
                                                  **dict(kw, temp=0.11))
        v, ctl = meanshift_kernel.fixpoint_verdict([got, off], prot0, mask, f, floor, n_shift=10,
                                                   orders=8, max_orders=64, **kw)
        print(f"meanshift {mm} verdict: dev {rounded(v['dev'])}, spread {rounded(v['spread'])}, "
              f"near {rounded(v['near'])}, {v['witnesses']} witnesses; the control fails "
              f"{int((~ctl['ok']).sum())} instances")
        if not bool(v["ok"].all()) or bool(ctl["ok"].all()):
            bad.append(str(mm))
    with capsys.disabled():
        print(capsys.readouterr().out)
    assert not bad, bad
