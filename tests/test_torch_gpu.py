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
    logits = torch.matmul((q * q.shape[-1] ** -0.5).float(), k.float().transpose(-1, -2))
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
def test_attention_mean_refuses_more_heads_than_it_holds(cuda):
    """A CUDA tensor launches the kernel or raises: the mean pass keeps
    every head's query tile in shared memory, at most 16 heads."""
    q = torch.zeros((1, 17, 64, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.attention_with_capture(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,gap", ATTENTION_CASES)
def test_attention_backward_kernels_on_card(cuda, b, h, t, gap):
    """Both backward kernels (through the autograd Functions) vs the plain
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
def test_attention_backward_kernels_are_deterministic(cuda):
    """No atomics: two backward calls on the same inputs give bitwise equal
    dq, D, dk and dv."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, g = (torch.randn((2, 3, 300, 64), generator=gen, device=cuda).bfloat16()
                  for _ in range(4))
    out, lse = attention.flash_forward(q, k, v, (120, 140), with_lse=True)
    runs = []
    for _ in range(2):
        dq, dd = attention.attention_backward_dq(q, k, v, out, lse, g, (120, 140))
        runs.append((dq, dd, *attention.attention_backward_dkv(q, k, v, lse, dd, g, (120, 140))))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _ulps(ref, n):
    top = float(ref.float().abs().max())
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [300, 301])
@pytest.mark.parametrize("variant", list(attention_variants.VARIANTS))
def test_attention_variant_kernels_on_card(cuda, variant, t):
    """Each design variant's kernel vs its plain version at a ragged T
    (300 = 4 key tiles of 64 + 44; 300 rows = 4 blocks of 64 + 44) and at
    an odd one (301: the mean's last column has no partner to be stored
    with, as at the microbenchmark's default 4301), on random inputs and on the clamp input (two shifted logits of one row in
    (100, 127)). bf16 outputs: ``out`` within 4 bf16 ulps of the largest
    |out|, ``mean`` within 2^-9 of its largest entry (one rounding of the
    stored bf16). Control: on the clamp input the plain version of the
    other clamp behaviour (v3's for the clamped variants, v2's for v3)
    exceeds both limits, so the check sees whether the kernel clamps."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((2, 3, t, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    other = "v2-bf16e" if variant == "v3-nomin" else "v3-nomin"
    for case in ((q, k, v), attention_variants.clamp_case(q, k, v)):
        want_out, want_mean = attention_variants.variant_reference(*case, variant)
        out, mean = attention_variants.attention_variant(*case, variant)
        torch.cuda.synchronize()
        out_tol = _ulps(want_out, 4)
        mean_tol = 2e-3 * float(want_mean.float().abs().max())
        torch.testing.assert_close(out.float(), want_out.float(), atol=out_tol, rtol=0)
        torch.testing.assert_close(mean.float(), want_mean.float(), atol=mean_tol, rtol=0)
    ctl_out, ctl_mean = attention_variants.variant_reference(*case, other)
    assert float((out.float() - ctl_out.float()).abs().max()) > out_tol
    assert float((mean.float() - ctl_mean.float()).abs().max()) > mean_tol


@pytest.mark.gpu
def test_attention_variant_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA tensor launches the kernel or raises: f32 inputs, a head dim
    other than 64 and more than 8 heads side by side are refused."""
    q = torch.zeros((1, 2, 64, 64), device=cuda)
    with pytest.raises(ValueError):
        attention_variants.attention_variant(q, q, q, "v2-bf16e")
    q = torch.zeros((1, 2, 64, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention_variants.attention_variant(q, q, q, "v4-mxsum")
    q = torch.zeros((1, 9, 64, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention_variants.attention_variant(q, q, q, "v5-batched")


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
        want_out, want_mean = attention_variants.variant_reference(q, k, v, variant)
        out, mean = attention_variants.attention_variant(q, k, v, variant)
        torch.testing.assert_close(out.float(), want_out.float(), atol=_ulps(want_out, 4), rtol=0)
        torch.testing.assert_close(mean.float(), want_mean.float(),
                                   atol=2e-3 * float(want_mean.float().abs().max()), rtol=0)


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
