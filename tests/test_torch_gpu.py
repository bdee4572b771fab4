"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one; they import no JAX, so they run on a GPU machine with

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from attentionshift_torch.ops import attention, ccl, meanshift_kernel  # noqa: E402


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


@pytest.mark.gpu
def test_attention_kernels_on_card(cuda):
    """Both attention kernels vs the plain version at a small shape with a
    gap and a ragged T; bf16 outputs: 4 bf16 ulps of the largest |out|,
    a limit the plain version without the gap exceeds."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 3, 300, 64), generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    ref_out, ref_mean = attention.attention_reference(q, k, v, (250, 270))
    out, mean = attention.attention_with_capture(q, k, v, (250, 270))
    out2 = attention.attention_no_capture(q, k, v, (250, 270))
    top = float(ref_out.float().abs().max())
    tol = 4 * 2.0 ** (np.floor(np.log2(top)) - 7)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(out2.float(), ref_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(mean.float(), ref_mean.float(), atol=1e-4, rtol=1e-2)
    no_gap = attention.attention_reference(q, k, v, None)[0]
    assert float((out.float() - no_gap.float()).abs().max()) > tol


@pytest.mark.gpu
def test_ccl_kernel_on_card(cuda):
    """CCL kernel vs the plain version, exact, in shared memory and (a
    plane too large for it) in device memory."""
    for (h, w) in ((50, 84), (200, 300)):
        masks = torch.from_numpy(ccl_planes(5, h, w)).to(cuda)
        for it in (64, 2):
            assert torch.equal(ccl.connected_components_batch(masks, it),
                               ccl.connected_components(masks, it))


@pytest.mark.gpu
def test_meanshift_kernel_on_card(cuda):
    """Mean-shift kernel vs the plain version: f32 1e-4 (summation order);
    bf16 operands 2e-3 (an f32 last-bit difference can move a bf16
    rounding of a weight or prototype by 2^-8)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    f = torch.randn((300, 64), generator=gen, device=cuda)
    prot0 = torch.randn((5, 20, 64), generator=gen, device=cuda)
    mask = (torch.rand((5, 300), generator=gen, device=cuda) > 0.4).float()
    for mm, tol in ((None, 1e-4), (torch.bfloat16, 2e-3)):
        want = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f,
                                                   matmul_dtype=mm)
        got = meanshift_kernel.cosine_shift_fixpoint(prot0, mask, f, matmul_dtype=mm)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=tol * float(b.abs().max()), rtol=0)
