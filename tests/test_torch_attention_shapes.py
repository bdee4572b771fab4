"""The attention pair at the head shapes beyond the ViT's, against JAX.

Swin's global blocks take 24 heads of 32; the JAX package's Pallas
kernels (``attentionshift_tpu/ops/attention.py``: ``_kernel``,
``_plain_kernel``, ``_bwd_kernel_dq``, ``_bwd_kernel_dkv``) take any head
dim and any head count. Here they run in interpret mode on the CPU, the
forward through ``attention_with_capture(..., use_pallas=True,
interpret=True)`` and ``attention_no_capture`` and the backward through
``jax.vjp`` of them (the Pallas backward pair), against the port's plain
versions, ``attention_reference`` and ``attention_backward_reference``,
which is what the port's ops run on a CPU tensor and what its kernels
are held to on the card. f32, inputs from numpy seeds, at (1, 24, 190,
32), at (1, 6, 256, 32) with a gap and at (1, 20, 128, 64).

Tolerances: 2e-5 of each output's largest magnitude for ``out``, the
head mean and the gradients (f32 on both sides; the TPU kernel
exponentiates in base 2 with a constant shift where the plain version
takes ``softmax``, and sums in other orders). Gap columns of the mean
and of dk, dv are exactly zero on both sides.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import close  # noqa: E402

REL = 2e-5
# (B, H, T, d, gap): Swin's heads at a ragged T; head dim 32 with a gap
# inside the last 128-row tile; more than 16 heads at 64
CASES = [(1, 24, 190, 32, None), (1, 6, 256, 32, (200, 230)), (1, 20, 128, 64, None)]


def _inputs(b, h, t, d, gap, seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    if gap is not None:  # the gap's rows have no consumer in the model
        g[:, :, gap[0]:gap[1]] = 0.0
    return q, k, v, g


def _rel(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    close(got, want, REL * max(np.abs(want).max(), 1e-30), what=what)


@pytest.mark.parametrize("b,h,t,d,gap", CASES)
def test_forward_pair_matches_the_pallas_kernels(b, h, t, d, gap):
    from attentionshift_torch.ops import attention
    from attentionshift_tpu.ops import attention as jatt

    q, k, v, _ = _inputs(b, h, t, d, gap)
    jout, jmean = jatt.attention_with_capture(*map(jnp.asarray, (q, k, v)), True, True, gap)
    jplain = jatt.attention_no_capture(*map(jnp.asarray, (q, k, v)), True, True, gap)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, mean = attention.attention_reference(tq, tk, tv, gap)
    _rel(out, jout, "out (capture kernel)")
    _rel(out, jplain, "out (plain kernel)")
    _rel(mean, jmean, "head mean")
    # the port's op on a CPU tensor is this plain version
    got_out, got_mean = attention.attention_with_capture(tq, tk, tv, gap)
    assert torch.equal(got_out, out) and torch.equal(got_mean, mean)
    if gap is not None:
        assert float(mean[:, :, gap[0]:gap[1]].abs().max()) == 0.0
        assert float(np.abs(np.asarray(jmean)[:, :, gap[0]:gap[1]]).max()) == 0.0


@pytest.mark.parametrize("capture", [False, True], ids=["plain", "capture"])
@pytest.mark.parametrize("b,h,t,d,gap", CASES)
def test_backward_pair_matches_the_pallas_kernels(b, h, t, d, gap, capture):
    from attentionshift_torch.ops import attention
    from attentionshift_tpu.ops import attention as jatt

    q, k, v, g = _inputs(b, h, t, d, gap, seed=1)
    if capture:
        def op(q, k, v):
            return jatt.attention_with_capture(q, k, v, True, True, gap)[0]
    else:
        def op(q, k, v):
            return jatt.attention_no_capture(q, k, v, True, True, gap)
    _, vjp = jax.vjp(op, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = attention.attention_backward_reference(*map(torch.from_numpy, (q, k, v, g)), gap)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _rel(a, w, name)
    # the port's autograd on a CPU tensor takes this plain backward
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    op_t = attention.attention_with_capture if capture else attention.attention_no_capture
    out = op_t(*leaves, gap)
    out = out[0] if capture else out
    for a, w in zip(torch.autograd.grad(out, leaves, torch.from_numpy(g)), got):
        assert torch.equal(a, w)
    if gap is not None:
        for a, w in zip(got[1:], want[1:]):
            assert float(a[:, :, gap[0]:gap[1]].abs().max()) == 0.0
            assert float(np.abs(np.asarray(w)[:, :, gap[0]:gap[1]]).max()) == 0.0
