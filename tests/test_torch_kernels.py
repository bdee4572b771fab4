"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version; here that plain
version is held against the JAX kernel run in Pallas interpret mode, on
the same numpy inputs. ``test_torch_gpu`` holds the CUDA kernels against
the plain versions on the card.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from attentionshift_torch.ops import attention, ccl, meanshift_kernel  # noqa: E402
from test_torch_gpu import ccl_planes  # noqa: E402


def _interpret_pallas():
    """Patch ``pallas_call`` to interpret mode (as tests/test_ops.py does)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        k.pop("compiler_params", None)
        return orig(*a, **k)

    return mock.patch.object(pl, "pallas_call", interp)


def _qkv(b, h, t, d, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("pad", [None, (150, 170)])
def test_attention_capture_matches_pallas_kernel(pad):
    """Port plain capture attention vs ``_kernel`` (ops/attention.py:251)
    in interpret mode; T=200 also exercises the kernel's trailing pad.
    f32 throughout: 1e-5 covers the kernel's constant-shift exp2 softmax
    against the row-max softmax."""
    from attentionshift_tpu.ops.attention import _pallas_forward

    q, k, v = _qkv(1, 2, 200, 64)
    want_out, want_mean = _pallas_forward(*map(jnp.asarray, (q, k, v)), interpret=True,
                                          pad_interval=pad)
    out, mean = attention.attention_with_capture(*map(torch.from_numpy, (q, k, v)), pad)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=1e-6)
    if pad is not None:
        assert float(mean[:, :, pad[0]:pad[1]].abs().max()) == 0.0


@pytest.mark.parametrize("pad", [None, (150, 170)])
def test_attention_plain_matches_pallas_kernel(pad):
    """Port plain attention vs ``_plain_kernel`` (ops/attention.py:315)."""
    from attentionshift_tpu.ops.attention import attention_no_capture as jax_plain

    q, k, v = _qkv(2, 2, 200, 64, seed=1)
    want = jax_plain(*map(jnp.asarray, (q, k, v)), True, True, pad)
    got = attention.attention_no_capture(*map(torch.from_numpy, (q, k, v)), pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("max_iters", [64, 2])
def test_ccl_matches_pallas_kernel(max_iters):
    """Port plain CCL vs ``_ccl_batch_kernel`` (ops/ccl.py:200) on 50x84
    planes (the bench plane) — exact, also when the sweep cap cuts the
    serpentine plane before convergence."""
    from attentionshift_tpu.ops import ccl as jccl

    masks = ccl_planes(6, 50, 84)
    with _interpret_pallas():
        want = jccl.connected_components_batch(jnp.asarray(masks), 8, max_iters, use_pallas=True)
    got = ccl.connected_components_batch(torch.from_numpy(masks), max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_iters == 64:
        from scipy import ndimage

        for i in range(len(masks)):
            n_ref = ndimage.label(masks[i], np.ones((3, 3)))[1]
            assert len(np.unique(got[i].numpy())) - 1 == n_ref


def test_ccl_sweep_counts():
    """``return_sweeps`` counts, per plane, the sweeps to its fixpoint plus
    the one that finds it unchanged: one sweep fewer already gives the
    plane's labels, two fewer do not; a plane cut at the cap counts it."""
    masks = torch.from_numpy(ccl_planes(6, 50, 84))
    labels, sweeps = ccl.connected_components(masks, 64, return_sweeps=True)
    assert torch.equal(labels, ccl.connected_components(masks, 64))
    assert sweeps[-1] == 1  # the empty plane
    for i, s in enumerate(sweeps.tolist()):
        plane = masks[i:i + 1]
        assert torch.equal(ccl.connected_components(plane, s - 1), labels[i:i + 1])
        if s >= 2:
            assert not torch.equal(ccl.connected_components(plane, s - 2), labels[i:i + 1])
    capped = ccl.connected_components(masks, 2, return_sweeps=True)[1]
    assert capped.tolist() == [min(s, 2) for s in sweeps.tolist()]


@pytest.mark.parametrize("matmul_dtype", [None, "bfloat16"])
def test_meanshift_matches_pallas_kernel(matmul_dtype):
    """Port plain mean-shift vs ``_kernel`` (ops/meanshift_kernel.py:47),
    with a fully masked (padded) instance. f32: 1e-5 (summation order);
    bf16 dot operands: the same rounding on both sides, 1e-4."""
    from attentionshift_tpu.ops.meanshift_kernel import cosine_shift_fixpoint

    rs = np.random.RandomState(0)
    g, k, n, d = 4, 6, 40, 16
    f = rs.randn(n, d).astype(np.float32)
    mask = (rs.rand(g, n) > 0.4).astype(np.float32)
    mask[2] = 0.0
    prot0 = rs.randn(g, k, d).astype(np.float32)
    jdt = None if matmul_dtype is None else jnp.bfloat16
    tdt = None if matmul_dtype is None else torch.bfloat16
    want_p, want_s = cosine_shift_fixpoint(jnp.asarray(prot0), jnp.asarray(mask), jnp.asarray(f),
                                           n_shift=4, matmul_dtype=jdt, interpret=True)
    got_p, got_s = meanshift_kernel.cosine_shift_fixpoint(
        *map(torch.from_numpy, (prot0, mask, f)), n_shift=4, matmul_dtype=tdt)
    tol = 1e-5 if matmul_dtype is None else 1e-4
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=tol, atol=tol)


def test_kernel_wrappers_count_only_their_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    reset_launches()
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 16, 64))
    attention.attention_with_capture(q, k, v)
    attention.attention_no_capture(q, k, v)
    ccl.connected_components_batch(torch.ones((1, 4, 4), dtype=torch.bool))
    assert all(kr.launches == 0 for kr in KERNELS.values())
    assert {kr.name for kr in KERNELS.values()} == {
        "attention_capture", "attention_plain", "ccl_batch", "meanshift_fixpoint"}
