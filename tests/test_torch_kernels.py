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


@pytest.mark.parametrize("pad", [None, (30, 37)])
@pytest.mark.parametrize("op", ["no_capture", "with_capture"])
def test_attention_backward_matches_pallas_kernels(op, pad):
    """The port's attention ops (plain backward on the CPU) vs
    ``jax.vjp`` through ``_bwd_kernel_dq`` / ``_bwd_kernel_dkv``
    (ops/attention.py:364, :402) in interpret mode, f32, T=37 (ragged
    against the kernels' 128-row tiles). Upstream gradient rows in the gap
    are zero, as in the model. 3e-5 as the JAX package's own test: the
    kernels' constant-shift exp2 softmax against the row-max softmax.
    Gap columns of dk and dv are exactly zero on both sides; the captured
    mean carries no gradient."""
    from attentionshift_tpu.ops import attention as jatt

    rs = np.random.RandomState(3)
    q, k, v, g = (rs.randn(2, 3, 37, 8).astype(np.float32) for _ in range(4))
    if pad is not None:
        g[:, :, pad[0]:pad[1]] = 0.0
    if op == "no_capture":
        jfn = lambda q, k, v: jatt.attention_no_capture(q, k, v, True, True, pad)  # noqa: E731
        tfn = attention.attention_no_capture
    else:
        jfn = lambda q, k, v: jatt.attention_with_capture(q, k, v, True, True, pad)[0]  # noqa: E731
        tfn = lambda q, k, v, p: attention.attention_with_capture(q, k, v, p)[0]  # noqa: E731
    want = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))[1](jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(tfn(*leaves, pad), leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5, err_msg=f"d{name}")
    if pad is not None:
        for a, b in zip(got[1:], want[1:]):
            assert float(a[:, :, pad[0]:pad[1]].abs().max()) == 0.0
            assert float(jnp.abs(b[:, :, pad[0]:pad[1]]).max()) == 0.0
    if op == "with_capture":
        _, mean = attention.attention_with_capture(*leaves, pad)
        assert not mean.requires_grad


def test_attention_backward_reference_is_the_softmax_gradient():
    """The plain backward (what the Functions run on the CPU) against
    PyTorch's autograd through the plain forward, f32, with a gap: 1e-6."""
    rs = np.random.RandomState(4)
    q, k, v, g = (torch.from_numpy(rs.randn(1, 2, 50, 64).astype(np.float32)) for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention.attention_reference(*leaves, (20, 30))[0], leaves, g)
    got = attention.attention_backward_reference(q, k, v, g, (20, 30))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def _jax_transposes(h: int, w: int) -> bool:
    """Whether the JAX wrapper runs the Pallas kernel on transposed planes
    (ops/ccl.py:262-265: the orientation that pads to fewer (8, 128) tiles)."""
    def padded(a, b):
        return ((a + 7) // 8 * 8) * ((b + 127) // 128 * 128)

    return padded(w, h) < padded(h, w)


@pytest.mark.parametrize("max_iters", [64, 2])
@pytest.mark.parametrize("h,w", [(50, 84), (1, 84), (50, 1), (33, 300), (100, 168)])
def test_ccl_matches_pallas_kernel(h, w, max_iters):
    """Port plain CCL vs ``_ccl_batch_kernel`` (ops/ccl.py:200): the bench
    plane (50x84), a single row and column, ragged rows against 32 lanes,
    and 100x168, which the JAX wrapper runs transposed (so does 50x1) —
    exact, also when the sweep cap cuts the serpentine plane before
    convergence. A transposed plane scans its rows first, so a cut fixpoint
    differs from the port's column-first sweep (ROADMAP, "CCL
    orientation"): there the cut labels are held against the JAX plain
    ``connected_components`` (the port's sweep) and the kernel's at
    convergence."""
    from attentionshift_tpu.ops import ccl as jccl

    masks = ccl_planes(6, h, w)
    got = ccl.connected_components_batch(torch.from_numpy(masks), max_iters)
    if _jax_transposes(h, w) and max_iters < 64:
        want = jax.vmap(lambda m: jccl.connected_components(m, 8, max_iters))(jnp.asarray(masks))
    else:
        with _interpret_pallas():
            want = jccl.connected_components_batch(jnp.asarray(masks), 8, max_iters,
                                                   use_pallas=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_iters == 64:
        from scipy import ndimage

        for i in range(len(masks)):
            n_ref = ndimage.label(masks[i], np.ones((3, 3)))[1]
            assert len(np.setdiff1d(np.unique(got[i].numpy()), [0])) == n_ref


def test_ccl_plane_buffer_choice():
    """The CCL wrapper keeps a plane in shared memory when its padded buffer
    (two int32 label planes and the mask on an odd row stride with a
    one-cell border) fits 227 KB: the bench plane and ViT-B's do, a plane
    at cam stride 4 (200x336) does not."""
    assert ccl._plane_bytes(50, 84) == 52 * 87 * 9 // 16 * 16 + 16
    assert ccl._plane_bytes(50, 84) % 16 == 0 and ccl._plane_bytes(7, 9) % 16 == 0
    assert ccl._plane_bytes(50, 84) <= ccl._SMEM_LIMIT
    assert ccl._plane_bytes(150, 150) <= ccl._SMEM_LIMIT
    assert ccl._plane_bytes(200, 336) > ccl._SMEM_LIMIT


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
@pytest.mark.parametrize("k,n", [(6, 40), (8, 40), (20, 37), (32, 131)])
def test_meanshift_matches_pallas_kernel(k, n, matmul_dtype):
    """Port plain mean-shift vs ``_kernel`` (ops/meanshift_kernel.py:47),
    with a fully masked (padded) instance, at prototype counts that fill
    each of the CUDA kernel's KP templates and N ragged against its
    64-feature tiles. f32: 1e-5 (summation order); bf16 dot operands: the
    same rounding on both sides, 1e-4."""
    from attentionshift_tpu.ops.meanshift_kernel import cosine_shift_fixpoint

    rs = np.random.RandomState(k + n)
    g, d = 4, 16
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


@pytest.mark.parametrize("matmul_dtype", [None, torch.bfloat16])
def test_meanshift_one_step_limit_holds_rounding_and_sees_a_fault(matmul_dtype):
    """``one_step_limit`` (the card's limit of one iteration on a path's own
    inputs) on nearly parallel features, as a backbone's are: the plain
    version with f64 sums stays within it of the f32 one, every entry;
    a plain version with the temperature 10 % off (a faulty kernel) does
    not."""
    rs = np.random.RandomState(7)
    g, k, n, d = 4, 8, 300, 64
    f = torch.from_numpy((rs.randn(d) + 0.3 * rs.randn(n, d)).astype(np.float32))
    mask = torch.from_numpy((rs.rand(g, n) > 0.3).astype(np.float32))
    prot0 = f[torch.from_numpy(rs.randint(0, n, (g, k)))]
    kw = dict(tau=0.1, temp=0.1, matmul_dtype=matmul_dtype)

    def plain(p, m, ff, **extra):
        return meanshift_kernel.cosine_shift_batch(p, ff[None] * m[..., None], ff, n_shift=1,
                                                   **dict(kw, **extra))

    want = plain(prot0, mask, f)
    lim = meanshift_kernel.one_step_limit(prot0, mask, f, **kw)
    f64 = plain(prot0.double(), mask.double(), f.double())
    assert all(bool(((a.double() - b).abs() <= c).all()) for a, b, c in zip(want, f64, lim))
    off = plain(prot0, mask, f, temp=0.11)
    assert max(float(((a - b).abs() / (c + 1e-30)).max()) for a, b, c in zip(off, want, lim)) > 1


@pytest.mark.parametrize("matmul_dtype", [None, torch.bfloat16])
def test_meanshift_fixpoint_verdict_passes_reordered_sums_and_sees_a_fault(matmul_dtype):
    """``fixpoint_verdict`` (the card's ten-iteration check on a path's own
    inputs) on nearly parallel features: a plain version whose sums run in
    another order passes every instance; a plain version with the
    temperature 10 % off (a faulty kernel) fails some instance; the
    witnesses put their results back in the given order, and are drawn
    until the first result passes or the cap is reached."""
    rs = np.random.RandomState(8)
    g, k, n, d = 4, 8, 300, 64
    f = torch.from_numpy((rs.randn(d) + 0.3 * rs.randn(n, d)).astype(np.float32))
    mask = torch.from_numpy((rs.rand(g, n) > 0.3).astype(np.float32))
    prot0 = f[torch.from_numpy(rs.randint(0, n, (g, k)))]
    kw = dict(n_shift=10, matmul_dtype=matmul_dtype)
    floor = 1e-4 if matmul_dtype is None else 2e-3
    pn, pd = torch.from_numpy(rs.permutation(n)), torch.from_numpy(rs.permutation(d))
    other = meanshift_kernel.cosine_shift_batch(
        prot0[..., pd], (f[pn][:, pd])[None] * mask[:, pn, None], f[pn][:, pd], **kw)
    other = (other[0][..., torch.argsort(pd)], other[1][..., torch.argsort(pn)])
    off = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f, temp=0.11, **kw)
    v, ctl = meanshift_kernel.fixpoint_verdict([other, off], prot0, mask, f, floor, orders=4,
                                               **kw)
    assert bool(v["ok"].all()) and not bool(ctl["ok"].all()) and v["witnesses"] == 5
    want = meanshift_kernel.cosine_shift_batch(prot0, f[None] * mask[..., None], f, **kw)
    wits = meanshift_kernel.reordered_witnesses(prot0, mask, f, orders=2, **kw)
    assert len(wits) == 3 and all(
        float(meanshift_kernel.instance_deviation(w, want).max()) < 0.05 for w in wits)
    # a result no witness explains draws witnesses up to the cap
    drawn = meanshift_kernel.fixpoint_verdict([off], prot0, mask, f, floor, orders=4,
                                              max_orders=8, **kw)[0]["witnesses"]
    assert drawn == 9


# clusters resident at once per cluster size (one block per SM), as
# cudaOccupancyMaxActiveClusters reported them on an H100 80GB HBM3 at the
# bench shape's shared memory (2: one block per SM of 132, not fitting
# there; 16: the non-portable size)
_ACTIVE = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 16: 7}


def test_meanshift_plan_fits_the_bench_shape_in_one_wave():
    """The host's launch plan: at the bench shape (G = 20, K = 20, N = 4200,
    D = 384, bf16) the cluster that finishes in the fewest block lifetimes
    (waves times tiles per block), here 5 blocks of 14 tiles in one wave
    (22 clusters fit), with both ring slots; if only 19 clusters of 5 fit,
    clusters of 4 (17 tiles, one wave) beat two waves of 5; clusters that
    fit nowhere are never taken."""
    plan = meanshift_kernel._plan(20, 20, 4200, 384, True, _ACTIVE.get)
    assert plan[:3] == (5, 14, 2)
    assert plan[3] == meanshift_kernel._smem_bytes(24, True, 384, 14, 2) <= 227 * 1024
    fewer = {**_ACTIVE, 5: 19}
    assert meanshift_kernel._plan(20, 20, 4200, 384, True, fewer.get)[:2] == (4, 17)
    only8 = {c: (16 if c == 8 else 0) for c in _ACTIVE}
    assert meanshift_kernel._plan(20, 20, 4200, 384, True, only8.get)[0] == 8
    assert meanshift_kernel._plan(20, 20, 4200, 384, False, _ACTIVE.get)[2] == 1


def test_meanshift_plan_takes_every_shape_the_first_kernel_took():
    """Every (K, N, D) whose shared memory the first kernel's wrapper
    accepted (clusters of 8 blocks, N rounded to 128) has a plan, ViT-B's
    D = 768 at the bench N included; beyond shared memory it raises."""
    def first_took(k, n, d):
        kp, s = -(-k // 8) * 8, -(-n // 128) * 16
        return 4 * (2 * kp * d + kp * s + 2 * s + 5 * kp) <= 227 * 1024

    always = lambda c, smem: 10**6  # noqa: E731
    for bf16 in (True, False):
        for k in (1, 8, 20, 24, 32):
            for d in (16, 64, 384, 768):
                top = 1
                while first_took(k, 2 * top, d):
                    top *= 2
                lo, hi = top, 2 * top  # the largest N it took, by bisection
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    lo, hi = (mid, hi) if first_took(k, mid, d) else (lo, mid)
                for n in (1, 37, 300, 4200, lo - 64, lo):
                    if n >= 1 and first_took(k, n, d):
                        c, tb, stages, smem = meanshift_kernel._plan(20, k, n, d, bf16, always)
                        assert c * tb * 64 >= n and smem <= 227 * 1024
    with pytest.raises(ValueError):
        meanshift_kernel._plan(20, 32, 10**6, 768, True, always)


def test_attention_kernel_entries_refuse_strided_views():
    """The functions that hand the attention kernels raw pointers refuse a
    strided view (q, k, v split from a fused qkv, as ``layers.Attention``
    makes them) before anything is built or launched; a contiguous copy is
    what the autograd op hands them."""
    b, h, t, d = 1, 2, 16, 64
    qkv = torch.randn(b, t, 3, h, d)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    assert not q.is_contiguous()
    lse = torch.zeros(b, h, t)
    with pytest.raises(ValueError, match="flash_forward: every tensor must be contiguous"):
        attention.flash_forward(q, k, v, None, True)
    with pytest.raises(ValueError, match="mean pass: every tensor must be contiguous"):
        attention._mean(q, k, lse, None)
    with mock.patch.object(attention, "_check_inputs", lambda *a: None):
        with pytest.raises(ValueError, match="backward_dq: every tensor must be contiguous"):
            attention.attention_backward_dq(q, k, v, lse, q.contiguous())
        with pytest.raises(ValueError, match="backward_dkv: every tensor must be contiguous"):
            attention.attention_backward_dkv(q, k, v, lse, lse, q.contiguous())


def test_kernel_wrappers_count_only_their_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    reset_launches()
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 16, 64))
    attention.attention_with_capture(q, k, v)
    attention.attention_no_capture(q, k, v)
    ccl.connected_components_batch(torch.ones((1, 4, 4), dtype=torch.bool))
    assert all(kr.launches == 0 for kr in KERNELS.values())
    q.requires_grad_(True)
    attention.attention_no_capture(q, k, v).sum().backward()
    assert all(kr.launches == 0 for kr in KERNELS.values())
    assert {kr.name for kr in KERNELS.values()} == {
        "attention_capture", "attention_plain", "attention_bwd_dq", "attention_bwd_dkv",
        "ccl_batch", "meanshift_fixpoint", "attention_v2_bf16e", "attention_v3_nomin",
        "attention_v4_mxsum", "attention_v5_batched", "attention_v6_fusedsum",
        "attention_capture_d32", "attention_plain_d32", "attention_bwd_dq_d32",
        "attention_bwd_dkv_d32"}


@pytest.mark.parametrize("err,words", [
    (999, "no TMA tensor map could be made (the driver has no entry point"),
    (998, "no TMA tensor map could be made (a tensor is not 16-byte aligned"),
    (1001, "no TMA tensor map could be made (the driver refused it with CUresult 1"),
    (700, "CUDA launch failed with cudaError_t 700"),
])
def test_launch_check_names_what_failed(err, words):
    """The wrappers' check names a tensor map that could not be made (the
    codes >= 998 of ``make_tile_map``) apart from a CUDA error."""
    from attentionshift_torch.ops._build import check

    check(0, "attn_flash_forward")
    with pytest.raises(RuntimeError) as info:
        check(err, "attn_flash_forward")
    assert str(info.value).startswith(f"attn_flash_forward: {words}")
