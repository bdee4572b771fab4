"""The attention ops at every head dim the Pallas kernels take, and the
decoder heads' kernel option, against JAX on the CPU.

The JAX package runs its Pallas attention kernels on any head dim
divisible by 8, with no upper limit, and its plain path on the others
(``attentionshift_tpu/ops/attention.py``). The port's kernels have
instances for 32, 64 and 128 and a wide route for multiples of 128 above
it; ``ops/attention.py::kernel_head_dim`` sends a head dim divisible by 8
onto the smallest instance at least as wide, or above 128 onto the wide
route at 128 * ceil(d / 128), with q, k, v zero-padded on the head axis
and the softmax scale of the true d (``forward_on_instance`` /
``backward_on_instance``), and any other head dim to the plain version. On
a CPU tensor the ops are the plain versions; here they are held to the
Pallas kernels in interpret mode, forward and backward, at (1, 2, 160, d)
with a token gap, f32 (above 128: d = 136, 256 and 384, one JAX run of
each op's forward and one vjp per width, shared by the port's two ops).
The padding itself is applied to the plain versions, where
padded-then-sliced must equal unpadded to f32 rounding, with the padded
width's scale as the control.

Tolerances: 2e-5 of each output's largest magnitude against JAX (f32 on
both sides; the TPU kernel exponentiates in base 2 with a constant shift
where the plain version takes ``softmax``, and sums in other orders, as
in ``test_torch_attention_shapes.py``); 1e-6 of the largest magnitude for
padded against unpadded (the same products with zero terms added: only
the summation order of the longer rows moves the last bit).
"""

from __future__ import annotations

import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from test_torch_support import close  # noqa: E402

REL = 2e-5
PAD_REL = 1e-6
T, GAP = 160, (120, 131)
DIMS = (8, 12, 16, 24, 40, 48, 80, 96, 128)
WIDE_DIMS = (136, 256, 384)  # the wide route: padded to 256, as they are at 256 and 384


def _inputs(d, seed=0, h=2):
    rs = np.random.RandomState(seed + d)
    q, k, v, g = (rs.randn(1, h, T, d).astype(np.float32) for _ in range(4))
    g[:, :, GAP[0]:GAP[1]] = 0.0  # the gap's rows have no consumer in the model
    return q, k, v, g


def _rel(got, want, what, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, what
    close(np.asarray(got, np.float64), np.asarray(want, np.float64),
          rel * max(np.abs(want).max(), 1e-30), what=what)


def _interpret():
    """Every ``pallas_call`` in interpret mode (the JAX modules call the
    kernels with ``interpret=False``, which the CPU cannot run)."""
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    return mock.patch.object(pl, "pallas_call", interp)


@pytest.mark.parametrize("d", DIMS)
def test_forward_matches_the_pallas_kernels(d):
    from attentionshift_torch.ops import attention
    from attentionshift_tpu.ops import attention as jatt

    q, k, v, _ = _inputs(d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, jmean = jatt.attention_with_capture(jq, jk, jv, True, True, GAP)
    jplain = jatt.attention_no_capture(jq, jk, jv, True, True, GAP)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, mean = attention.attention_with_capture(tq, tk, tv, GAP)
    _rel(out, jout, f"d={d} out (capture)")
    _rel(attention.attention_no_capture(tq, tk, tv, GAP), jplain, f"d={d} out (plain)")
    _rel(mean, jmean, f"d={d} head mean")
    assert float(mean[:, :, GAP[0]:GAP[1]].abs().max()) == 0.0


@pytest.mark.parametrize("capture", [False, True], ids=["plain", "capture"])
@pytest.mark.parametrize("d", DIMS)
def test_backward_matches_the_pallas_kernels(d, capture):
    from attentionshift_torch.ops import attention
    from attentionshift_tpu.ops import attention as jatt

    q, k, v, g = _inputs(d, seed=1)
    if capture:
        def op(q, k, v):
            return jatt.attention_with_capture(q, k, v, True, True, GAP)[0]
    else:
        def op(q, k, v):
            return jatt.attention_no_capture(q, k, v, True, True, GAP)
    _, vjp = jax.vjp(op, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    op_t = attention.attention_with_capture if capture else attention.attention_no_capture
    out = op_t(*leaves, GAP)
    got = torch.autograd.grad(out[0] if capture else out, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _rel(a, w, f"d={d} {name}")
    for a in got[1:]:
        assert float(a[:, :, GAP[0]:GAP[1]].abs().max()) == 0.0


@functools.lru_cache(maxsize=None)
def _jax_wide(d):
    """The Pallas kernels in interpret mode at a wide head dim: the capture
    op's (out, mean) and the vjp of the ops on the seeded upstream gradient
    (the JAX package's two ops share one backward, ``_bwd``), as numpy."""
    from attentionshift_tpu.ops import attention as jatt

    q, k, v, g = _inputs(d, seed=5)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, mean = jatt.attention_with_capture(jq, jk, jv, True, True, GAP)
    _, vjp = jax.vjp(lambda a, b, c: jatt.attention_no_capture(a, b, c, True, True, GAP),
                     jq, jk, jv)
    grads = vjp(jnp.asarray(g))
    return (q, k, v, g), (np.asarray(out), np.asarray(mean)), tuple(map(np.asarray, grads))


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_forward_matches_the_pallas_kernels(d):
    """Above 128 (the JAX package's Pallas kernels take any d divisible by
    8; the port's wide route): both ops' ``out`` and the capture op's head
    mean against the JAX capture op in interpret mode, at ``REL``; the gap's
    mean columns exactly 0."""
    from attentionshift_torch.ops import attention

    (q, k, v, _), (jout, jmean), _ = _jax_wide(d)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, mean = attention.attention_with_capture(tq, tk, tv, GAP)
    _rel(out, jout, f"d={d} out (capture)")
    _rel(attention.attention_no_capture(tq, tk, tv, GAP), jout, f"d={d} out (plain)")
    _rel(mean, jmean, f"d={d} head mean")
    assert float(mean[:, :, GAP[0]:GAP[1]].abs().max()) == 0.0


@pytest.mark.parametrize("capture", [False, True], ids=["plain", "capture"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_backward_matches_the_pallas_kernels(d, capture):
    """Above 128: the gradients of either op against the Pallas backward
    kernels in interpret mode, at ``REL``; the gap's dk and dv rows exactly
    0."""
    from attentionshift_torch.ops import attention

    (q, k, v, g), _, want = _jax_wide(d)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    op = attention.attention_with_capture if capture else attention.attention_no_capture
    out = op(*leaves, GAP)
    got = torch.autograd.grad(out[0] if capture else out, leaves, torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _rel(a, w, f"d={d} {name}")
    for a in got[1:]:
        assert float(a[:, :, GAP[0]:GAP[1]].abs().max()) == 0.0


def test_kernel_head_dim_routes_every_width():
    """1..1024: a multiple of 8 up to 128 onto the smallest instance at
    least as wide, a multiple of 8 above 128 onto the wide route at 128 *
    ceil(d / 128), whose launches are counted under ``<kernel>_dwide``; any
    other width to the plain version (None), as the JAX package's
    ``q.shape[-1] % 8`` dispatch, which has no upper limit either."""
    from attentionshift_torch.ops._build import KERNELS
    from attentionshift_torch.ops.attention import HEAD_DIMS, kernel_head_dim, kernel_name

    assert sorted(HEAD_DIMS) == [32, 64, 128]
    for d in range(1, 1025):
        kd = kernel_head_dim(d)
        if d % 8:
            assert kd is None, d
        elif d > 128:
            assert kd == -(-d // 128) * 128 and kd - d < 128, d
            assert kernel_name("attention_capture", kd) == "attention_capture_dwide"
        else:
            assert kd == min(x for x in HEAD_DIMS if x >= d), d
        if kd is not None:
            for name in ("attention_capture", "attention_plain", "attention_bwd_dq",
                         "attention_bwd_dkv"):
                assert kernel_name(name, kd) in KERNELS, (name, d)


@pytest.mark.parametrize("d", (8, 24, 40, 48, 80, 96, 136, 264))
def test_padding_onto_the_instance_is_exact_on_the_plain_versions(d):
    """``forward_on_instance`` / ``backward_on_instance`` around the plain
    versions: padded-then-sliced equals unpadded (out, mean, row statistic,
    dq, dk, dv); with the padded width's scale (the control) the out check
    fails."""
    from attentionshift_torch.ops import attention

    q, k, v, g = map(torch.from_numpy, _inputs(d, seed=2))
    want_out, want_mean = attention.attention_reference(q, k, v, GAP)
    want_lse = attention._row_lse(q, k, GAP)

    def fwd(qp, kp, vp, pi, head_dim):
        out, mean = attention.attention_reference(qp, kp, vp, pi, head_dim=head_dim)
        return out, mean, attention._row_lse(qp, kp, pi, head_dim)

    out, mean, lse = attention.forward_on_instance(fwd, q, k, v, GAP)
    assert out.shape == q.shape
    _rel(out, want_out, f"d={d} padded out", PAD_REL)
    _rel(mean, want_mean, f"d={d} padded mean", PAD_REL)
    _rel(lse, want_lse, f"d={d} padded row statistic", PAD_REL)
    grads = attention.backward_on_instance(
        lambda qp, kp, vp, gp, pi, hd: attention.attention_backward_reference(qp, kp, vp, gp, pi,
                                                                             head_dim=hd),
        q, k, v, g, GAP)
    want = attention.attention_backward_reference(q, k, v, g, GAP)
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        assert a.shape == w.shape
        _rel(a, w, f"d={d} padded {name}", PAD_REL)
    ctl = attention.forward_on_instance(
        lambda qp, kp, vp, pi, hd: attention.attention_reference(qp, kp, vp, pi), q, k, v, GAP)[0]
    err = float((ctl - want_out).abs().max())
    assert err > 100 * PAD_REL * float(want_out.abs().max()), (d, err)


def _block_state(params) -> dict:
    """A flax ``Block``'s parameters under the port's ``Block`` names."""
    from attentionshift_torch.convert import flax_to_torch

    sd = flax_to_torch({"params": {"backbone": {"blocks_0": jax.tree.map(np.asarray, params)}}})
    return {k.split(".", 3)[3]: v for k, v in sd.items()}


def _random_params(module, *args, seed: int = 0, scale: float = 0.05):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: ((1.0 + 0.1 * rs.randn(*s.shape)) if "scale" in jax.tree_util.keystr(p)
                      else scale * rs.randn(*s.shape)).astype(np.float32), shapes)


def test_block_with_80_wide_heads_matches_jax():
    """A ``Block`` of 320 wide, 4 heads of 80 (a ViT-H/14 head width), with
    the capture, against the JAX ``Block`` with ``use_pallas=True``:
    output, head mean and every gradient."""
    from attentionshift_torch.models.layers import Block
    from attentionshift_tpu.models.layers import Block as JBlock

    rs = np.random.RandomState(3)
    x = rs.randn(1, T, 320).astype(np.float32)
    wts = rs.randn(1, T, 320).astype(np.float32)
    jblock = JBlock(num_heads=4, capture=True, use_pallas=True, pad_interval=GAP)
    params = _random_params(jblock, jnp.asarray(x), scale=0.1)

    def jfn(p, x):
        y, attn = jblock.apply(p, x)
        return jnp.sum(y * wts), (y, attn)

    with _interpret():
        (_, (jy, jattn)), (jgp, jgx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
    port = Block(320, 4, use_kernel=True)
    port.load_state_dict(_block_state(params["params"]), strict=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, attn = port(tx, capture=True, pad_interval=GAP)
    _rel(y, jy, "block out")
    _rel(attn, jattn, "block head mean")
    (y * torch.from_numpy(wts)).sum().backward()
    _rel(tx.grad, jgx, "block input gradient")
    want = _block_state(jgp["params"])
    for name, p in port.named_parameters():
        _rel(p.grad, want[name], f"block grad {name}", 5e-5)


def _head_state(name: str, params) -> dict:
    from attentionshift_torch.convert import flax_to_torch

    sd = flax_to_torch({"params": {name: jax.tree.map(np.asarray, params["params"])}})
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


@pytest.mark.parametrize("head,rois,s", [("BoxHeadRec", 6, 7), ("MaskHeadPointSup", 3, 14)])
def test_decoder_heads_kernel_option_matches_jax(head, rois, s):
    """``BoxHeadRec`` / ``MaskHeadPointSup`` with ``use_kernel=True`` (the
    attention ops: the head-dim-32 kernels on the card) against the JAX
    heads with ``use_pallas=True`` at reduced RoI counts (8 heads of 32,
    50 and 196 tokens): outputs and every parameter gradient of a seeded
    weighted sum."""
    import attentionshift_torch.models.heads as heads
    import attentionshift_tpu.models.heads as jheads

    rs = np.random.RandomState(4)
    feats = rs.randn(rois, s, s, 384).astype(np.float32)
    jhead = getattr(jheads, head)(num_classes=5, use_pallas=True)
    params = _random_params(jhead, jnp.asarray(feats))

    def outs_of(o):
        return [x for x in o if x is not None] if isinstance(o, tuple) else [o]

    shapes = [x.shape for x in outs_of(jax.eval_shape(jhead.apply, params, jnp.asarray(feats)))]
    wts = [rs.randn(*sh).astype(np.float32) for sh in shapes]

    def jfn(p):
        outs = outs_of(jhead.apply(p, jnp.asarray(feats)))
        return sum(jnp.sum(o * w) for o, w in zip(outs, wts)), outs

    with _interpret():
        (_, jouts), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    port = getattr(heads, head)(num_classes=5, use_kernel=True)
    assert all(b.attn.use_kernel for b in port.decoder_blocks)
    port.load_state_dict(_head_state("bbox_head" if head == "BoxHeadRec" else "mask_head",
                                     params), strict=True)
    outs = outs_of(port(torch.from_numpy(feats)))
    for i, (a, w) in enumerate(zip(outs, jouts)):
        _rel(a, w, f"{head} output {i}", 5e-5)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, wts)).backward()
    want = _head_state("bbox_head" if head == "BoxHeadRec" else "mask_head", jgrads)
    for name, p in port.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _rel(g, want[name], f"{head} grad {name}", 1e-4)
