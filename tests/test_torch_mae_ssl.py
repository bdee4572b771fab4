"""The port's MAE encoder, self-supervised heads and MIM ViT against the JAX
package's, on the CPU.

``models/mae_encoder.py``: the sinusoid table (exactly), the backbone
with global attention and its pyramid (``fpn1``'s transposed convs
flipped by the converter, ``fpn1_bn``'s running statistics carried
across), split window/global attention with LayerScale, the input
gradient of both, and the grid check. ``models/ssl.py``: ``DINOHead``
(3 and 1 layers, frozen and learnable gain) and its invariance to the
prototype rows' scale, ``IBOTHead``'s cls and patch paths (separate and
shared), ``MIMViT`` with and without a mask. Every module runs on weights
converted from random flax variables (``convert.flax_to_torch``); inputs
are made from numpy seeds.

Tolerances: module outputs and input gradients to 1e-4 of the largest
entry (f32 on both sides; sums, LayerNorms and softmaxes in another
order, through up to 4 blocks).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import close, random_variables  # noqa: E402

REL = 1e-4


def _rel(got, want, what=""):
    got = [got] if torch.is_tensor(got) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w, np.float64)
        g = g.detach().numpy()
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        close(g, w, REL * max(np.abs(w).max(), 1e-30), what=f"{what}[{i}]")


def _convert(variables, model_type, module):
    from attentionshift_torch.convert import load_flax

    return load_flax(module, jax.tree.map(np.asarray, variables), model_type)


def test_sinusoid_table_matches_jax():
    from attentionshift_torch.models.mae_encoder import get_sinusoid_encoding_table
    from attentionshift_tpu.models.mae_encoder import get_sinusoid_encoding_table as jtab

    for n, d in ((7, 10), (24, 32), (4704, 768)):
        np.testing.assert_array_equal(get_sinusoid_encoding_table(n, d), jtab(n, d))


MAE_CASES = {
    "global_fpn": (dict(embed_dim=32, depth=4, num_heads=2, out_indices=(0, 1, 2, 3)), (1, 64, 96)),
    "split_layerscale": (dict(embed_dim=32, depth=4, num_heads=2, out_indices=(1, 3),
                              with_fpn=False, split_attn_freq=2, window=2, init_values=0.1),
                         (2, 64, 64)),
    "split_fpn": (dict(embed_dim=32, depth=4, num_heads=2, out_indices=(0, 1, 2, 3),
                       split_attn_freq=4, window=2, init_values=0.1), (1, 64, 96)),
}


@pytest.mark.parametrize("case", sorted(MAE_CASES))
def test_mae_encoder_matches_jax(case):
    """Outputs and the input gradient of a weighted sum of them."""
    from attentionshift_torch.models.mae_encoder import MAEVisionTransformer
    from attentionshift_tpu.models.mae_encoder import MAEVisionTransformer as JMAE

    kw, (b, h, w) = MAE_CASES[case]
    img = np.random.RandomState(0).randn(b, h, w, 3).astype(np.float32)
    jm = JMAE(**kw)
    variables = random_variables(jm, (img,), seed=1, scale=0.1)
    if "init_values" in kw:
        assert "gamma_1" in variables["params"]["blocks_0"]
    tm = _convert(variables, "mae_encoder", MAEVisionTransformer(**kw, device="cpu"))
    want = jax.jit(jm.apply)(variables, jnp.asarray(img))
    rs = np.random.RandomState(2)
    wts = [rs.randn(*np.shape(f)).astype(np.float32) for f in want]

    def jloss(x):
        return sum((f * wt).sum() for f, wt in zip(jm.apply(variables, x), wts))

    jgrad = jax.jit(jax.grad(jloss))(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    got = tm(x)
    _rel(got, want, case)
    sum((f * torch.from_numpy(wt)).sum() for f, wt in zip(got, wts)).backward()
    _rel(x.grad, jgrad, f"{case} d img")
    if kw.get("split_attn_freq"):
        assert 0 in tm.block_windows(h // 16, w // 16)
        assert kw["window"] in tm.block_windows(h // 16, w // 16)


def test_mae_encoder_split_needs_divisible_grid():
    from attentionshift_torch.models.mae_encoder import MAEVisionTransformer

    m = MAEVisionTransformer(embed_dim=16, depth=2, num_heads=2, out_indices=(0, 1),
                             with_fpn=False, split_attn_freq=2, window=3, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        m(torch.zeros(1, 64, 64, 3))
    # a grid no larger than the window attends globally in every block
    assert MAEVisionTransformer(embed_dim=16, depth=2, num_heads=2, split_attn_freq=2,
                                window=4, device="cpu").block_windows(4, 4) == [0, 0]


@pytest.mark.parametrize("nlayers,norm_last_layer", [(3, True), (1, True), (2, False)])
def test_dino_head_matches_jax(nlayers, norm_last_layer):
    from attentionshift_torch.models.ssl import DINOHead
    from attentionshift_tpu.models.ssl import DINOHead as JDINO

    x = np.random.RandomState(0).randn(4, 12).astype(np.float32)
    kw = dict(out_dim=32, nlayers=nlayers, hidden_dim=16, bottleneck_dim=8,
              norm_last_layer=norm_last_layer)
    jm = JDINO(**kw)
    variables = random_variables(jm, (x,), seed=nlayers, scale=0.3)
    tm = _convert(variables, "dino_head", DINOHead(12, **kw, device="cpu"))
    _rel(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)), "dino")


def test_dino_head_weight_norm_invariance():
    """Scaling the prototype rows leaves the output as it was (a frozen
    unit gain), as the JAX package's test asks of its head."""
    from attentionshift_torch.models.ssl import DINOHead

    head = DINOHead(12, out_dim=32, hidden_dim=16, bottleneck_dim=8, device="cpu").init_weights(3)
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 12).astype(np.float32))
    y0 = head(x)
    with torch.no_grad():
        head.last_layer.weight_v.mul_(7.5)
    close(head(x).detach().numpy(), y0.detach().numpy(), 1e-5 * float(y0.detach().abs().max()))


@pytest.mark.parametrize("shared_head", [False, True])
def test_ibot_head_matches_jax(shared_head):
    """cls and patch logits of (B, 1 + N, D) tokens, and the cls path of
    (B, D) tokens."""
    from attentionshift_torch.models.ssl import IBOTHead
    from attentionshift_tpu.models.ssl import IBOTHead as JIBOT

    x = np.random.RandomState(1).randn(2, 5, 12).astype(np.float32)
    kw = dict(out_dim=16, patch_out_dim=24, hidden_dim=16, bottleneck_dim=8,
              shared_head=shared_head)
    jm = JIBOT(**kw)
    variables = random_variables(jm, (x,), seed=4, scale=0.3)
    tm = _convert(variables, "ibot_head", IBOTHead(12, **kw, device="cpu"))
    cls_logits, patch_logits = tm(torch.from_numpy(x))
    want = jm.apply(variables, jnp.asarray(x))
    _rel((cls_logits, patch_logits), want, "ibot")
    assert tuple(patch_logits.shape) == (2, 4, 16 if shared_head else 24)
    _rel(tm(torch.from_numpy(x[:, 0])), jm.apply(variables, jnp.asarray(x[:, 0])), "ibot cls")


def test_mim_vit_matches_jax():
    """Without a mask, with a mask (the masked patches differ from the
    unmasked forward), at the pretraining grid and at a resized one (the
    bicubic position-table resize), and the input gradient."""
    from attentionshift_torch.models.ssl import MIMViT
    from attentionshift_tpu.models.ssl import MIMViT as JMIM

    kw = dict(embed_dim=32, depth=2, num_heads=2, img_size=32)
    jm = JMIM(**kw)
    rs = np.random.RandomState(0)
    img = rs.randn(2, 32, 32, 3).astype(np.float32)
    mask = rs.rand(2, 4) < 0.4
    mask[0, 1] = True
    variables = random_variables(jm, (img, mask), seed=5, scale=0.2)
    tm = _convert(variables, "mim_vit", MIMViT(**kw, device="cpu"))
    full = tm(torch.from_numpy(img))
    masked = tm(torch.from_numpy(img), torch.from_numpy(mask))
    _rel(full, jm.apply(variables, jnp.asarray(img)), "full")
    _rel(masked, jm.apply(variables, jnp.asarray(img), jnp.asarray(mask)), "masked")
    assert not np.allclose(full[0, 2].detach().numpy(), masked[0, 2].detach().numpy())
    big = rs.randn(1, 48, 64, 3).astype(np.float32)
    wt = rs.randn(1, 13, 32).astype(np.float32)
    jgrad = jax.jit(jax.grad(lambda x: (jm.apply(variables, x) * wt).sum()))(jnp.asarray(big))
    x = torch.from_numpy(big).requires_grad_(True)
    out = tm(x)
    _rel(out, jm.apply(variables, jnp.asarray(big)), "resized grid")
    (out * torch.from_numpy(wt)).sum().backward()
    _rel(x.grad, jgrad, "d img")
