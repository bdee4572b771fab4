"""The port's seeded inits against the JAX modules' ``model.init``, on the CPU.

Torch cannot replay JAX's random stream, so an init is held to the JAX
module's *distribution*: leaf by leaf under ``convert.flax_to_torch``'s
names, a leaf that flax draws as zeros or ones must be exactly that in
the port, and a drawn leaf of at least ``MIN_DRAWN`` entries must have the
JAX leaf's mean, std and max |x| within ``leaf_mismatches``' tolerances.
Each check has a control: the port's former rule (N(0, 0.02) for every
matrix and token) must fail it.

The flagship's init decides whether its pseudo labels ever leave their
first state (ROADMAP section C, fault 0), so its step-0 score on the
learning check's held-out lobes images is held to the score of the JAX
init carried in with ``convert.load_flax``.

The other models' inits are held to the same check, with the same
control: each finds no divergent leaf, and the former N(0, 0.02) rule
fails it on that model's kernels.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import TINY, VITS  # noqa: E402

MIN_DRAWN = 64  # smaller drawn leaves are only checked for their kind


def leaf_mismatches(port: dict, want: dict) -> list[str]:
    """Each leaf of ``want`` (flax init, port names and layouts) whose port
    twin differs in distribution, as "name: statistic". Tolerances: std
    within 10 % for leaves of at least 1024 entries (35 % from
    ``MIN_DRAWN``: the sample std of n draws spreads by ~1/sqrt(2n), 3.1 %
    at 1024); mean within 6 standard errors sqrt(2/n) std; max |x| within
    25 % (50 % under 1024 entries: the largest of n untruncated normal
    draws moves by ~1/(2 ln n) of itself). Zeros and ones exact."""
    bad = []
    assert sorted(port) == sorted(want), set(port) ^ set(want)
    for name in sorted(want):
        w = np.asarray(want[name], np.float64)
        g = port[name].detach().double().numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if not w.any() or np.all(w == 1.0):
            if not np.array_equal(g, w):
                bad.append(f"{name}: {'zeros' if not w.any() else 'ones'}")
            continue
        if w.size < MIN_DRAWN:
            continue
        big = w.size >= 1024
        std_tol, max_tol = (0.10, 0.25) if big else (0.35, 0.50)
        ws, gs = w.std(), g.std()
        if abs(gs / ws - 1.0) > std_tol:
            bad.append(f"{name}: std {gs:.4g} vs {ws:.4g}")
        elif abs(g.mean() - w.mean()) > 6.0 * ws * (2.0 / w.size) ** 0.5:
            bad.append(f"{name}: mean {g.mean():.4g} vs {w.mean():.4g}")
        elif abs(np.abs(g).max() / np.abs(w).max() - 1.0) > max_tol:
            bad.append(f"{name}: max {np.abs(g).max():.4g} vs {np.abs(w).max():.4g}")
    return bad


def former_rule(module: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """The port's init before it followed the JAX modules: N(0, 0.02) for
    every matrix and token, zero biases, unit scales (the FPN and RPN as
    now)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if not t.is_floating_point() or leaf.startswith("gamma_"):
                continue  # index buffers and LayerScale vectors kept as built
            if leaf in ("bias", "running_mean"):
                t.zero_()
            elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
                t.fill_(1.0)
            elif name.startswith("rpn_head."):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.01)
            elif name.startswith("neck."):
                taps = 9 if t.dim() == 4 else 1
                bound = (6.0 / (taps * (t.shape[-1] + t.shape[-2]))) ** 0.5
                t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.02)
    return module


def jax_init(module, *args, key: int = 0, rngs=("params",)):
    """``module.init`` under jit with ``PRNGKey(key)`` for every stream in
    ``rngs``, as numpy."""
    k = jax.random.PRNGKey(key)
    variables = jax.jit(lambda: module.init({r: k for r in rngs}, *args))()
    return jax.tree.map(np.asarray, variables)


def detector_init(kw: dict, key: int = 0):
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

    g = kw.get("max_gt", 20)
    return jax_init(JDet(use_remat=False, **kw), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, g, 2)),
                    jnp.zeros((1, g), jnp.int32), jnp.zeros((1, g), bool),
                    jnp.asarray([[64.0, 64.0]]), key=key, rngs=("params", "sampling", "dropout"))


# the narrow case carries every train variant, so their heads are drawn too
DETECTORS = {
    "narrow_variants": dict(TINY, max_gt=4, num_proposals=48, rcnn_samples=32,
                            mask_sample_cap=16, with_reppoints_head=True, num_reppoints_head=2,
                            reppoints_num_points=5, with_keypoint_align=True, with_mae_head=True),
    "vits": dict(VITS, max_gt=8, num_proposals=64, rcnn_samples=32, mask_sample_cap=16),
}


@pytest.mark.parametrize("case", sorted(DETECTORS))
def test_detector_init_matches_flax_distributions(case):
    """``init_weights(0)`` against the JAX detector's ``model.init``
    (``PRNGKey(0)``), every leaf; the former rule fails on the q, k, v
    kernels (std 0.02 against 1/sqrt(fan_in)) and the zero ``cls_token``."""
    from attentionshift_torch.convert import flax_to_torch
    from attentionshift_torch.models import AttnShiftDetector

    kw = DETECTORS[case]
    want = flax_to_torch(detector_init(kw))
    assert leaf_mismatches(AttnShiftDetector(device="cpu", **kw).init_weights(0).state_dict(),
                           want) == []
    control = leaf_mismatches(former_rule(AttnShiftDetector(device="cpu", **kw)).state_dict(),
                              want)
    assert "backbone.cls_token: zeros" in control
    assert any(m.startswith("backbone.blocks.0.attn.qkv.weight: std") for m in control), control


def test_init_weights_is_seeded():
    """The same seed draws the same tensors; another seed others."""
    from attentionshift_torch.models import AttnShiftDetector

    a, b, c = (AttnShiftDetector(device="cpu", **TINY).init_weights(s).state_dict()
               for s in (0, 0, 1))
    qkv = "backbone.blocks.1.attn.qkv.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[qkv], c[qkv])


# the tolerances cover the spread of the step-0 scores over 3 port seeds and
# 3 JAX keys (test_step0_row_matches_the_jax_init's docstring)
STEP0_BOX_TOL = 0.03
STEP0_MASK_TOL = 0.17


@pytest.fixture(scope="module")
def step0_scores():
    """(port init, converted JAX init, former rule) step-0 scores."""
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.tools.analysis import learning_check as lc

    class Args:
        f32 = True

    held = [lc.make_sample(np.random.RandomState(100 + i), i, "lobes") for i in range(8)]
    wh = torch.tensor([[float(lc.W), float(lc.H)]])
    cpu = torch.device("cpu")
    port = lc.build_model(Args, cpu)
    kw = dict(VITS, img_size=224, max_gt=lc.G, num_proposals=512, rpn_nms_pre=1000,
              rcnn_samples=256, mask_sample_cap=64)
    jax_weights = load_flax(lc.build_model(Args, cpu), detector_init(kw))
    old = former_rule(lc.build_model(Args, cpu))
    return [lc.score(m, held, wh) for m in (port, jax_weights, old)]


def test_step0_row_matches_the_jax_init(step0_scores):
    """The port's step-0 pseudo box and mask IoU on its own init against
    the JAX init's, within the spread over seeds and keys; the former
    rule's mask IoU falls outside.

    Measured before the tolerances were set (the learning check's ViT-S,
    f32, CPU, its 8 held-out lobes images):
    JAX ``model.init``, PRNGKey 0 / 1 / 2: box 0.0984 / 0.1032 / 0.0923,
    mask 0.2529 / 0.2663 / 0.2021; the port's ``init_weights`` 0 / 1 / 2:
    box 0.0923 / 0.1145 / 0.0923, mask 0.1116 / 0.2725 / 0.1856; the
    former rule, seed 0: box 0.0923, mask 0.0268. The widest pair of a
    port seed and a JAX key is 0.0222 apart in box IoU and 0.1547 in mask
    IoU (``STEP0_BOX_TOL`` 0.03, ``STEP0_MASK_TOL`` 0.17); the former rule
    lies 0.2261 below key 0's mask IoU."""
    (pb, pm), (jb, jm), (ob, om) = step0_scores
    assert abs(pb - jb) <= STEP0_BOX_TOL, (pb, jb)
    assert abs(pm - jm) <= STEP0_MASK_TOL, (pm, jm)
    assert abs(om - jm) > STEP0_MASK_TOL, (om, jm)


def _other(case: str):
    """(JAX variables at PRNGKey(0), the port's module after
    ``init_weights(0)``, the converter's model type) of each other model."""
    from attentionshift_torch.models import mask_rcnn, ssl
    from attentionshift_torch.models.deformable_attention import DeformableConvAttention
    from attentionshift_torch.models.mae_encoder import MAEVisionTransformer
    from attentionshift_torch.models.swin import SwinTransformer
    from attentionshift_tpu.models import deformable_attention as jda
    from attentionshift_tpu.models import mae_encoder as jmae
    from attentionshift_tpu.models import mask_rcnn as jmr
    from attentionshift_tpu.models import ssl as jssl
    from attentionshift_tpu.models import swin as jswin

    img = lambda h, w: jnp.zeros((1, h, w, 3))  # noqa: E731
    if case == "swin":
        kw = dict(embed_dim=32, depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 4), window_size=4,
                  attnshift=True, point_tokens=10, num_classes=5, global_blocks=2)
        return (jax_init(jswin.SwinTransformer(**kw), img(128, 128)),
                SwinTransformer(**kw, img_size=(128, 128), device="cpu"), "swin")
    if case == "mae_encoder":
        kw = dict(embed_dim=64, depth=4, num_heads=2, out_indices=(0, 1, 2, 3), init_values=0.1)
        return (jax_init(jmae.MAEVisionTransformer(**kw), img(64, 64)),
                MAEVisionTransformer(**kw, device="cpu"), "mae_encoder")
    if case == "mim_vit":
        kw = dict(embed_dim=64, depth=2, num_heads=2, img_size=32)
        return (jax_init(jssl.MIMViT(**kw), img(32, 32), jnp.zeros((1, 4), bool)),
                ssl.MIMViT(**kw, device="cpu"), "mim_vit")
    if case == "dino_head":
        kw = dict(out_dim=256, hidden_dim=128, bottleneck_dim=64)
        return (jax_init(jssl.DINOHead(**kw), jnp.zeros((2, 64))),
                ssl.DINOHead(64, **kw, device="cpu"), "dino_head")
    if case == "ibot_head":
        kw = dict(out_dim=256, patch_out_dim=128, hidden_dim=128, bottleneck_dim=64)
        return (jax_init(jssl.IBOTHead(**kw), jnp.zeros((2, 5, 64))),
                ssl.IBOTHead(64, **kw, device="cpu"), "ibot_head")
    if case == "deformable_attention":
        return (jax_init(jda.DeformableConvAttention(n_heads=4), jnp.zeros((1, 8, 8, 64))),
                DeformableConvAttention(64, n_heads=4, device="cpu"), "deformable_attention")
    kw = dict(num_classes=5, depths=(1, 1, 1, 1), rpn_channels=64, num_proposals=50,
              rpn_nms_pre=100, rcnn_samples=32, mask_sample_cap=8)
    g = 4
    args = (img(64, 64), jnp.zeros((1, g, 4)), jnp.zeros((1, g), jnp.int32),
            jnp.zeros((1, g, 16, 16), jnp.uint8), jnp.zeros((1, g), bool),
            jnp.asarray([[64.0, 64.0]]))
    return (jax_init(jmr.MaskRCNN(**kw), *args, rngs=("params", "sampling")),
            mask_rcnn.MaskRCNN(**kw, device="cpu"), "mask_rcnn")


OTHERS = ("swin", "mae_encoder", "mim_vit", "dino_head", "ibot_head", "deformable_attention",
          "mask_rcnn")


@pytest.mark.parametrize("case", OTHERS)
def test_other_model_inits_against_flax(case):
    """The other models' ``init_weights(0)`` against their JAX modules'
    ``init``: no leaf diverges. The control, the former N(0, 0.02) rule
    for every matrix and table, diverges on kernels of the model."""
    from attentionshift_torch.convert import flax_to_torch

    variables, module, model_type = _other(case)
    want = flax_to_torch(variables, model_type)
    assert leaf_mismatches(module.init_weights(0).state_dict(), want) == []
    control = leaf_mismatches(former_rule(module).state_dict(), want)
    assert any(".weight: std" in m or "weight_v: std" in m for m in control), control
