"""Shared helpers of the PyTorch-port parity tests (no tests here).

The parity tests feed the same numpy inputs, made from a seed, through a
JAX function and its ``attentionshift_torch`` counterpart on the CPU.
Models are compared on the same weights: random flax variables built
from the model's own parameter shapes, or the committed trained fixture
``tools/fixtures/ckpt3k``, converted with ``attentionshift_torch.convert``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT3K = os.path.join(REPO, "tools", "fixtures", "ckpt3k")

# ViT-S width of configs/attnshift_voc12aug.py (the ckpt3k geometry)
VITS = dict(num_classes=20, embed_dim=384, depth=12, num_heads=6, point_tokens=100, cam_layer=7)
# narrow random-weight model: head dim 64 like ViT-S, 4 blocks, 3 captured
TINY = dict(num_classes=20, embed_dim=128, depth=4, num_heads=2, point_tokens=16, cam_layer=3,
            out_indices=(0, 1, 2, 3))


def inputs(h: int, w: int, g: int, n_valid: int, seed: int = 0):
    """numpy (img, gt_points, gt_labels, gt_valid, img_wh) for batch 1."""
    rs = np.random.RandomState(seed)
    img = rs.randn(1, h, w, 3).astype(np.float32)
    pts = (rs.rand(1, g, 2) * [w * 0.8, h * 0.8] + [w * 0.1, h * 0.1]).astype(np.float32)
    lbl = rs.randint(0, 20, (1, g)).astype(np.int32)
    valid = np.asarray([[True] * n_valid + [False] * (g - n_valid)])
    wh = np.asarray([[float(w), float(h)]], np.float32)
    return img, pts, lbl, valid, wh


def blob_inputs(h: int, w: int, g: int, n_valid: int, seed: int = 0):
    """Like ``inputs``, on an image of ``n_valid`` bright discs (the
    ckpt3k training corpus's kind of scene), one annotated point per
    disc, so the instances' maps differ: instances whose refined maps
    agree to float rounding would make the winner-take-all selection of
    Stage B a coin toss between the two packages."""
    rs = np.random.RandomState(seed)
    img = (rs.randn(1, h, w, 3) * 0.1).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    pts = (rs.rand(1, g, 2) * [w * 0.8, h * 0.8] + [w * 0.1, h * 0.1]).astype(np.float32)
    cols = np.linspace(0.1, 0.9, n_valid)
    for j in range(n_valid):
        cx, cy = w * cols[j], h * (0.3 + 0.4 * rs.rand())
        r = min(h, w) * (0.15 + 0.1 * rs.rand())
        img[0][(xx - cx) ** 2 + (yy - cy) ** 2 < r * r, j % 3] += 2.5
        pts[0, j] = (cx, cy)
    lbl = (np.arange(g) % 3).astype(np.int32)[None]
    valid = np.asarray([[True] * n_valid + [False] * (g - n_valid)])
    wh = np.asarray([[float(w), float(h)]], np.float32)
    return img, pts, lbl, valid, wh


def jax_model(**kw):
    from attentionshift_tpu.models.detector import AttnShiftDetector

    return AttnShiftDetector(use_remat=False, **kw)


def random_variables(model, args, seed: int = 0, scale: float = 0.05):
    """Flax variables of ``model.seed_pseudo_gt`` filled from numpy:
    N(0, scale) matrices/tokens/biases, 1 + N(0, 0.1) norm scales,
    positive running variances."""
    from attentionshift_tpu.models.detector import AttnShiftDetector

    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda: model.init({"params": key, "sampling": key}, *map(jnp.asarray, args),
                           method=AttnShiftDetector.seed_pseudo_gt))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (scale * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.tree.map(lambda s: s, shapes))


def ckpt3k_variables():
    """The committed ckpt3k fixture restored as in bench.py, f32, limited
    to the pseudo-label path's subtrees (backbone + MIL head)."""
    from attentionshift_tpu.train.checkpoint import restore_params

    tree = restore_params(CKPT3K)
    f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    return {"params": {k: f32["params"][k] for k in ("backbone", "mil_head")},
            "batch_stats": f32["batch_stats"]}


def torch_model(variables, **kw):
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.models import AttnShiftDetector

    model = AttnShiftDetector(device="cpu", **kw)
    return load_flax(model, jax.tree.map(np.asarray, variables))


def to_torch(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def replay_draws(model, variables, jdebug, key, gt_points, stride: int, img_hw):
    """The JAX package's random draws of one ``seed_pseudo_gt`` call,
    replayed from its key tree for the port (batch 1):
    ``split(rng, b)`` (detector.py:478) -> ``split`` (engine.py:151) ->
    ``sample_fgbg_points`` (refine.py:228) for the Stage-B seed points,
    ``split(k_points, g)`` + ``gumbel`` (refine.py:373, points.py:95)
    for the mask-point noise."""
    from attentionshift_tpu.ops.image import resize
    from attentionshift_tpu.pseudo.cam import norm_attns
    from attentionshift_tpu.pseudo.refine import sample_fgbg_points

    rng = model.apply(variables, method=lambda m: m.make_rng("sampling"),
                      rngs={"sampling": key})
    k_img = jax.random.split(rng, 1)[0]
    k_refine, k_points = jax.random.split(k_img)
    h, w = img_hw
    cams = resize(jnp.asarray(jdebug["best_cams"][0]), (h // stride, w // stride))
    pfg, pbg = sample_fgbg_points(k_refine, norm_attns(cams), jnp.asarray(gt_points[0]),
                                  0.2, 0.1, 20, stride=stride)
    g = gt_points.shape[1]
    n = (h // stride) * (w // stride)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (n,)))
                       for k in jax.random.split(k_points, g)])
    return [dict(points_fg=torch.from_numpy(np.array(pfg)),
                 points_bg=torch.from_numpy(np.array(pbg)),
                 gumbel=torch.from_numpy(gumbel))]


def close(a, b, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol, err_msg=what)


# keys compared exactly: integers, and coordinates picked from integer grids
EXACT = {"assigned", "best_attn_idx", "token_of_gt", "mask_points_labels",
         "semantic_centers_valid", "pseudo_gt_masks", "pseudo_gt_labels", "pseudo_gt_valid",
         "candidate_boxes", "pseudo_gt_bboxes", "mask_points_coords", "semantic_centers"}
# absolute tolerances of the float keys, relative to the key's largest
# magnitude (f32 sums in another order through the backbone), except:
# map_cos_fg is max-normalised maps (1e-4), and the MIL bag loss takes
# log(1 - x) of bag sums clipped at 1 - 1e-6, which scales f32 rounding
# of saturated sums by up to 1e6 (2e-3)
REL_TOL = {"outputs_class": 1e-5, "outputs_coord": 1e-5, "rollout_rows": 1e-5, "cams": 1e-5,
           "best_cams": 1e-5, "vit_feat": 1e-5}
ABS_TOL = {"map_cos_fg": 1e-4, "loss_mil": 2e-3}


def check_slice(weights: str, cam_stride: int, map_stride: int, seed: int = 0):
    """Run ``seed_debug`` and ``seed_pseudo_gt`` of both packages on the
    same weights, inputs and (replayed) draws and compare every key."""
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

    if weights == "random":
        kw = dict(TINY)
        h, w = 64, 96
        make = inputs
    else:
        kw = dict(VITS)
        h, w = 128, 192
        make = blob_inputs
    g = 4
    kw.update(max_gt=g, cam_stride=cam_stride, seed_map_stride=map_stride, pad_tokens_to=128)
    args = make(h, w, g, 3, seed=seed)
    model = jax_model(**kw)
    variables = random_variables(model, args) if weights == "random" else ckpt3k_variables()
    key = jax.random.PRNGKey(seed + 3)
    jargs = tuple(map(jnp.asarray, args))
    want = {}
    for method in ("seed_debug", "seed_pseudo_gt"):
        fn = jax.jit(lambda v, k, m=getattr(JDet, method): model.apply(
            v, *jargs, method=m, rngs={"sampling": k}))
        want[method] = jax.tree.map(np.asarray, fn(variables, key))
    draws = replay_draws(model, variables, want["seed_debug"], key, args[1], map_stride, (h, w))
    port = torch_model(variables, **kw)
    targs = to_torch(*args)
    got = {"seed_debug": port.seed_debug(*targs, draws=draws),
           "seed_pseudo_gt": port.seed_pseudo_gt(*targs, draws=draws)}
    for method in got:
        assert set(got[method]) == set(want[method]), method
        for name, ref in want[method].items():
            out = got[method][name].numpy()
            what = f"{method}[{name}]"
            assert out.shape == ref.shape, what
            if name in EXACT:
                np.testing.assert_array_equal(out, ref, err_msg=what)
            elif name in ABS_TOL:
                close(out, ref, ABS_TOL[name], what=what)
            else:
                close(out, ref, REL_TOL[name] * max(float(np.abs(ref).max()), 1.0), what=what)
    # the padded instance carries the padding contract
    pg = got["seed_pseudo_gt"]
    assert (pg["mask_points_labels"][0, 3] == 2).all()
    assert (pg["pseudo_gt_masks"][0, 3] == 0).all()
