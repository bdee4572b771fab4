"""The port's slice modules against their JAX twins on the CPU.

Same numpy inputs, made from a seed, through ``attentionshift_tpu`` and
``attentionshift_torch``; f32 on both sides. Integer outputs must be
exact; each float tolerance says what it covers.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import REPO, TINY, ckpt3k_variables, inputs, jax_model, random_variables  # noqa: E402


def T(x):
    return torch.from_numpy(np.array(x))


def J(x):
    return jnp.asarray(np.asarray(x))


# ------------------------------------------------------------ config / device
def test_config_loader_matches_jax():
    from attentionshift_torch.config import Config as TC
    from attentionshift_tpu.config import Config as JC

    for name in ("attnshift_voc12aug.py", "attnshift_coco_vitb.py"):
        path = os.path.join(REPO, "configs", name)
        assert TC.fromfile(path).to_dict() == JC.fromfile(path).to_dict()


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    from attentionshift_torch.device import resolve_device
    from attentionshift_torch.models import AttnShiftDetector

    if torch.cuda.is_available():
        pytest.skip("the rule under test is the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        AttnShiftDetector(depth=1, cam_layer=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        AttnShiftDetector.from_config(os.path.join(REPO, "configs", "attnshift_voc12aug.py"))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert AttnShiftDetector(depth=1, cam_layer=1, device="cpu").device.type == "cpu"
    with pytest.raises(TypeError, match="unknown"):
        AttnShiftDetector(depth=1, cam_layer=1, device="cpu", not_a_field=1)


# ------------------------------------------------------------------ convert
def test_converter_random_tree_loads_and_maps_layouts():
    from attentionshift_torch.convert import flax_to_torch
    from test_torch_support import torch_model

    args = inputs(64, 96, 4, 3)
    kw = dict(TINY, max_gt=4)
    variables = random_variables(jax_model(**kw), args)
    model = torch_model(variables, **kw)  # strict load: no key missing or extra
    sd = model.state_dict()
    p = variables["params"]["backbone"]
    np.testing.assert_array_equal(sd["backbone.blocks.1.attn.qkv.weight"].numpy(),
                                  np.asarray(p["blocks_1"]["attn"]["qkv"]["kernel"]).T)
    kern = np.asarray(p["fpn1_deconv1"]["kernel"])  # (2, 2, Cin, Cout), applied flipped
    np.testing.assert_array_equal(sd["backbone.fpn1_deconv1.weight"].numpy()[:, :, 0, 1],
                                  kern[1, 0])
    np.testing.assert_array_equal(sd["backbone.fpn1_bn.running_var"].numpy(),
                                  np.asarray(variables["batch_stats"]["backbone"]["fpn1_bn"]["var"]))
    np.testing.assert_array_equal(
        sd["backbone.patch_embed.proj.weight"].numpy(),
        np.asarray(p["patch_embed"]["proj"]["kernel"]).reshape(-1, kw["embed_dim"]).T)
    bad = {"params": {**variables["params"], "mystery": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="mystery"):
        flax_to_torch(bad)
    missing = {"params": {"backbone": p}, "batch_stats": variables["batch_stats"]}
    with pytest.raises(RuntimeError, match="mil_head"):
        model.load_state_dict(flax_to_torch(missing), strict=True)


def test_converter_loads_ckpt3k_with_train_subtrees_skipped():
    """The whole trained fixture (train-time neck/RPN/box/mask heads
    included) converts; those subtrees are skipped by name."""
    from attentionshift_torch.convert import SKIPPED_SUBTREES, load_flax
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_tpu.train.checkpoint import restore_params
    from test_torch_support import CKPT3K, VITS

    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), restore_params(CKPT3K))
    assert {"neck", "rpn_head", "bbox_head", "mask_head"} <= set(tree["params"])
    assert all(k.startswith(SKIPPED_SUBTREES) or k in ("backbone", "mil_head")
               for k in tree["params"])
    model = load_flax(AttnShiftDetector(device="cpu", **VITS), tree)
    w = tree["params"]["mil_head"]["fc1"]["kernel"]
    np.testing.assert_array_equal(model.mil_head.fc1.weight.detach().numpy(), w.T)
    assert ckpt3k_variables()["params"].keys() == {"backbone", "mil_head"}


# -------------------------------------------------------------- image / ops
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_matches_jax(method):
    from attentionshift_torch.ops.image import resize
    from attentionshift_tpu.ops.image import resize as jresize

    x = np.random.RandomState(0).randn(2, 3, 7, 9).astype(np.float32)
    for shape in ((14, 18), (5, 4), (7, 9)):
        np.testing.assert_allclose(resize(T(x), shape, method).numpy(),
                                   np.asarray(jresize(J(x), shape, method)), atol=1e-6)


def test_roi_align_matches_jax():
    from attentionshift_torch.ops.roi_align import roi_align
    from attentionshift_tpu.ops.roi_align import roi_align as jroi

    rs = np.random.RandomState(0)
    feats = rs.randn(1, 8, 10, 12).astype(np.float32)
    xy = rs.rand(20, 2) * [150, 120]
    wh = rs.rand(20, 2) * 80 + 1
    rois = np.concatenate([np.zeros((20, 1)), xy, xy + wh], 1).astype(np.float32)
    rois[0, 1:] = [0, 0, 1, 1]  # the candidate fallback box
    np.testing.assert_allclose(roi_align(T(feats), T(rois), 1 / 16, 7).numpy(),
                               np.asarray(jroi(J(feats), J(rois), 1 / 16, 7)), atol=1e-5)


def test_box2mask_and_corrosion_match_jax():
    from attentionshift_torch.ops.masks import box2mask, corrosion
    from attentionshift_tpu.ops import masks as jm

    boxes = np.asarray([[1.5, 2.2, 7.9, 5.0], [0, 0, 20, 20], [3, 3, 3, 3]], np.float32)
    np.testing.assert_array_equal(box2mask(T(boxes), (9, 11), 0.0).numpy(),
                                  np.asarray(jm.box2mask(J(boxes), (9, 11), 0.0)))
    m = (np.random.RandomState(0).rand(2, 3, 20, 30) > 0.3).astype(np.float32)
    for k in (1, 5, 11):
        np.testing.assert_array_equal(corrosion(T(m), k).numpy(),
                                      np.asarray(jm.corrosion(J(m), k)))


# ------------------------------------------------------------ assignment
@pytest.mark.parametrize("seed", range(4))
def test_lsa_matches_scipy_and_jax(seed):
    from scipy.optimize import linear_sum_assignment as sp_lsa

    from attentionshift_torch.core.lsa import linear_sum_assignment
    from attentionshift_tpu.core.lsa import linear_sum_assignment as jlsa

    rs = np.random.RandomState(seed)
    cost = rs.rand(8, 30).astype(np.float32)
    got = linear_sum_assignment(T(cost)).numpy()
    rows, cols = sp_lsa(cost)
    np.testing.assert_array_equal(got[rows], cols)
    np.testing.assert_array_equal(got, np.asarray(jlsa(J(cost))))
    valid = rs.rand(8) > 0.3
    got_v = linear_sum_assignment(T(cost), T(valid)).numpy()
    np.testing.assert_array_equal(got_v, np.asarray(jlsa(J(cost), J(valid))))
    rows, cols = sp_lsa(cost[valid])
    np.testing.assert_array_equal(got_v[valid][rows], cols)
    assert (got_v[~valid] == -1).all()


def test_hungarian_point_assign_matches_jax():
    from attentionshift_torch.core.assign import hungarian_point_assign
    from attentionshift_tpu.core.assign import hungarian_point_assign as jh

    rs = np.random.RandomState(0)
    cls = rs.randn(100, 20).astype(np.float32)
    reg = rs.rand(100, 2).astype(np.float32)
    pts = (rs.rand(20, 2) * [300, 200]).astype(np.float32)
    lbl = rs.randint(0, 20, 20).astype(np.int32)
    val = np.arange(20) < 8
    wh = np.asarray([300.0, 200.0], np.float32)
    for times in (1, 2):
        np.testing.assert_array_equal(
            hungarian_point_assign(*map(T, (cls, reg, pts, lbl, val, wh)), times=times).numpy(),
            np.asarray(jh(*map(J, (cls, reg, pts, lbl, val, wh)), times=times)))


# ----------------------------------------------------------------- pseudo
def test_rollout_matches_jax():
    from attentionshift_torch.pseudo.rollout import attention_rollout_point_rows
    from attentionshift_tpu.pseudo.rollout import attention_rollout_point_rows as jroll

    a = np.random.RandomState(0).rand(3, 2, 40, 40).astype(np.float32)
    a /= a.sum(-1, keepdims=True)
    for norm in (True, False):
        np.testing.assert_allclose(attention_rollout_point_rows(T(a), 7, norm).numpy(),
                                   np.asarray(jroll(J(a), 7, norm)), atol=1e-6)


def test_point_samplers_match_jax():
    from attentionshift_torch.pseudo.points import sample_in_mask, strided_in_mask, topk_in_mask
    from attentionshift_tpu.pseudo import points as jp

    rs = np.random.RandomState(0)
    masks = rs.rand(4, 9, 13) > 0.7
    masks[1] = False
    masks[2] = False
    masks[2, 3, 4] = True  # one eligible pixel
    coords, n = strided_in_mask(T(masks), 20)
    for i in range(4):
        jc, jn = jp.strided_in_mask(J(masks[i]), 20)
        np.testing.assert_array_equal(coords[i].numpy(), np.asarray(jc))
        assert int(n[i]) == int(jn)
        key = jax.random.PRNGKey(i)
        g = np.asarray(jax.random.gumbel(key, (9 * 13,)))
        tc, tv, tn = topk_in_mask(T(masks[i:i + 1]), 10, gumbel=T(g[None]))
        jc, jv, jn = jp.topk_in_mask(key, J(masks[i]), 10)
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    # uniform draws with replacement land on eligible pixels only
    gen = torch.Generator().manual_seed(0)
    c, n = sample_in_mask(T(masks), 50, gen)
    for i in (0, 3):
        assert masks[i][c[i, :, 0].numpy(), c[i, :, 1].numpy()].all()


def test_cam_boxes_match_jax():
    from attentionshift_torch.ops.ccl import connected_components
    from attentionshift_torch.pseudo.cam import bbox_from_labels_batch, normalize_cam
    from attentionshift_tpu.pseudo.cam import bbox_from_labels_batch as jbox
    from attentionshift_tpu.pseudo.cam import normalize_cam as jnorm

    rs = np.random.RandomState(0)
    cams = rs.rand(6, 12, 16).astype(np.float32)
    np.testing.assert_allclose(normalize_cam(T(cams)).numpy(),
                               np.asarray(jax.vmap(jnorm)(J(cams))), atol=1e-6)
    masks = normalize_cam(T(cams)) >= 0.6
    masks[5] = False  # no component: the [0, 0, 1, 1] fallback
    labels = connected_components(masks, 64)
    pts = (rs.rand(6, 2) * [16, 12]).astype(np.float32)
    np.testing.assert_array_equal(bbox_from_labels_batch(labels, T(pts), 0.5).numpy(),
                                  np.asarray(jbox(J(labels.numpy()), J(pts), 0.5)))


def _stage_b_inputs(seed=0, g=3, hp=6, wp=8, d=16):
    rs = np.random.RandomState(seed)
    feat = rs.randn(d, hp, wp).astype(np.float32)
    cams = rs.rand(g, hp * 4, wp * 4).astype(np.float32)
    boxes = np.asarray([[0, 0, 128, 96], [16, 8, 80, 70], [40, 30, 120, 90]], np.float32)[:g]
    pts = (rs.rand(g, 2) * [wp * 16, hp * 16]).astype(np.float32)
    valid = np.asarray([True, True, False])[:g]
    return feat, cams, boxes, pts, valid


def test_refined_maps_and_mask_points_match_jax():
    """Stage B at map stride 4 with the JAX seed points and gumbel noise
    handed to the port."""
    from attentionshift_torch.pseudo.refine import cosine_similarity_refined_map, sample_mask_points
    from attentionshift_tpu.pseudo import refine as jr
    from attentionshift_tpu.pseudo.cam import norm_attns

    feat, cams, boxes, pts, valid = _stage_b_inputs()
    key = jax.random.PRNGKey(1)
    pfg, pbg = jr.sample_fgbg_points(key, norm_attns(J(cams)), J(pts), stride=4)
    want = jr.cosine_similarity_refined_map(key, J(cams), J(feat), J(boxes), J(pts), J(valid),
                                            obj_tau=0.9, stride=4, points_override=(pfg, pbg))
    got = cosine_similarity_refined_map(T(cams), T(feat), T(boxes), T(pts), T(valid), obj_tau=0.9,
                                        stride=4, points_override=(T(np.asarray(pfg)),
                                                                   T(np.asarray(pbg))))
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-5, err_msg=name)
    keys = jax.random.split(key, 3)
    gum = np.stack([np.asarray(jax.random.gumbel(k, (24 * 32,))) for k in keys])
    jxy, jl = jr.sample_mask_points(key, want.map_fg, want.map_bg, J(boxes), pos_thr=0.35,
                                    neg_thr=0.8, stride=4)
    txy, tl = sample_mask_points(got.map_fg, got.map_bg, T(boxes), pos_thr=0.35, neg_thr=0.8,
                                 stride=4, gumbel=T(gum))
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_semantic_centers_match_jax():
    from attentionshift_torch.pseudo.meanshift import semantic_centers
    from attentionshift_tpu.pseudo.meanshift import semantic_centers as jsc

    feat, _, boxes, _, valid = _stage_b_inputs(seed=2)
    rs = np.random.RandomState(3)
    fg = rs.rand(3, 24, 32).astype(np.float32)
    fg[:, 4:20, 6:26] += 0.8
    fg /= fg.max(axis=(1, 2), keepdims=True)
    lbl = np.asarray([1, 2, 3], np.int32)
    want = jsc(J(fg), J(fg), J(boxes), J(feat), J(lbl), J(valid), n_shift=4,
               num_semantic_points=5, stride=4)
    got = semantic_centers(T(fg), T(fg), T(boxes), T(feat), T(lbl), T(valid), n_shift=4,
                           num_semantic_points=5, stride=4)
    np.testing.assert_array_equal(got.part_valid.numpy(), np.asarray(want.part_valid))
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(want.coords), atol=1e-4)
    np.testing.assert_allclose(got.feats.numpy(), np.asarray(want.feats), atol=1e-6)


def test_candidate_boxes_match_jax():
    from attentionshift_torch.pseudo.engine import candidate_boxes
    from attentionshift_tpu.pseudo.engine import candidate_boxes as jcand

    rs = np.random.RandomState(0)
    hp, wp, p = 6, 8, 5
    rows = rs.rand(3, p, 1 + hp * wp + p).astype(np.float32)
    tok = np.asarray([4, 0, 2], np.int32)
    pts = (rs.rand(3, 2) * [wp * 16, hp * 16]).astype(np.float32)
    valid = np.asarray([True, True, False])
    for stride in (16, 4):
        jb, jc = jcand(J(rows), J(tok), J(pts), (hp, wp), (hp * 16, wp * 16), cam_stride=stride,
                       valid=J(valid))
        tb, tc = candidate_boxes(T(rows), T(tok), T(pts), (hp, wp), (hp * 16, wp * 16),
                                 cam_stride=stride, valid=T(valid))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
