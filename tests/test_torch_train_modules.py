"""The train step's modules of the port against their JAX twins.

Each test feeds the same numpy inputs, made from a seed, through a JAX
function and its ``attentionshift_torch`` counterpart on the CPU in f32.
Integer results and selections are compared exactly (the inputs hold
ties where the tie rule matters); floats at 1e-5 unless a test states
another tolerance. Random draws of the JAX side are replayed from its
keys and handed to the port.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import close  # noqa: E402

J = jnp.asarray


def T(x):
    return torch.from_numpy(np.asarray(x))


def boxes(rs, n, size=100.0):
    xy = rs.rand(n, 2) * size * 0.7
    wh = rs.rand(n, 2) * size * 0.3 + 1.0
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def fill(tree, rs, scale=0.1):
    """Random values for a flax parameter tree (norm scales around 1)."""
    def one(path, x):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rs.randn(*x.shape)).astype(np.float32)
        return (scale * rs.randn(*x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


def load_sub(module, name, params):
    """Load the flax subtree ``params`` (as detector subtree ``name``)
    into the port's ``module``, strictly."""
    from attentionshift_torch.convert import flax_to_torch

    sd = flax_to_torch({"params": {name: jax.tree.map(np.asarray, params)}})
    module.load_state_dict({k[len(name) + 1:]: v for k, v in sd.items()}, strict=True)
    return module


# -------------------------------------------------------------------- core
@pytest.mark.parametrize("fn", ["iou", "iof", "giou", "bbox2delta", "delta2bbox", "clip_boxes"])
def test_box_functions_match_jax(fn):
    from attentionshift_torch.core import boxes as tb
    from attentionshift_tpu.core import boxes as jb

    rs = np.random.RandomState(0)
    a, b = boxes(rs, 7), boxes(rs, 5)
    a[0] = b[0]  # an exact overlap
    a[1, 2:] = a[1, :2]  # a degenerate box
    if fn in ("iou", "iof", "giou"):
        close(tb.bbox_overlaps(T(a), T(b), fn), jb.bbox_overlaps(J(a), J(b), fn), 1e-6)
    elif fn == "bbox2delta":
        close(tb.bbox2delta(T(a[:5]), T(b), stds=(0.1, 0.1, 0.2, 0.2)),
              jb.bbox2delta(J(a[:5]), J(b), stds=(0.1, 0.1, 0.2, 0.2)), 1e-4, rtol=1e-5)
    elif fn == "delta2bbox":
        d = (rs.randn(7, 3, 4) * 2).astype(np.float32)  # some beyond the ratio clip
        close(tb.delta2bbox(T(a)[:, None], T(d), stds=(0.1, 0.1, 0.2, 0.2), max_shape=(80, 90)),
              jb.delta2bbox(J(a)[:, None], J(d), stds=(0.1, 0.1, 0.2, 0.2), max_shape=(80, 90)),
              1e-4)
    else:
        close(tb.clip_boxes(T(a) - 20, (60, 50)), jb.clip_boxes(J(a) - 20, (60, 50)), 0)


def test_anchors_match_jax():
    from attentionshift_torch.core import anchors as ta
    from attentionshift_tpu.core import anchors as ja

    sizes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    np.testing.assert_array_equal(ta.grid_anchors(sizes).numpy(), np.asarray(ja.grid_anchors(sizes)))
    for a, b in zip(ta.grid_anchors_per_level(sizes), ja.grid_anchors_per_level(sizes)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["sigmoid_focal_loss", "softmax_cross_entropy",
                                  "binary_cross_entropy", "l1_loss", "giou_loss"])
def test_losses_match_jax(name):
    from attentionshift_torch.core import losses as tl
    from attentionshift_tpu.core import losses as jl

    rs = np.random.RandomState(1)
    n, c = 12, 6
    logits = (rs.randn(n, c) * 3).astype(np.float32)
    w = (rs.rand(n) > 0.3).astype(np.float32)
    if name == "sigmoid_focal_loss":
        lab = rs.randint(0, c + 1, n).astype(np.int32)  # c = background
        args = [(logits, lab)]
    elif name == "softmax_cross_entropy":
        args = [(logits, rs.randint(0, c, n).astype(np.int32))]
    elif name == "binary_cross_entropy":
        args = [(logits[:, 0], (rs.rand(n) > 0.5).astype(np.float32))]
    elif name == "l1_loss":
        args = [(logits, rs.randn(n, c).astype(np.float32))]
        w = w[:, None]
    else:
        args = [(boxes(rs, n), boxes(rs, n))]
    for a, b in args:
        for kw in (dict(), dict(weight=w, avg_factor=5.0), dict(weight=w, avg_factor=0.0)):
            tkw = {k: (T(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
            jkw = {k: (J(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
            close(getattr(tl, name)(T(a), T(b), **tkw), getattr(jl, name)(J(a), J(b), **jkw),
                  1e-5, rtol=1e-5, what=str(kw.keys()))


@pytest.mark.parametrize("low_quality", [True, False])
def test_max_iou_assign_matches_jax(low_quality):
    """With two gts that claim the same box at the same IoU: the later gt
    wins the low-quality pass."""
    from attentionshift_torch.core.assign import max_iou_assign
    from attentionshift_tpu.core.assign import max_iou_assign as jassign

    rs = np.random.RandomState(2)
    bx = boxes(rs, 40)
    gts = boxes(rs, 5)
    gts[1] = gts[0]  # identical gts: equal IoU with every box
    bx[3] = gts[2]
    lbl = rs.randint(0, 20, 5).astype(np.int32)
    val = np.array([True, True, True, False, True])
    got = max_iou_assign(T(bx), T(gts), T(lbl), T(val), 0.5, 0.3, 0.1, low_quality)
    want = jassign(J(bx), J(gts), J(lbl), J(val), 0.5, 0.3, 0.1, low_quality)
    np.testing.assert_array_equal(got.assigned_gt.numpy(), np.asarray(want.assigned_gt))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    close(got.max_iou, want.max_iou, 1e-6)
    assert (got.assigned_gt > 0).any() and (got.assigned_gt == 0).any()


@pytest.mark.parametrize("form", ["mask", "idx"])
@pytest.mark.parametrize("n_pos", [3, 40])
def test_random_samplers_match_jax(form, n_pos):
    """Replayed uniforms, quantised to 1/8 so that many scores tie: ties go
    to the lowest index. Few positives (the negatives fill up) and more
    than the cap."""
    from attentionshift_torch.core import assign as ta
    from attentionshift_tpu.core import assign as ja

    n, num, frac = 100, 32, 0.25
    assigned = np.zeros(n, np.int32)
    assigned[np.random.RandomState(3).permutation(n)[:n_pos]] = 1
    assigned[::7] = -1
    key = jax.random.PRNGKey(5)
    k_pos, k_neg = jax.random.split(key)
    u_pos = np.floor(np.asarray(jax.random.uniform(k_pos, (n,))) * 8) / 8
    u_neg = np.floor(np.asarray(jax.random.uniform(k_neg, (n,))) * 8) / 8

    # the JAX samplers draw inside; replace their draw by the tied values
    from unittest import mock
    draws = iter([J(u_pos), J(u_neg)])
    with mock.patch.object(jax.random, "uniform", lambda *a, **k: next(draws)):
        if form == "mask":
            want = ja.random_sample(key, J(assigned), num, frac)
        else:
            want = ja.random_sample_idx(key, J(assigned), num, frac)
    fn = ta.random_sample if form == "mask" else ta.random_sample_idx
    got = fn(T(assigned), num, frac, u_pos=T(u_pos), u_neg=T(u_neg))
    for a, b in zip(got, want):
        if form == "idx" and a.dtype != torch.bool:
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if form == "idx":  # indices compared where the slot is valid
        for ia, va, ib in ((got.pos_idx, got.pos_valid, want.pos_idx),
                           (got.neg_idx, got.neg_valid, want.neg_idx)):
            np.testing.assert_array_equal(ia.numpy()[va.numpy()], np.asarray(ib)[va.numpy()])
    # a generator also works and respects the counts
    g = fn(T(assigned), num, frac, generator=torch.Generator().manual_seed(0))
    total = (int(g[0].sum()) + int(g[1].sum())) if form == "mask" else \
        int(g.pos_valid.sum()) + int(g.neg_valid.sum())
    assert total == num


# --------------------------------------------------------------------- ops
@pytest.mark.parametrize("k", [1, 5, 17, 64])
def test_top_k_set_matches_jax(k):
    """Ties at the k-th value, -0.0 below +0.0, -inf present."""
    from attentionshift_torch.ops.topk import top_k_set
    from attentionshift_tpu.ops.topk import top_k_set as jtopk

    rs = np.random.RandomState(4)
    x = np.round(rs.randn(64) * 2).astype(np.float32) / 2  # many ties
    x[5], x[9], x[20] = 0.0, -0.0, -np.inf
    got_v, got_i = top_k_set(T(x), k)
    want_v, want_i = jtopk(J(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    z = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    np.testing.assert_array_equal(top_k_set(T(z), 2)[1].numpy(), np.asarray(jtopk(J(z), 2)[1]))
    np.testing.assert_array_equal(top_k_set(T(z), 3)[1].numpy(), [0, 1, 2])


@pytest.mark.parametrize("fn", ["nms", "batched_nms"])
@pytest.mark.parametrize("max_out", [5, 60])
def test_nms_matches_jax(fn, max_out):
    """Clustered boxes with tied scores and some invalid candidates; a
    block size below N exercises the row blocks."""
    import importlib

    from attentionshift_torch.ops import nms as tn
    jn = importlib.import_module("attentionshift_tpu.ops.nms")  # the package exports the function

    rs = np.random.RandomState(5)
    centres = boxes(rs, 8)
    bx = (centres[rs.randint(0, 8, 50)] + rs.randn(50, 4) * 2).astype(np.float32)
    sc = (np.round(rs.rand(50) * 10) / 10).astype(np.float32)  # ties
    val = rs.rand(50) > 0.2
    if fn == "nms":
        got = tn.nms(T(bx), T(sc), 0.5, max_out, valid=T(val), block=16)
        want = jn.nms(J(bx), J(sc), 0.5, max_out, valid=J(val))
    else:
        ids = rs.randint(0, 3, 50).astype(np.int32)
        got = tn.batched_nms(T(bx), T(sc), T(ids), 0.5, max_out, valid=T(val))
        want = jn.batched_nms(J(bx), J(sc), J(ids), 0.5, max_out, valid=J(val))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert 0 < int(got[1].sum())


def test_point_sample_matches_jax_and_is_differentiable():
    from attentionshift_torch.ops.sampling import point_sample
    from attentionshift_tpu.ops.sampling import point_sample as jps

    rs = np.random.RandomState(6)
    f = rs.randn(3, 4, 7, 9).astype(np.float32)
    p = (rs.rand(3, 11, 2) * 1.4 - 0.2).astype(np.float32)  # some outside [0, 1]
    ft = T(f).requires_grad_(True)
    got = point_sample(ft, T(p))
    close(got.detach(), jps(J(f), J(p)), 1e-6)
    g = rs.randn(*got.shape).astype(np.float32)
    want_grad = jax.vjp(lambda x: jps(x, J(p)), J(f))[1](J(g))[0]
    close(torch.autograd.grad(got, ft, T(g))[0], want_grad, 1e-6)


# ------------------------------------------------------------------ layers
def test_sincos_and_decoder_pos_embed_match_jax():
    from attentionshift_torch.models import heads as th
    from attentionshift_torch.models.layers import get_2d_sincos_pos_embed
    from attentionshift_tpu.models import heads as jh
    from attentionshift_tpu.models.layers import get_2d_sincos_pos_embed as jsincos

    np.testing.assert_array_equal(get_2d_sincos_pos_embed(32, 14, True), jsincos(32, 14, True))
    for s in (7, 14):
        close(th._decoder_pos_embed(32, 14, s, s), jh._decoder_pos_embed(32, 14, s, s), 1e-6)


def test_conv3x3_matmul_matches_jax():
    from attentionshift_torch.models.layers import Conv3x3Matmul
    from attentionshift_tpu.models.layers import Conv3x3Matmul as JConv

    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 6, 4).astype(np.float32)
    jm = JConv(8)
    params = fill(jm.init(jax.random.PRNGKey(0), J(x))["params"], rs)
    tm = Conv3x3Matmul(4, 8)
    tm.load_state_dict({"weight": T(params["kernel"]), "bias": T(params["bias"])})
    close(tm(T(x)).detach(), jm.apply({"params": params}, J(x)), 1e-5)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_block_with_handed_drop_masks_matches_jax(use_kernel):
    """Drop path with the JAX package's Bernoulli masks handed in: a
    sample whose branch is dropped keeps its input, a kept one is scaled
    by 1 / keep. ``use_kernel`` picks the attention ops (plain versions on
    the CPU) or the decoder heads' PyTorch attention; both match."""
    from attentionshift_torch.models.layers import Block
    from attentionshift_tpu.models.layers import Block as JBlock

    rs = np.random.RandomState(8)
    x = rs.randn(4, 10, 128).astype(np.float32)
    rate = 0.4
    jm = JBlock(num_heads=2, drop_path=rate, deterministic=False)
    key = jax.random.PRNGKey(1)
    params = fill(jm.init({"params": key, "dropout": key}, J(x))["params"], rs)
    dkey = jax.random.PRNGKey(9)
    want, _ = jm.apply({"params": params}, J(x), rngs={"dropout": dkey})
    # flax folds the module path and a per-call counter into the stream:
    # replay its two masks by intercepting bernoulli
    from unittest import mock
    masks = []
    orig = jax.random.bernoulli

    def spy(*a, **k):
        masks.append(np.asarray(orig(*a, **k)).reshape(-1))
        return orig(*a, **k)

    with mock.patch.object(jax.random, "bernoulli", spy):
        jm.apply({"params": params}, J(x), rngs={"dropout": dkey})
    assert len(masks) == 2 and not all(m.all() for m in masks)
    tm = Block(128, 2, drop_path=rate, use_kernel=use_kernel)
    from attentionshift_torch.convert import flax_to_torch
    sd = flax_to_torch({"params": {"backbone": {"blocks_0": jax.tree.map(np.asarray, params)}}})
    tm.load_state_dict({k[len("backbone.blocks.0."):]: v for k, v in sd.items()}, strict=True)
    got, _ = tm(T(x), drop_masks=T(np.stack(masks).astype(np.float32)))
    close(got.detach(), want, 1e-5)
    det, _ = tm(T(x))
    close(det.detach(), JBlock(num_heads=2).apply({"params": params}, J(x))[0], 1e-5)


# ------------------------------------------------------------------ models
def test_fpn_matches_jax():
    from attentionshift_torch.models.fpn import FPN
    from attentionshift_tpu.models.fpn import FPN as JFPN

    rs = np.random.RandomState(9)
    feats = [rs.randn(1, 16 >> i, 24 >> i, 12).astype(np.float32) for i in range(4)]
    jm = JFPN(out_channels=8)
    params = fill(jm.init(jax.random.PRNGKey(0), tuple(map(J, feats)))["params"], rs)
    tm = load_sub(FPN(12, 8), "neck", params)
    got = tm([T(f) for f in feats])
    want = jm.apply({"params": params}, tuple(map(J, feats)))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        close(a.detach(), b, 1e-5)
    # mmdet's init scale: Xavier-uniform bound of the 3x3 convs
    w = FPN(12, 8).fpn_conv[0].weight
    assert float(w.detach().abs().max()) <= (6.0 / (9 * 16)) ** 0.5


@pytest.fixture(scope="module")
def rpn_case():
    """RPN head outputs of both packages on small pyramid features."""
    from attentionshift_torch.models.rpn import RPNHead
    from attentionshift_tpu.models.rpn import RPNHead as JRPN

    rs = np.random.RandomState(10)
    feats = [rs.randn(1, s[0], s[1], 8).astype(np.float32)
             for s in ((32, 48), (16, 24), (8, 12), (4, 6), (2, 3))]
    jm = JRPN(feat_channels=8)
    params = fill(jm.init(jax.random.PRNGKey(0), list(map(J, feats)))["params"], rs, scale=0.3)
    tm = load_sub(RPNHead(8), "rpn_head", params)
    jout = jm.apply({"params": params}, list(map(J, feats)))
    tout = tm([T(f) for f in feats])
    return feats, jout, tout


def test_rpn_head_matches_jax(rpn_case):
    from attentionshift_torch.models.rpn import RPNHead

    _, jout, tout = rpn_case
    for jl, tl in zip(jout, tout):
        for a, b in zip(tl, jl):
            close(a.detach(), b, 1e-5)
    assert float(RPNHead(64).rpn_conv.weight.std()) < 0.02  # Normal(0.01) init


def test_rpn_loss_matches_jax(rpn_case):
    from attentionshift_torch.core.anchors import grid_anchors
    from attentionshift_torch.models.rpn import rpn_loss
    from attentionshift_tpu.core.anchors import grid_anchors as janchors
    from attentionshift_tpu.models.rpn import rpn_loss as jloss

    feats, jout, tout = rpn_case
    sizes = [f.shape[1:3] for f in feats]
    gts = np.array([[[10, 10, 60, 50], [80, 40, 150, 100], [0, 0, 1, 1]]], np.float32)
    val = np.array([[True, True, False]])
    key = jax.random.PRNGKey(3)
    want = jloss(key, jout[0], jout[1], janchors(sizes), J(gts), J(val))
    n = sum(h * w * 3 for h, w in sizes)
    k_pos, k_neg = jax.random.split(jax.random.split(key, 1)[0])
    draws = [dict(u_pos=T(jax.random.uniform(k_pos, (n,))), u_neg=T(jax.random.uniform(k_neg, (n,))))]
    got = rpn_loss(tout[0], tout[1], grid_anchors(sizes), T(gts), T(val), draws=draws)
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_bbox"}
    for k in got:
        close(got[k].detach(), want[k], 1e-5, what=k)
    assert float(got["loss_rpn_bbox"]) > 0


def test_rpn_proposals_match_jax(rpn_case):
    """nms_pre below the finest level's anchor count / 8 takes the
    set-selection branch there and the ranked one on the coarse levels."""
    from attentionshift_torch.core.anchors import grid_anchors_per_level
    from attentionshift_torch.models.rpn import rpn_proposals
    from attentionshift_tpu.core.anchors import grid_anchors_per_level as janchors
    from attentionshift_tpu.models.rpn import rpn_proposals as jprops

    feats, jout, tout = rpn_case
    sizes = [f.shape[1:3] for f in feats]
    want = jprops(jout[0], jout[1], janchors(sizes), (128, 192), nms_pre=300, max_per_img=120)
    got = rpn_proposals(tout[0], tout[1], grid_anchors_per_level(sizes), (128, 192), nms_pre=300,
                        max_per_img=120)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    close(got.boxes.detach(), want.boxes, 1e-3)
    close(got.scores.detach(), want.scores, 1e-6)
    assert 0 < int(got.valid.sum())
    # the kept boxes stay differentiable in the box deltas, as in the JAX package
    assert got.boxes.requires_grad and not got.valid.requires_grad


def test_box_head_and_loss_match_jax():
    from attentionshift_torch.models.heads import BoxHeadRec
    from attentionshift_tpu.models.heads import BoxHeadRec as JBox

    rs = np.random.RandomState(11)
    kw = dict(num_classes=5, in_channels=24, embed_dim=32, depth=2, num_heads=4)
    x = rs.randn(6, 7, 7, 24).astype(np.float32)
    jm = JBox(**kw)
    params = fill(jm.init(jax.random.PRNGKey(0), J(x))["params"], rs)
    tm = load_sub(BoxHeadRec(**kw), "bbox_head", params)
    jc, jb, _ = jm.apply({"params": params}, J(x))
    tc, tb, _ = tm(T(x))
    close(tc.detach(), jc, 1e-5)
    close(tb.detach(), jb, 1e-5)
    rois, tg = boxes(rs, 6), boxes(rs, 6)
    labels = np.array([0, 4, 5, 5, 2, 5], np.int32)  # 5 = background
    lw = np.array([1, 1, 1, 1, 1, 0], np.float32)
    bw = np.repeat((labels < 5).astype(np.float32)[:, None], 4, 1)
    want = jm.apply({"params": params}, jc, jb, J(rois), J(labels), J(lw), J(tg), J(bw),
                    loss_enable=0.5, method=JBox.loss)
    got = tm.loss(tc, tb, T(rois), T(labels), T(lw), T(tg), T(bw), loss_enable=0.5)
    assert set(got) == set(want) == {"loss_cls", "acc", "loss_bbox"}
    for k in got:
        close(got[k].detach(), want[k], 1e-5, what=k)


def test_mask_head_and_point_loss_match_jax():
    from attentionshift_torch.models.heads import MaskHeadPointSup, mask_point_loss
    from attentionshift_tpu.models.heads import MaskHeadPointSup as JMask
    from attentionshift_tpu.models.heads import mask_point_loss as jloss

    rs = np.random.RandomState(12)
    kw = dict(num_classes=5, in_channels=24, embed_dim=32, depth=2, num_heads=4)
    x = rs.randn(3, 14, 14, 24).astype(np.float32)
    jm = JMask(**kw)
    params = fill(jm.init(jax.random.PRNGKey(0), J(x))["params"], rs)
    tm = load_sub(MaskHeadPointSup(**kw), "mask_head", params)
    want = jm.apply({"params": params}, J(x))
    got = tm(T(x))
    assert tuple(got.shape) == (3, 28, 28, 5)
    close(got.detach(), want, 1e-5)
    preds = rs.randn(4, 9, 5).astype(np.float32)
    tgt = rs.randint(0, 3, (4, 9)).astype(np.int32)
    lab = rs.randint(0, 5, 4).astype(np.int32)
    pv = np.array([True, True, False, True])
    close(mask_point_loss(T(preds), T(tgt), T(lab), T(pv), 0.5),
          jloss(J(preds), J(tgt), J(lab), J(pv), 0.5), 1e-6)


# ------------------------------------------------------------------- optim
def test_layer_ids_decay_mask_and_schedule_match_jax():
    from attentionshift_torch.train import optim as to
    from attentionshift_tpu.train import optim as jo

    pairs = {
        "backbone.cls_token": ("backbone", "cls_token"),
        "backbone.pos_embed": ("backbone", "pos_embed"),
        "backbone.patch_embed.proj.weight": ("backbone", "patch_embed", "proj", "kernel"),
        "backbone.blocks.0.attn.qkv.weight": ("backbone", "blocks_0", "attn", "qkv", "kernel"),
        "backbone.blocks.11.mlp.fc1.bias": ("backbone", "blocks_11", "mlp", "fc1", "bias"),
        "backbone.point_token": ("backbone", "point_token"),
        "backbone.class_embed.layers.0.weight": ("backbone", "class_embed", "layers_0", "kernel"),
        "bbox_head.fc_cls.weight": ("bbox_head", "fc_cls", "kernel"),
        "bbox_head.det_token": ("bbox_head", "det_token"),
        "neck.lateral.0.bias": ("neck", "lateral_0", "bias"),
    }
    shapes = {n: ((4,) if n.endswith("bias") else (1, 2, 4) if "token" in n or "pos_embed" in n
                  else (4, 4)) for n in pairs}
    for name, path in pairs.items():
        assert to.vit_layer_id(name, 14) == jo.vit_layer_id(path, 14), name
    tree = {}
    for name, path in pairs.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.zeros(shapes[name])
    jmask = jo.weight_decay_mask(tree)
    jscale = jo.lr_scale_tree(tree, 0.75, 12)
    tmask = to.weight_decay_mask([(n, torch.zeros(shapes[n])) for n in pairs])
    tscale = to.lr_scales(list(pairs), 0.75, 12)
    for name, path in pairs.items():
        jm, js = jmask, jscale
        for p in path:
            jm, js = jm[p], js[p]
        assert tmask[name] == bool(jm), name
        assert tscale[name] == pytest.approx(float(js)), name
    ts = to.step_lr_schedule(1e-4, 100, (8, 11), warmup_iters=50)
    js = jo.step_lr_schedule(1e-4, 100, (8, 11), warmup_iters=50)
    for step in (0, 1, 49, 50, 799, 800, 1099, 1100, 5000):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6), step


def test_backbone_training_forward_matches_jax_and_remat_changes_nothing():
    """The backbone's training forward with drop path (rates
    linspace(0, 0.3, depth)), the JAX package's Bernoulli masks replayed
    by intercepting its draws: every output within 1e-5 of its largest
    value. Then the port alone: activation checkpointing gives the same
    outputs and the same gradients as keeping the activations (the
    recompute sees the same masks and skips the probability capture)."""
    from unittest import mock

    from attentionshift_tpu.models.vit import VisionTransformerDet as JViT
    from test_torch_support import TINY, blob_inputs, random_variables, jax_model, torch_model

    kw = dict(TINY, max_gt=4, pad_tokens_to=128, drop_path_rate=0.3)
    args = blob_inputs(64, 96, 4, 3)
    variables = random_variables(jax_model(**kw), args)
    jvit = JViT(embed_dim=128, depth=4, num_heads=2, point_tokens_num=16, capture_layers=3,
                out_indices=(0, 1, 2, 3), pad_tokens_to=128, drop_path_rate=0.3, use_remat=False)
    jvars = {"params": variables["params"]["backbone"],
             "batch_stats": variables["batch_stats"]["backbone"]}
    masks, orig = [], jax.random.bernoulli

    def spy(*a, **k):
        masks.append(np.asarray(orig(*a, **k)).reshape(-1))
        return orig(*a, **k)

    with mock.patch.object(jax.random, "bernoulli", spy):
        want = jvit.apply(jvars, J(args[0]), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(2)})
    # block 0 has rate 0 and draws nothing
    assert len(masks) == 6
    drop = np.ones((4, 2, 1), np.float32)
    drop[1:] = np.stack(masks).astype(np.float32).reshape(3, 2, 1)
    port = torch_model(variables, use_remat=True, **kw).backbone
    img = T(args[0])

    def run(remat):
        port.use_remat = remat
        port.zero_grad()
        out = port(img, deterministic=False, drop_masks=T(drop))
        loss = out["outputs_class"].square().sum() + out["last_feat"].square().sum() \
            + sum(f.square().sum() for f in out["feature"])
        loss.backward()
        return out, {n: p.grad.clone() for n, p in port.named_parameters() if p.grad is not None}

    out, grads = run(True)
    for key in ("point_tokens", "last_feat", "outputs_class", "outputs_coord", "attns", "org_feats"):
        ref = np.asarray(want[key])
        close(out[key].detach(), ref, 1e-5 * max(float(np.abs(ref).max()), 1.0), what=key)
    for a, b in zip(out["feature"], want["feature"]):
        close(a.detach(), b, 1e-5 * max(float(np.abs(np.asarray(b)).max()), 1.0), what="feature")
    out2, grads2 = run(False)
    assert torch.equal(out["last_feat"], out2["last_feat"]) and grads.keys() == grads2.keys()
    for name in grads:
        close(grads[name], grads2[name], 1e-6 * max(float(grads2[name].abs().max()), 1.0), what=name)
