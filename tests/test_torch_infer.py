"""Single-scale inference of the PyTorch port against the JAX package.

``multiclass_nms``, ``paste_masks``, ``expansion``, the detector's test
stages (``rpn_test``, ``roi_test``, ``mask_test``), ``simple_test`` and
``make_eval_step``, and the numpy evaluation copies, each on the same
numpy inputs and the same weights as its JAX twin, on the CPU in f32.
The JAX side of one model is ONE jitted function that returns every
stage's outputs, so each model compiles once.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import (TINY, VITS, blob_inputs, ckpt3k_variables, close, inputs,  # noqa: E402
                                jax_model, random_variables, to_torch, torch_model)

# ---------------------------------------------------------------- multiclass NMS


def _nms_case(kind: str):
    """(boxes, scores, box_valid, kwargs) of one ``multiclass_nms`` case."""
    rs = np.random.RandomState({"specific": 0, "agnostic": 1, "valid": 2, "ties": 3, "few": 4}[kind])
    n, c = 60, 5
    xy = rs.rand(n, c, 2) * 80
    wh = rs.rand(n, c, 2) * 40 + 4
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)  # (N, C, 4)
    logits = rs.randn(n, c + 1).astype(np.float32) * 2
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    valid = None
    kw = dict(score_thr=0.05, iou_threshold=0.5, max_per_img=20, pre_nms_top_n=100)
    if kind == "agnostic":
        boxes = boxes[:, 0]
    else:
        boxes = boxes.reshape(n, c * 4)
    if kind == "valid":
        valid = rs.rand(n) > 0.4
    if kind == "ties":
        # scores on a coarse grid: many exact ties, broken by the lowest index
        scores = (np.round(scores * 8) / 8).astype(np.float32)
        boxes = np.round(boxes / 16) * 16 + np.tile([0, 0, 8, 8], boxes.shape[1] // 4)
        boxes = boxes.astype(np.float32)
    if kind == "few":
        # a high floor leaves fewer survivors than max_per_img
        kw.update(score_thr=0.9)
    return boxes, scores.astype(np.float32), valid, kw


@pytest.mark.parametrize("kind", ["specific", "agnostic", "valid", "ties", "few"])
def test_multiclass_nms_matches_jax(kind):
    """Port ``multiclass_nms`` vs the JAX twin: labels and validity
    exactly, scores and boxes 1e-6 (the same f32 values gathered)."""
    from attentionshift_torch.core.postprocess import multiclass_nms
    from attentionshift_tpu.core.postprocess import multiclass_nms as jnms

    boxes, scores, valid, kw = _nms_case(kind)
    want = jnms(jnp.asarray(boxes), jnp.asarray(scores), kw["score_thr"], kw["iou_threshold"],
                kw["max_per_img"], kw["pre_nms_top_n"],
                box_valid=None if valid is None else jnp.asarray(valid))
    got = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores), kw["score_thr"],
                         kw["iou_threshold"], kw["max_per_img"], kw["pre_nms_top_n"],
                         box_valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.labels.dtype == torch.int32 and got.valid.dtype == torch.bool
    close(got.scores, want.scores, 1e-6, what="scores")
    close(got.boxes, want.boxes, 1e-6, what="boxes")
    n_kept = int(np.asarray(want.valid).sum())
    if kind == "few":
        assert 0 < n_kept < kw["max_per_img"]
        assert float(got.scores[n_kept:].abs().max()) == 0.0
    elif kind == "ties":
        kept = got.scores.numpy()[:n_kept]
        assert len(np.unique(kept)) < n_kept, "the case must hold tied scores"
    else:
        assert n_kept == kw["max_per_img"]


def test_multiclass_nms_keeps_scores_differentiable():
    """The selections build no graph, the kept scores and boxes do: a
    gradient of the kept scores reaches exactly the kept candidates."""
    from attentionshift_torch.core.postprocess import multiclass_nms

    boxes, scores, _, kw = _nms_case("specific")
    s = torch.from_numpy(scores).requires_grad_(True)
    b = torch.from_numpy(boxes).requires_grad_(True)
    got = multiclass_nms(b, s, kw["score_thr"], kw["iou_threshold"], kw["max_per_img"])
    gs, gb = torch.autograd.grad(got.scores.sum() + got.boxes.sum(), (s, b))
    assert int((gs != 0).sum()) == int(got.valid.sum())
    assert int((gb != 0).sum()) == 4 * kw["max_per_img"]


# ------------------------------------------------------------------- mask ops


@pytest.mark.parametrize("size", [5, 3])
def test_expansion_matches_jax(size):
    """Max-pool dilation: exact (a selection of input values)."""
    from attentionshift_torch.ops.masks import expansion
    from attentionshift_tpu.ops.masks import expansion as jexp

    x = np.random.RandomState(0).randn(2, 3, 17, 23).astype(np.float32)
    np.testing.assert_array_equal(expansion(torch.from_numpy(x), size).numpy(),
                                  np.asarray(jexp(jnp.asarray(x), size)))


def test_paste_masks_matches_jax():
    """RoI -> image paste, with a box partly outside the image, a tiny box
    and a degenerate (zero-width) one: 1e-5 (f32 interpolation weights)."""
    from attentionshift_torch.ops.masks import paste_masks
    from attentionshift_tpu.ops.masks import paste_masks as jpaste

    rs = np.random.RandomState(1)
    masks = rs.rand(5, 28, 28).astype(np.float32)
    boxes = np.asarray([[10.3, 5.2, 50.7, 40.1], [-8.0, -4.0, 30.0, 20.0], [40.0, 30.0, 90.0, 70.0],
                        [20.0, 20.0, 21.5, 22.5], [33.0, 10.0, 33.0, 30.0]], np.float32)
    want = np.asarray(jpaste(jnp.asarray(masks), jnp.asarray(boxes), 48, 64))
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), 48, 64)
    assert got.shape == (5, 48, 64)
    close(got, want, 1e-5, what="paste_masks")
    assert float(got[0, :, 52:].abs().max()) == 0.0  # zero outside the box's reach


# ------------------------------------------------------------ detector stages

# small RPN/RCNN sizes (the train-time ones only shape the parameter init)
TEST_SIZES = dict(num_proposals=100, rpn_nms_pre=200, rcnn_samples=64, mask_sample_cap=16,
                  test_max_per_img=20, max_gt=4, pad_tokens_to=128)
# boxes: 1e-3 px plus 1e-5 of the coordinate. A decoded side is anchor size x
# exp(delta) with anchors up to 512 px, so the backbone's f32 summation noise
# (1e-5 relative, as the slice tests state) reaches 1e-3 px on large boxes.
BOX_TOL = dict(atol=1e-3, rtol=1e-5)


class InferCase:
    """Both packages' detectors on the same weights; batch 2, the second
    image's true extent smaller than the canvas."""

    def __init__(self, weights: str):
        from attentionshift_tpu.models.detector import AttnShiftDetector as JDet

        if weights == "random":
            kw, (h, w) = dict(TINY), (64, 96)
            # random heads score every class near 1/21: a floor below that, so
            # that detections exist
            kw.update(test_score_thr=0.02)
        else:
            kw, (h, w) = dict(VITS), (128, 192)
        kw.update(TEST_SIZES)
        self.kw, self.hw = kw, (h, w)
        one = blob_inputs(h, w, 4, 3, seed=0)
        two = blob_inputs(h, w, 4, 3, seed=5)
        self.img = np.concatenate([one[0], two[0]])
        self.wh = np.asarray([[w, h], [w * 0.8, h * 0.75]], np.float32)
        rs = np.random.RandomState(7)
        xy = rs.rand(2, 6, 2) * [w * 0.5, h * 0.5]
        self.rois = np.concatenate([xy, xy + rs.rand(2, 6, 2) * [w * 0.5, h * 0.5] + 8],
                                   -1).astype(np.float32)
        self.roi_labels = rs.randint(0, 20, (2, 6)).astype(np.int32)
        self.jmodel = jax_model(**kw)
        self.variables = (random_variables(self.jmodel, inputs(h, w, 4, 3))
                          if weights == "random" else ckpt3k_variables())
        img, wh, rois, lbl = map(jnp.asarray, (self.img, self.wh, self.rois, self.roi_labels))

        def stages(v):
            ap = lambda m, *a: self.jmodel.apply(v, *a, method=m)  # noqa: E731
            return dict(rpn=ap(JDet.rpn_test, img), roi=ap(JDet.roi_test, img, rois, wh),
                        mask=ap(JDet.mask_test, img, rois, lbl),
                        simple=ap(JDet.simple_test, img, wh))

        self.want = jax.tree.map(np.asarray, jax.jit(stages)(self.variables))
        self.port = torch_model(self.variables, **kw)
        self.timg, self.twh, self.trois, self.tlbl = to_torch(self.img, self.wh, self.rois,
                                                              self.roi_labels)


@pytest.fixture(scope="module", params=["random", "ckpt3k"])
def case(request):
    return InferCase(request.param)


def test_rpn_test_matches_jax(case):
    """Proposals: validity exactly, boxes ``BOX_TOL``, scores 1e-5."""
    want = case.want["rpn"]
    got = case.port.rpn_test(case.timg)
    assert got.boxes.shape == (2, TEST_SIZES["num_proposals"], 4)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert want.valid.sum() >= 8
    close(got.boxes, want.boxes, what="proposal boxes", **BOX_TOL)
    close(got.scores, want.scores, 1e-5, what="proposal scores")


def test_roi_test_matches_jax(case):
    """Box head on given rois: scores 1e-4, decoded boxes ``BOX_TOL``, clipped to
    the TRUE extent of each image (the second one's is smaller than the
    canvas), in both packages."""
    want_scores, want_boxes = case.want["roi"]
    scores, boxes = case.port.roi_test(case.timg, case.trois, case.twh)
    assert scores.shape == (2, 6, 21) and boxes.shape == (2, 6, 20, 4)
    close(scores, want_scores, 1e-4, what="roi scores")
    close(boxes, want_boxes, what="decoded boxes", **BOX_TOL)
    for b in (boxes.numpy(), want_boxes):
        assert (b >= 0).all()
        for i in range(2):
            assert (b[i, ..., 0::2] <= case.wh[i, 0]).all() and (b[i, ..., 1::2] <= case.wh[i, 1]).all()
    h, w = case.hw
    assert boxes[1, ..., 2].max() == case.wh[1, 0] < w, "the clip must bind on the smaller extent"


def test_mask_test_matches_jax(case):
    """Mask head on given rois: probabilities of the given labels, 1e-4."""
    got = case.port.mask_test(case.timg, case.trois, case.tlbl)
    assert got.shape == (2, 6, 28, 28)
    close(got, case.want["mask"], 1e-4, what="mask probs")
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def _check_test_outputs(got, want, wh, k):
    np.testing.assert_array_equal(got.dets.valid.numpy(), want.dets.valid)
    np.testing.assert_array_equal(got.dets.labels.numpy(), want.dets.labels)
    close(got.dets.boxes, want.dets.boxes, what="det boxes", **BOX_TOL)
    close(got.dets.scores, want.dets.scores, 1e-4, what="det scores")
    assert got.mask_probs.shape == (2, k, 28, 28)
    valid = want.dets.valid
    close(got.mask_probs.numpy()[valid], want.mask_probs[valid], 1e-4, what="mask probs")
    b = got.dets.boxes.numpy()
    for i in range(2):
        assert (b[i] >= 0).all()
        assert (b[i][:, 0::2] <= wh[i, 0]).all() and (b[i][:, 1::2] <= wh[i, 1]).all()


def test_simple_test_matches_jax(case):
    """``simple_test``: validity and labels exactly, boxes ``BOX_TOL``, scores
    1e-4, mask probabilities 1e-4 on the valid slots; boxes inside each
    image's true extent; some but not necessarily all slots valid."""
    want = case.want["simple"]
    got = case.port.simple_test(case.timg, case.twh)
    assert want.dets.valid.sum() >= 4, "the case must hold detections"
    _check_test_outputs(got, want, case.wh, TEST_SIZES["test_max_per_img"])
    assert not got.dets.scores.requires_grad and not got.mask_probs.requires_grad


def test_simple_test_launch_free_on_the_cpu_and_without_capture(case):
    """At test time the backbone takes the no-capture route (nobody reads
    the attention): ``attns`` is None and the features equal those of a
    capturing forward. CPU tensors count no kernel launch."""
    from attentionshift_torch.ops._build import KERNELS, reset_launches

    reset_launches()
    with torch.no_grad():
        plain = case.port.backbone(case.timg, with_features=True, capture=False)
        cap = case.port.backbone(case.timg, with_features=True)
    assert plain["attns"] is None and cap["attns"].shape[0] == case.kw["cam_layer"]
    assert torch.equal(plain["last_feat"], cap["last_feat"])
    for a, b in zip(plain["feature"], cap["feature"]):
        assert torch.equal(a, b)
    assert all(kr.launches == 0 for kr in KERNELS.values())


def test_make_eval_step_matches_jax(case):
    """``make_eval_step(model)(img, img_wh)`` against the JAX
    ``make_eval_step(model)(params, img, img_wh)``: as ``simple_test``."""
    from attentionshift_torch.models import TestOutputs
    from attentionshift_torch.train import make_eval_step
    from attentionshift_tpu.train.step import make_eval_step as jmake

    if case.kw["embed_dim"] != TINY["embed_dim"]:
        # the ckpt3k model's simple_test is already compiled once above; its
        # eval step is the same function behind another jit
        want = case.want["simple"]
    else:
        want = jax.tree.map(np.asarray, jmake(case.jmodel)(case.variables, jnp.asarray(case.img),
                                                           jnp.asarray(case.wh)))
    got = make_eval_step(case.port)(case.timg, case.twh)
    assert isinstance(got, TestOutputs)
    _check_test_outputs(got, want, case.wh, TEST_SIZES["test_max_per_img"])


def test_test_from_feats_stays_differentiable(case):
    """``test_from_feats`` sets no ``no_grad``: with ``roi_map`` requiring
    grad, the detection scores carry a gradient back to it (grad-CAM's
    use), and its outputs equal ``simple_test``'s."""
    with torch.no_grad():
        out, roi_map, _ = case.port._extract(case.timg, with_features=True, capture=False)
    roi_map = roi_map.clone().requires_grad_(True)
    got = case.port.test_from_feats(out, roi_map, case.twh, case.hw)
    ref = case.port.simple_test(case.timg, case.twh)
    assert torch.equal(got.dets.labels, ref.dets.labels)
    close(got.dets.scores.detach(), ref.dets.scores, 1e-6)
    (g,) = torch.autograd.grad(got.dets.scores.sum(), roi_map)
    assert float(g.abs().max()) > 0


# ------------------------------------------------------------ evaluation copies


def _predictions(seed=0, n_img=3, n_cls=4, hw=(40, 56)):
    rs = np.random.RandomState(seed)
    h, w = hw
    preds = []
    for _ in range(n_img):
        k = 8
        xy = rs.rand(k, 2) * [w * 0.6, h * 0.6]
        boxes = np.concatenate([xy, xy + rs.rand(k, 2) * [w * 0.4, h * 0.4] + 3], -1)
        preds.append(dict(boxes=boxes.astype(np.float32), scores=rs.rand(k).astype(np.float32),
                          labels=rs.randint(0, n_cls, k), valid=rs.rand(k) > 0.25,
                          mask_probs=rs.rand(k, 28, 28).astype(np.float32)))
    return preds, rs


def test_eval_copies_match_jax_package():
    """The port's numpy copies of ``finalize_detections`` /
    ``paste_masks_np`` and ``eval_map_segm`` / ``eval_map`` against the
    JAX package's on the same predictions: exact."""
    from attentionshift_torch.eval import eval_map, eval_map_segm, finalize_detections
    from attentionshift_tpu.eval import eval_map as jmap
    from attentionshift_tpu.eval import eval_map_segm as jsegm
    from attentionshift_tpu.eval import finalize_detections as jfin

    preds, rs = _predictions()
    scale, orig = np.asarray([1.4, 1.4]), np.asarray([40, 28])
    got = [finalize_detections(scale_wh=scale, orig_wh=orig, **p) for p in preds]
    want = [jfin(scale_wh=scale, orig_wh=orig, **p) for p in preds]
    for a, b in zip(got, want):
        assert set(a) == set(b) == {"boxes", "scores", "labels", "masks"}
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["masks"].shape[1:] == (28, 40) and a["masks"].dtype == bool
    # ground truth: a subset of the predictions' masks, so that some match
    gts = [d["masks"][::2] for d in got]
    gls = [d["labels"][::2] for d in got]
    args = ([d["masks"] for d in got], [d["labels"] for d in got], [d["scores"] for d in got],
            gts, gls, 4)
    m1, ap1, st1 = eval_map_segm(*args)
    m2, ap2, st2 = jsegm(*args)
    assert m1 == m2 and 0 < m1 <= 1
    np.testing.assert_array_equal(ap1, ap2)
    np.testing.assert_array_equal(st1["num_gts"], st2["num_gts"])
    bargs = ([d["boxes"] for d in got], args[1], args[2], [d["boxes"][::2] for d in got], gls, 4)
    b1, b2 = eval_map(*bargs), jmap(*bargs)
    assert b1[0] == b2[0]
    np.testing.assert_array_equal(b1[1], b2[1])


def test_test_outputs_score_end_to_end(case):
    """A ``TestOutputs`` of the port turned into full-image masks with the
    port's ``finalize_detections`` and scored with its ``eval_map_segm``
    gives what the JAX package's outputs give through the JAX package's
    evaluation: the same mAP, with each image's own detections as ground
    truth (mAP 1 when nothing overlaps, and the same value either way)."""
    from attentionshift_torch.eval import eval_map_segm, finalize_detections
    from attentionshift_tpu.eval import eval_map_segm as jsegm
    from attentionshift_tpu.eval import finalize_detections as jfin

    got = case.port.simple_test(case.timg, case.twh)
    want = case.want["simple"]

    def score(outs, fin, segm, as_np):
        dets = [fin(as_np(outs.dets.boxes[i]), as_np(outs.dets.scores[i]),
                    as_np(outs.dets.labels[i]), as_np(outs.dets.valid[i]),
                    as_np(outs.mask_probs[i]), np.asarray([1.0, 1.0]), case.wh[i])
                for i in range(2)]
        masks = [d["masks"] for d in dets]
        labels = [d["labels"] for d in dets]
        return segm(masks, labels, [d["scores"] for d in dets], masks, labels, 20)[0], dets

    m_port, d_port = score(got, finalize_detections, eval_map_segm, lambda t: t.numpy())
    m_jax, d_jax = score(want, jfin, jsegm, np.asarray)
    assert m_port == m_jax
    for a, b in zip(d_port, d_jax):
        assert a["masks"].shape == b["masks"].shape
        # thresholded pasted masks: equal except where a probability sits within
        # 1e-4 of the 0.5 threshold
        assert (a["masks"] != b["masks"]).mean() < 1e-3
