"""The refinement stage's Mask R-CNN of the PyTorch port against the JAX package.

At the TINY size of ``tests/test_mask_rcnn.py`` (ResNet depths (1, 1, 1, 1),
128 x 128, 5 classes, 50 proposals, 32 RCNN samples, 8 mask RoIs), on the
CPU in f32, both packages run the same weights (JAX-shaped random
variables carried over by ``convert.flax_to_torch(model_type="mask_rcnn")``)
on the same numpy inputs, and the train forward takes the JAX draws
replayed from its key tree. Tolerances:

- the ResNet pyramid, the heads and the routed RoI features: 1e-5 of each
  output's largest magnitude (f32 sums in another order);
- the train losses: 2e-4 of max(1, |value|), discrete outputs (sampled
  positives, level indices) exactly, RoI boxes 1e-3 px + 1e-5 of the
  coordinate; every trainable parameter's gradient: 2e-3 of that tensor's
  largest entry (the train step's tolerance, ``check_tree``); frozen
  tensors: no gradient in the port, exactly zero in JAX;
- ``simple_test``: labels and validity exactly, boxes 1e-3 px + 1e-5 of
  the coordinate (f32 backbone noise times anchor size, as for the
  AttnShift detector), scores and mask probabilities 1e-4; the aug-test
  stages the same;
- the SGD optimizer fed the same gradients: parameters 1e-6 of their
  scale, the momentum trace 1e-5 of each tensor's largest entry;
- the torchvision graft, the dataset and the pipeline: exactly.

The JAX side of each model is one jitted function per kind of call (the
train value-and-grad, the test stages), each compiled once for the module.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import BOX_TOL, check_tree, close, n_anchors  # noqa: E402

H = W = 128
MS = 4
G = 4
KW = dict(num_classes=5, num_proposals=50, rpn_nms_pre=100, rcnn_samples=32, mask_sample_cap=8,
          mask_stride=MS, depths=(1, 1, 1, 1), test_max_per_img=10)
# the train step's loss tolerance (relative to max(1, |value|)) and the
# gradient's (relative to each tensor's largest entry)
LOSS_TOL, GRAD_REL = 2e-4, 2e-3
PROB_TOL = 1e-4
BATCH_SEED = 1


def refine_batch(b: int = 2, seed: int = 0) -> dict:
    """numpy (img, gt_boxes, gt_labels, gt_masks, gt_valid, img_wh): noise
    images, three boxes per image (a fourth slot padded), box-shaped masks
    at stride ``MS`` with a hole, so the 28x28 targets are not all ones."""
    rs = np.random.RandomState(seed)
    img = rs.randn(b, H, W, 3).astype(np.float32)
    boxes = np.zeros((b, G, 4), np.float32)
    masks = np.zeros((b, G, H // MS, W // MS), np.uint8)
    for i in range(b):
        for j in range(3):
            x1, y1 = rs.randint(0, 70, 2)
            x2, y2 = x1 + rs.randint(20, 58), y1 + rs.randint(20, 58)
            boxes[i, j] = (x1, y1, x2, y2)
            masks[i, j, y1 // MS:y2 // MS, x1 // MS:x2 // MS] = 1
            masks[i, j, (y1 + y2) // (2 * MS), x1 // MS:x2 // MS] = 0
    labels = rs.randint(0, 5, (b, G)).astype(np.int32)
    valid = np.asarray([[True, True, True, False]] * b)
    wh = np.asarray([[float(W), float(H)]] * b, np.float32)
    return dict(img=img, gt_boxes=boxes, gt_labels=labels, gt_masks=masks, gt_valid=valid,
                img_wh=wh)


ARGS = ("img", "gt_boxes", "gt_labels", "gt_masks", "gt_valid", "img_wh")


def refine_variables(model, batch: dict, seed: int = 0) -> dict:
    """Flax variables of a JAX ``MaskRCNN`` from numpy: He-normal kernels
    (so the ResNet's features stay far above f32 rounding and proposal
    scores do not tie), but N(0, 0.01) prediction layers (mmdet's RPN
    and box classifier init; the box regressor at N(0, 0.001), mmdet's),
    so that deltas stay small as in training, and the mask logits at
    N(0, 0.01), which keeps the mask probabilities' sensitivity to the
    test-time box noise (1e-3 px, ROADMAP section C) under their 1e-4;
    N(0, 0.01) biases, frozen BNs near the identity with positive
    variances."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "sampling": key},
                                               *(jnp.asarray(batch[k]) for k in ARGS)))
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']") and any(k in name for k in ("rpn_head", "'fc_",
                                                                    "conv_logits")):
            std = 0.001 if "fc_reg" in name else 0.01
            return (rs.randn(*s.shape) * std).astype(np.float32)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rs.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (0.5 + rs.rand(*s.shape)).astype(np.float32)
        return (0.01 * rs.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def torch_tree(params) -> dict:
    """A flax ``MaskRCNN`` params-shaped tree under the port's names and
    layouts (parameters and FrozenBN buffers)."""
    from attentionshift_torch.convert import flax_to_torch

    return flax_to_torch({"params": jax.tree.map(np.asarray, params)}, "mask_rcnn")


def port_model(variables, **kw):
    from attentionshift_torch.convert import load_flax
    from attentionshift_torch.models.mask_rcnn import MaskRCNN

    model = MaskRCNN(device="cpu", **dict(KW, **kw))
    return load_flax(model, jax.tree.map(np.asarray, variables), "mask_rcnn")


def replay_refine_draws(jmodel, variables, key, b: int) -> list:
    """Every random draw of one JAX ``MaskRCNN`` train forward, per image:
    ``make_rng("sampling")`` -> ``split(rng, 3)`` (mask_rcnn.py:196) into
    the RPN sampler (rpn.py:92, assign.py:116), the RCNN sampler
    (mask_rcnn.py:235, assign.py:144; its ordering score draws from the
    positives' key, mask_rcnn.py:220-224) and the mask pick
    (mask_rcnn.py:273); each splits its key over the batch."""
    rng = jmodel.apply(variables, method=lambda m: m.make_rng("sampling"), rngs={"sampling": key})
    k_rpn, k_samp, k_mask = jax.random.split(rng, 3)
    u = lambda k, n: torch.from_numpy(np.array(jax.random.uniform(k, (n,))))  # noqa: E731
    n_roi = G + KW["num_proposals"]
    out = []
    for i in range(b):
        rp, rn = jax.random.split(jax.random.split(k_rpn, b)[i])
        cp, cn = jax.random.split(jax.random.split(k_samp, b)[i])
        km = jax.random.split(k_mask, b)[i]
        out.append(dict(rpn_u_pos=u(rp, n_anchors(H, W)), rpn_u_neg=u(rn, n_anchors(H, W)),
                        rcnn_u_pos=u(cp, n_roi), rcnn_u_neg=u(cn, n_roi),
                        mask_u=u(km, KW["rcnn_samples"])))
    return out


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def case():
    """Both packages' TINY Mask R-CNN on the same weights, a batch of two,
    and the JAX train forward's losses, aux and gradients with its draws."""
    from attentionshift_tpu.models.mask_rcnn import MaskRCNN as JMaskRCNN

    batch = refine_batch(seed=BATCH_SEED)
    jmodel = JMaskRCNN(**KW)
    variables = refine_variables(jmodel, batch)
    jargs = tuple(jnp.asarray(batch[k]) for k in ARGS)
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        losses, aux = jmodel.apply({"params": params}, *jargs, rngs={"sampling": key})
        return sum(v for k, v in losses.items() if k.startswith("loss")), (losses, aux)

    (_, (jlosses, jaux)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return dict(jmodel=jmodel, variables=variables, batch=batch, port=port_model(variables),
                jlosses={k: float(v) for k, v in jlosses.items()},
                jaux=jax.tree.map(np.asarray, jaux), jgrads=jgrads,
                draws=replay_refine_draws(jmodel, variables, key, 2))


def _apply(case, fn, *args):
    """JAX ``fn(module, *args)`` on the case's variables, jitted."""
    return jax.tree.map(np.asarray, jax.jit(lambda v, *a: case["jmodel"].apply(
        v, *a, method=fn))(case["variables"], *args))


def _rel(got, want, rel, what):
    want = np.asarray(want)
    close(np.asarray(got), want, rel * max(float(np.abs(want).max()), 1e-30), what=what)


# ------------------------------------------------------------------ modules


def test_resnet_pyramid_matches_jax(case):
    """C2..C5 of the port's ResNet (channel-last) vs the JAX module: 1e-5
    of each level's largest magnitude; shapes (B, H/4, W/4, 256) ...
    (B, H/32, W/32, 2048)."""
    img = case["batch"]["img"]
    want = _apply(case, lambda m, x: m.backbone(x), jnp.asarray(img))
    with torch.no_grad():
        got = case["port"].backbone(torch.from_numpy(img))
    assert [tuple(g.shape) for g in got] == [(2, 32, 32, 256), (2, 16, 16, 512), (2, 8, 8, 1024),
                                            (2, 4, 4, 2048)]
    for i, (a, b) in enumerate(zip(got, want)):
        _rel(a.numpy(), b, 1e-5, f"C{i + 2}")


@pytest.mark.parametrize("frozen_stages", [-1, 0, 1, 2])
def test_resnet_frozen_stages_get_no_gradient(frozen_stages):
    """The stem (any ``frozen_stages`` >= 0) and the stages up to
    ``frozen_stages`` take no gradient, every other conv does; the FrozenBN
    vectors are buffers, never parameters."""
    from attentionshift_torch.models.resnet import ResNet

    torch.manual_seed(0)
    model = ResNet(depths=(1, 1, 1, 1), frozen_stages=frozen_stages)
    outs = model(torch.randn(1, 64, 64, 3))
    sum(o.sum() for o in outs).backward()
    assert not any(".bn" in n or "downsample.1" in n for n, _ in model.named_parameters())
    assert len(list(model.buffers())) == 4 * (1 + 4 * 4)
    for name, p in model.named_parameters():
        stage = int(name[5]) if name.startswith("layer") else 0
        frozen = frozen_stages >= 0 and stage <= frozen_stages
        assert p.requires_grad is not frozen, name
        assert (p.grad is None) if frozen else float(p.grad.abs().sum()) > 0, name


def test_box_and_mask_heads_match_jax(case):
    """``StdBoxHead`` on (N, 7, 7, 256) and ``StdMaskHead`` on (N, 14, 14,
    256) RoI features vs the flax heads: 1e-5 of each output's largest
    magnitude. The mask head's deconv takes the flax ``ConvTranspose``
    kernel flipped by the converter; unflipped it would not match."""
    rs = np.random.RandomState(3)
    x7 = rs.randn(6, 7, 7, 256).astype(np.float32)
    x14 = rs.randn(6, 14, 14, 256).astype(np.float32)
    jcls, jreg = _apply(case, lambda m, x: m.bbox_head(x), jnp.asarray(x7))
    jmask = _apply(case, lambda m, x: m.mask_head(x), jnp.asarray(x14))
    port = case["port"]
    with torch.no_grad():
        cls, reg = port.bbox_head(torch.from_numpy(x7))
        mask = port.mask_head(torch.from_numpy(x14))
        up = port.mask_head.upsample.weight.clone()
        port.mask_head.upsample.weight.copy_(up.flip(2, 3))
        unflipped = port.mask_head(torch.from_numpy(x14))
        port.mask_head.upsample.weight.copy_(up)
    assert mask.shape == (6, 28, 28, 5)
    _rel(cls.numpy(), jcls, 1e-5, "cls")
    _rel(reg.numpy(), jreg, 1e-5, "reg")
    _rel(mask.numpy(), jmask, 1e-5, "mask logits")
    assert float(np.abs(unflipped.numpy() - jmask).max()) > 1e-2 * float(np.abs(jmask).max())


def test_level_routing_matches_jax(case):
    """``roi_levels`` equals mmdet's ``map_roi_levels`` as the JAX module
    writes it, exactly, on RoIs of every level (and clipped ones); the
    routed RoIAlign features, each RoI cropped from its own level only,
    equal the JAX module's crop-all-levels-then-select: 1e-5."""
    from attentionshift_torch.models.mask_rcnn import roi_levels

    rs = np.random.RandomState(4)
    side = np.concatenate([[4.0, 111.9, 112.0, 224.0, 447.9, 448.0, 900.0],
                           np.exp(rs.uniform(np.log(3), np.log(600), 25))])
    xy = rs.uniform(0, 100, (len(side), 2))
    boxes = np.concatenate([xy, xy + side[:, None] * rs.uniform(0.5, 1.5, (len(side), 2))],
                           1).astype(np.float32)
    wh = np.maximum(boxes[:, 2:4] - boxes[:, 0:2], 1e-6)
    want = np.clip(np.floor(np.log2(np.sqrt(wh[:, 0] * wh[:, 1]) / 224.0 + 1e-6)) + 4, 2, 5) - 2
    got = roi_levels(torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert set(got.tolist()) == {0, 1, 2, 3}
    rs_feats = np.random.RandomState(5)
    feats = [rs_feats.randn(2, H // s, W // s, 8).astype(np.float32) for s in (4, 8, 16, 32, 64)]
    bx = boxes[:32].reshape(2, 16, 4)
    jout = _apply(case, lambda m, f, b: m._roi_feats(f, b, 7), [jnp.asarray(f) for f in feats],
                  jnp.asarray(bx))
    tout = case["port"]._roi_feats([torch.from_numpy(f) for f in feats], torch.from_numpy(bx), 7)
    assert tuple(tout.shape) == (32, 7, 7, 8)
    _rel(tout.numpy(), jout, 1e-5, "routed roi feats")


def test_roi_align_batch_equals_per_image_calls():
    """RoIAlign over a batch of two maps equals, bitwise, two calls of one
    map each on that image's RoIs (it loops over the images; no RoI gathers
    a whole map)."""
    from attentionshift_torch.ops.roi_align import roi_align

    rs = np.random.RandomState(6)
    feats = torch.from_numpy(rs.randn(2, 16, 24, 40).astype(np.float32))
    img = np.asarray([1, 0, 1, 1, 0, 1, 0])
    xy = rs.uniform(-5, 120, (len(img), 2))
    boxes = np.concatenate([xy, xy + rs.uniform(1, 80, (len(img), 2))], 1)
    rois = torch.from_numpy(np.concatenate([img[:, None], boxes], 1).astype(np.float32))
    for size in (7, 14):
        both = roi_align(feats, rois, 0.25, output_size=size)
        for i in (0, 1):
            sel = torch.from_numpy(np.nonzero(img == i)[0])
            one = roi_align(feats[i:i + 1], torch.cat([torch.zeros(len(sel), 1), rois[sel, 1:]], 1),
                            0.25, output_size=size)
            assert torch.equal(both[sel], one), (size, i)


# -------------------------------------------------------------------- train


def test_train_forward_and_gradients_match_jax(case):
    """``make_refine_train_step`` on the batch of two with the JAX draws
    replayed: the loss dict and ``loss_total``, the sampled positives and
    RoIs, every trainable parameter's gradient, and no gradient for the
    frozen stem, ``layer1`` and FrozenBN vectors (JAX: exactly zero)."""
    from attentionshift_torch.train import TrainState, build_sgd_optimizer, make_refine_train_step

    port = port_model(case["variables"])
    opt = build_sgd_optimizer(port, steps_per_epoch=10)
    seen = {}
    fwd, step_opt = port.forward, opt.step

    def spy_forward(*a, **k):
        seen["losses"], seen["aux"] = fwd(*a, **k)
        return seen["losses"], seen["aux"]

    port.forward = spy_forward
    opt.step = lambda grads: (seen.update(grads=dict(zip(opt.names, grads))), step_opt(grads))[1]
    _, metrics = make_refine_train_step(port)(TrainState.create(port, opt), tensors(case["batch"]),
                                              draws=case["draws"])
    jl = case["jlosses"]
    assert set(metrics) == set(jl) | {"loss_total"}
    assert {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_mask"} <= set(jl)
    for name, ref in jl.items():
        close(float(metrics[name]), ref, LOSS_TOL * max(1.0, abs(ref)), what=name)
    total = sum(v for k, v in jl.items() if k.startswith("loss"))
    close(float(metrics["loss_total"]), total, LOSS_TOL * max(1.0, abs(total)), what="total")
    aux = seen["aux"]
    np.testing.assert_array_equal(aux["pos"].numpy(), case["jaux"]["pos"])
    assert aux["pos"].sum() > 0
    close(aux["rois"].detach().numpy(), case["jaux"]["rois"], **BOX_TOL, what="rois")

    want = torch_tree(case["jgrads"])
    grads = seen["grads"]
    trainable = {n for n, p in port.named_parameters() if p.requires_grad}
    assert set(grads) == trainable
    frozen = set(want) - trainable
    assert {"backbone.conv1.weight", "backbone.layer1.0.conv1.weight",
            "backbone.bn1.running_var"} <= frozen
    for name in frozen:
        assert float(want[name].abs().max()) == 0.0, name
    check_tree(grads, {n: want[n] for n in trainable}, GRAD_REL, "grad")
    assert all(float(g.abs().max()) > 0 for g in grads.values())


def test_faster_rcnn_variant_matches_jax(case):
    """``with_mask=False``: no mask head, no ``loss_mask``; the other losses
    equal the JAX module's on the same weights and draws (2e-4); full-box
    masks from ``simple_test`` and ``mask_test``."""
    from attentionshift_tpu.models.mask_rcnn import MaskRCNN as JMaskRCNN

    jmodel = JMaskRCNN(**KW, with_mask=False)
    params = {k: v for k, v in case["variables"]["params"].items() if k != "mask_head"}
    batch = case["batch"]
    key = jax.random.PRNGKey(7)
    jlosses = jax.jit(lambda p: jmodel.apply({"params": p}, *(jnp.asarray(batch[k]) for k in ARGS),
                                             rngs={"sampling": key})[0])(params)
    port = port_model({"params": params}, with_mask=False)
    assert not hasattr(port, "mask_head")
    losses, _ = port(*(tensors(batch)[k] for k in ARGS), draws=case["draws"])
    assert set(losses) == set(jlosses) and "loss_mask" not in losses
    for name, ref in jlosses.items():
        close(float(losses[name]), float(ref), LOSS_TOL * max(1.0, abs(float(ref))), what=name)
    t = tensors(batch)
    out = port.simple_test(t["img"], t["img_wh"])
    assert out.mask_probs.shape == (2, KW["test_max_per_img"], 28, 28)
    assert bool((out.mask_probs == 1.0).all())
    assert bool((port.mask_test(t["img"], out.dets.boxes, out.dets.labels) == 1.0).all())


# --------------------------------------------------------------------- test


@pytest.fixture(scope="module")
def stages(case):
    """The JAX module's ``simple_test``, ``rpn_test``, ``roi_test`` and
    ``mask_test`` on the batch, in one jitted function, and the port's."""
    t = tensors(case["batch"])
    rois = np.asarray([[[4, 6, 60, 70], [30, 20, 127, 90], [0, 0, 20, 24], [50, 50, 300, 260]]] * 2,
                      np.float32)
    rois[1] += 3.0
    labels = np.asarray([[0, 1, 2, 4], [3, 3, 1, 0]], np.int32)
    img, wh = jnp.asarray(case["batch"]["img"]), jnp.asarray(case["batch"]["img_wh"] * 0.9)

    def run(m, img, wh, rois, labels):
        return dict(simple=m.simple_test(img, wh), rpn=m.rpn_test(img),
                    roi=m.roi_test(img, rois, wh), mask=m.mask_test(img, rois, labels))

    want = _apply(case, run, img, wh, jnp.asarray(rois), jnp.asarray(labels))
    port = case["port"]
    twh = torch.from_numpy(case["batch"]["img_wh"] * 0.9)
    got = dict(simple=port.simple_test(t["img"], twh), rpn=port.rpn_test(t["img"]),
               roi=port.roi_test(t["img"], torch.from_numpy(rois), twh),
               mask=port.mask_test(t["img"], torch.from_numpy(rois), torch.from_numpy(labels)))
    return got, want


def test_simple_test_matches_jax(stages):
    """``simple_test``: labels and validity exactly, boxes 1e-3 px + 1e-5 of
    the coordinate, scores and mask probabilities 1e-4; detections exist."""
    got, want = stages
    g, w = got["simple"], want["simple"]
    np.testing.assert_array_equal(g.dets.valid.numpy(), w.dets.valid)
    assert g.dets.valid.sum() > 0
    np.testing.assert_array_equal(g.dets.labels.numpy(), w.dets.labels)
    close(g.dets.boxes.numpy(), w.dets.boxes, **BOX_TOL, what="boxes")
    close(g.dets.scores.numpy(), w.dets.scores, PROB_TOL, what="scores")
    close(g.mask_probs.numpy(), w.mask_probs, PROB_TOL, what="mask probs")


def test_aug_test_stages_match_jax(stages):
    """The stages ``AugTester`` drives: ``rpn_test`` (validity exactly,
    boxes as ``simple_test``'s, scores 1e-4), ``roi_test`` on given RoIs
    (softmax scores 1e-4, per-class boxes clipped to ``img_wh``) and
    ``mask_test`` (probabilities of the given labels 1e-4)."""
    got, want = stages
    np.testing.assert_array_equal(got["rpn"].valid.numpy(), want["rpn"].valid)
    close(got["rpn"].boxes.numpy(), want["rpn"].boxes, **BOX_TOL, what="proposals")
    close(got["rpn"].scores.numpy(), want["rpn"].scores, PROB_TOL, what="proposal scores")
    scores, boxes = got["roi"]
    assert tuple(boxes.shape) == (2, 4, 5, 4)
    close(scores.numpy(), want["roi"][0], PROB_TOL, what="roi scores")
    close(boxes.numpy(), want["roi"][1], **BOX_TOL, what="roi boxes")
    assert float(boxes[..., 2].max()) <= W * 0.9
    close(got["mask"].numpy(), want["mask"], PROB_TOL, what="mask_test")


# ------------------------------------------------------------ optimizer


def test_sgd_optimizer_matches_optax(case):
    """``build_sgd_optimizer`` against the JAX ``build_sgd_optimizer`` (optax
    ``add_decayed_weights`` -> ``trace`` -> ``scale_by_learning_rate``) over
    3 steps of the same random gradients in the warmup (5 warmup steps):
    the weight-decay mask with ``frozen_stages=1`` (the stem and ``layer1``
    get none, JAX leaves them unchanged under zero gradients), parameters
    to 1e-6 of their scale, the momentum trace to 1e-5."""
    import optax

    from attentionshift_torch.train import build_sgd_optimizer
    from attentionshift_torch.train.optim import weight_decay_mask
    from attentionshift_tpu.train.optim import build_sgd_optimizer as jbuild
    from attentionshift_tpu.train.optim import weight_decay_mask as jmask

    kw = dict(base_lr=0.05, momentum=0.9, weight_decay=1e-2, steps_per_epoch=2, warmup_iters=5,
              decay_epochs=(1,), frozen_stages=1)
    variables = {"params": case["variables"]["params"]}
    port = port_model(variables)
    trainable = {n for n, p in port.named_parameters() if p.requires_grad}
    names = torch_tree(variables["params"])
    # the same rule on both sides' names
    jm = torch_tree(jax.tree.map(lambda b, v: np.full(v.shape, b, np.float32),
                                 jmask(variables["params"], 1), variables["params"]))
    tm = weight_decay_mask(list(port.named_parameters()), frozen_stages=1)
    assert {n: bool(jm[n].flatten()[0]) for n in tm} == tm
    assert not tm["backbone.layer1.0.conv1.weight"] and tm["backbone.layer2.0.conv1.weight"]

    tx = jbuild(variables, **kw)
    jp, js = variables, tx.init(variables)
    opt = build_sgd_optimizer(port, **kw)
    rs = np.random.RandomState(8)

    def grad_leaf(path, v):
        # zero where the port has no trainable parameter (a frozen stage's
        # gradient is zero, the FrozenBN vectors are buffers)
        key = _port_key(tuple(p.key for p in path), v)
        return (rs.randn(*v.shape) * (key in trainable)).astype(np.float32)

    for _ in range(3):
        jg = jax.tree_util.tree_map_with_path(grad_leaf, jax.tree.map(np.asarray, jp["params"]))
        upd, js = tx.update({"params": jg}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = torch_tree(jg)
        opt.step([tg[n] for n in opt.names])
    assert opt.count == 3
    want = torch_tree(jp["params"])
    for name, p in port.named_parameters():
        scale = max(float(want[name].abs().max()), 1e-3)
        close(p.detach().numpy(), want[name].numpy(), 1e-6 * scale, what=name)
    for name in set(want) - trainable:
        np.testing.assert_array_equal(want[name].numpy(), names[name].numpy(), err_msg=name)
    trace = [x for x in jax.tree_util.tree_leaves(
        js, is_leaf=lambda x: isinstance(x, optax.TraceState)) if isinstance(x, optax.TraceState)]
    assert len(trace) == 1
    mom = torch_tree(trace[0].trace["params"])
    check_tree(dict(zip(opt.names, opt.mu)), {n: mom[n] for n in opt.names}, 1e-5, "trace")
    state = opt.state_dict()
    assert state["rule"] == "sgd" and state["nu"] is None and state["count"] == 3


def _port_key(path: tuple, value) -> str:
    """The port's state-dict key of one flax ``MaskRCNN`` param path."""
    from attentionshift_torch.convert import _leaf, _resnet_leaf

    if path[0] == "backbone":
        return "backbone." + _resnet_leaf(path[1:], value)[0]
    return _leaf(path, value)[0]


# ------------------------------------------------------ torchvision graft


def tv_state(depths=(1, 1, 1, 1), seed: int = 0) -> dict:
    """A random torchvision ResNet state dict (numpy, torchvision's names),
    with the classifier and ``num_batches_tracked`` that the graft drops
    and ``layer4``'s last conv missing (it keeps its init)."""
    rs = np.random.RandomState(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = (rs.randn(cout, cin, k, k) * 0.1).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1 + 0.1 * rs.randn(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rs.randn(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rs.randn(c)).astype(np.float32)
        sd[f"{name}.running_var"] = (0.5 + rs.rand(c)).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(7, np.int64)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, n in enumerate(depths):
        f = 64 * 2**s
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            conv(f"{p}.conv1", f, cin if b == 0 else 4 * f, 1)
            conv(f"{p}.conv2", f, f, 3)
            conv(f"{p}.conv3", 4 * f, f, 1)
            for c in (1, 2, 3):
                bn(f"{p}.bn{c}", f if c < 3 else 4 * f)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * f, cin, 1)
                bn(f"{p}.downsample.1", 4 * f)
        cin = 4 * f
    sd["fc.weight"] = rs.randn(1000, cin).astype(np.float32)
    sd["fc.bias"] = rs.randn(1000).astype(np.float32)
    del sd["layer4.0.conv3.weight"]
    return sd


def test_torchvision_graft_matches_jax(case):
    """``torchvision_resnet_params`` against the JAX package's on the same
    synthetic torchvision state dict: every grafted tensor exactly (BN
    running statistics into the FrozenBN buffers), ``fc`` dropped, the
    missing ``layer4.0.conv3`` left at its init; the result loads strictly."""
    from attentionshift_torch.convert import _resnet_leaf
    from attentionshift_torch.models.convert import torchvision_resnet_params
    from attentionshift_tpu.models.convert import torchvision_resnet_params as jgraft

    sd = tv_state()
    jbb = jgraft(sd, jax.tree.map(np.asarray, case["variables"]["params"]["backbone"]))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jbb)[0]:
        key, arr = _resnet_leaf(tuple(p.key for p in path), leaf)
        want[key] = arr
    port = port_model(case["variables"])
    before = {k: v.clone() for k, v in port.backbone.state_dict().items()}
    got = torchvision_resnet_params(sd, port.backbone.state_dict())
    assert set(got) == set(want) == set(before)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key].numpy(), arr, err_msg=key)
    assert torch.equal(got["layer4.0.conv3.weight"], before["layer4.0.conv3.weight"])
    np.testing.assert_array_equal(got["layer2.0.downsample.1.running_var"].numpy(),
                                  sd["layer2.0.downsample.1.running_var"])
    port.backbone.load_state_dict(got, strict=True)


# ------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def refine_json(tmp_path_factory):
    """An image and a COCO json with one RLE and one polygon instance."""
    from PIL import Image

    from attentionshift_torch.native import rle_encode, rle_to_string

    root = tmp_path_factory.mktemp("refine")
    (root / "imgs").mkdir()
    h, w = 96, 128
    rs = np.random.RandomState(0)
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(root / "imgs" / "0.jpg")
    m = np.zeros((h, w), np.uint8)
    m[20:60, 30:90] = 1
    m[35:45, 50:70] = 0
    anns = [dict(id=1, image_id=0, category_id=4, bbox=[30, 20, 60, 40], iscrowd=0,
                 segmentation=dict(size=[h, w], counts=rle_to_string(rle_encode(m)).decode())),
            dict(id=2, image_id=0, category_id=9, bbox=[10, 10, 30, 30], iscrowd=0,
                 segmentation=[[10, 10, 40, 10, 40, 40, 25, 30, 10, 40]])]
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=[dict(id=0, file_name="0.jpg", width=w, height=h)],
                                   annotations=anns,
                                   categories=[dict(id=4, name="a"), dict(id=9, name="b")])))
    return dict(ann_file=str(ann), img_prefix=str(root / "imgs"), mask=m)


@pytest.mark.parametrize("seed", [0, 3])
def test_refine_dataset_and_pipeline_match_jax(refine_json, seed):
    """``InstanceCocoDataset`` (RLE and polygon) and ``RefineTrainPipeline``
    (flip, keep-ratio resize, normalise, pad; boxes and masks at
    ``mask_stride``) against the JAX package's: every output exactly, for
    two rng seeds (one flips, one does not)."""
    from attentionshift_torch.data.refine import InstanceCocoDataset, RefineTrainPipeline
    from attentionshift_tpu.data.refine import InstanceCocoDataset as JDataset
    from attentionshift_tpu.data.refine import RefineTrainPipeline as JPipeline

    ds = InstanceCocoDataset(refine_json["ann_file"], refine_json["img_prefix"], repeat=2)
    jds = JDataset(refine_json["ann_file"], refine_json["img_prefix"], repeat=2)
    assert len(ds) == len(jds) == 2
    s, js = ds[1], jds[1]
    assert sorted(s) == sorted(js)
    for k in ("img", "boxes", "labels", "masks"):
        np.testing.assert_array_equal(s[k], js[k], err_msg=k)
    assert s["masks"].shape == (2, 96, 128) and s["masks"][0].sum() == refine_json["mask"].sum()
    np.testing.assert_array_equal(s["labels"], [0, 1])
    kw = dict(scales=[(96, 160), (64, 100)], max_gt=4, mask_stride=4, flip_ratio=0.5)
    out = RefineTrainPipeline(**kw)(s, np.random.RandomState(seed))
    jout = JPipeline(**kw)(js, np.random.RandomState(seed))
    assert sorted(out) == sorted(jout)
    for k in out:
        if k == "bucket":
            assert out[k] == jout[k]
        else:
            assert out[k].dtype == jout[k].dtype, k
            np.testing.assert_array_equal(out[k], jout[k], err_msg=k)
    assert out["gt_masks"].shape == (4, out["img"].shape[0] // 4, out["img"].shape[1] // 4)
    assert out["gt_valid"].tolist() == [True, True, False, False]
