"""The learning tools of the port against the JAX package's, on the CPU.

``attentionshift_torch.tools.analysis.learning_check`` and
``attentionshift_torch.tools.debug_overfit`` twin the JAX tools of the
same names. Their corpora are drawn with numpy and must equal the JAX
tools' bit for bit; the scoring (pseudo-label IoUs, the mask paste and
mAP of the detection chain, the dagger loop's best mask IoU) must give
the JAX tool's numbers on the same predictions, computed here through
``attentionshift_tpu.eval``. The JAX tools run a full ViT-S at 512x512 and
build their model when imported, so their functions are taken from the
source and their whole runs are not repeated here (the train step's
parity is pinned by ``test_torch_train_step_*.py``). Each twin's ``main``
runs once on the CPU with a narrow model.
"""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from attentionshift_torch.tools import debug_overfit  # noqa: E402
from attentionshift_torch.tools.analysis import learning_check as lc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the twins' main runs: a ViT of 64 channels, 4 blocks (the FPN taps four),
# 2 heads; narrow RPN/FPN and few proposals, so that a step at 512x512
# takes seconds on one CPU thread
NARROW = dict(num_classes=20, embed_dim=64, depth=4, num_heads=2, img_size=224, point_tokens=100,
              cam_layer=2, max_gt=8, out_indices=(0, 1, 2, 3), rpn_channels=32,
              num_proposals=48, rpn_nms_pre=200, rcnn_samples=32, mask_sample_cap=16,
              test_max_per_img=20)


def jax_functions(rel: str, names: tuple, **scope) -> dict:
    """The module-level functions ``names`` of the JAX tool ``rel``, from
    its source, in a namespace holding numpy and ``scope``."""
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = dict(np=np, **scope)
    exec(compile(ast.Module(body=body, type_ignores=[]), rel, "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def jlc():
    return jax_functions("tools/analysis/learning_check.py", ("make_sample", "box_iou"),
                         B=1, H=512, W=512, G=8)


@pytest.mark.parametrize("seed", [0, 100])
@pytest.mark.parametrize("corpus", ["discs", "lobes", "lobes-tex"])
def test_make_sample_bitwise(jlc, corpus, seed):
    """Three samples in a row from one generator: every array bitwise equal
    to the JAX tool's, and the generators left in the same state."""
    ra, rb = np.random.RandomState(seed), np.random.RandomState(seed)
    for i in range(3):
        got, want = lc.make_sample(ra, i, corpus), jlc["make_sample"](rb, i, corpus)
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert ra.randint(1 << 30) == rb.randint(1 << 30)


def test_debug_overfit_corpus_bitwise():
    """``debug_overfit``'s 8 samples, drawn from one module-level generator
    in the JAX tool and from one passed generator in the twin."""
    rng = np.random.RandomState(0)
    ns = jax_functions("tools/debug_overfit.py", ("make_sample",), H=512, W=512, G=8, rng=rng)
    want = [ns["make_sample"](i) for i in range(8)]
    mine = np.random.RandomState(0)
    got = [debug_overfit.make_sample(mine, i) for i in range(8)]
    for g, w in zip(got, want):
        for a, b in zip(g, w, strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_box_iou_equal(jlc):
    rs = np.random.RandomState(3)
    for _ in range(200):
        a = np.sort(rs.rand(2, 2) * 100, 0).T.reshape(-1)[[0, 2, 1, 3]]
        b = np.sort(rs.rand(2, 2) * 100, 0).T.reshape(-1)[[0, 2, 1, 3]]
        assert lc.box_iou(a, b) == jlc["box_iou"](a, b)
    assert lc.box_iou([0, 0, 1, 1], [2, 2, 3, 3]) == jlc["box_iou"]([0, 0, 1, 1], [2, 2, 3, 3]) == 0


@pytest.fixture(scope="module")
def fixed_outputs(jlc):
    """Held-out lobes samples and fixed synthetic model outputs for them:
    pseudo boxes and masks near the true ones, and detections (boxes, 28x28
    probabilities, labels, scores) with a hit, a shifted box, a wrong class
    and an image without a detection."""
    rs = np.random.RandomState(11)
    held = [lc.make_sample(np.random.RandomState(100 + i), i, "lobes") for i in range(4)]
    seeds, dets = [], []
    for i, s in enumerate(held):
        tmasks, tboxes = s[4], s[5]
        boxes = np.zeros((8, 4), np.float32)
        boxes[:2] = tboxes + rs.randn(2, 4).astype(np.float32) * 8
        masks = np.zeros((8, 512, 512), np.uint8)
        masks[:2] = np.roll(tmasks, rs.randint(-12, 12), axis=2)
        seeds.append((boxes, masks))
        if i == 3:
            dets.append((np.zeros((0, 4), np.float32), np.zeros((0, 28, 28), np.float32),
                         np.zeros(0, np.int32), np.zeros(0, np.float32)))
            continue
        k = 4
        db = np.concatenate([tboxes + rs.randn(2, 4).astype(np.float32) * 3,
                             tboxes[:1] + 60, rs.rand(1, 4).astype(np.float32) * 40 + [0, 0, 60, 60]])
        probs = np.clip(rs.rand(k, 28, 28).astype(np.float32) * 0.6 + 0.3, 0, 1)
        labels = np.asarray(list(s[2][:2]) + [s[2][0], (s[2][1] + 1) % 20], np.int32)
        scores = np.asarray([0.9, 0.7, 0.5, 0.3], np.float32)
        dets.append((db.astype(np.float32), probs, labels, scores))
    return held, seeds, dets


def test_scoring_matches_jax_eval(jlc, fixed_outputs):
    """``pseudo_ious``, ``det_map_of`` and ``det_mask_iou_of`` against the
    JAX tool's lines run through ``attentionshift_tpu.eval`` on the same
    predictions, at 1e-6."""
    from attentionshift_tpu.eval.masks import paste_masks_np
    from attentionshift_tpu.eval.mean_ap_segm import eval_map_segm

    held, seeds, dets = fixed_outputs
    bious, mious = [], []
    for (boxes, masks), (_, _, _, _, tmasks, tboxes) in zip(seeds, held):
        for gi in range(2):
            bious.append(jlc["box_iou"](boxes[gi], tboxes[gi]))
            pm = masks[gi] > 0.5
            inter = (pm & tmasks[gi]).sum()
            union = pm.sum() + tmasks[gi].sum() - inter
            mious.append(float(inter / max(union, 1)))
    got = lc.pseudo_ious(seeds, held)
    assert got == pytest.approx((np.mean(bious), np.mean(mious)), abs=1e-6)
    assert 0.2 < got[0] < 0.99 and 0.2 < got[1] < 0.99

    pm, plb, psc, ious = [], [], [], []
    for (boxes, probs, labels, scores), s in zip(dets, held):
        masks = (paste_masks_np(probs, boxes, 512, 512) > 0.5 if len(boxes)
                 else np.zeros((0, 512, 512), bool))
        pm.append(masks)
        plb.append(labels)
        psc.append(scores)
        for tm in s[4]:
            if not len(boxes):
                ious.append(0.0)
                continue
            inter = (masks & tm[None]).sum(axis=(1, 2))
            union = masks.sum(axis=(1, 2)) + tm.sum() - inter
            ious.append(float((inter / np.maximum(union, 1)).max()))
    gm = [s[4].astype(bool) for s in held]
    glb = [np.asarray(s[2][:2], np.int32) for s in held]
    want = {}
    for thr, name in ((0.25, "mAP25"), (0.5, "mAP50"), (0.75, "mAP75")):
        want[name] = round(float(eval_map_segm(pm, plb, psc, gm, glb, num_classes=20,
                                               iou_thresh=thr)[0]), 4)
    want["n_det"] = 12
    got = lc.det_map_of(dets, held, 20)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got, want)
    assert 0.0 < got["mAP25"] < 1.0
    assert lc.det_mask_iou_of(dets, held) == pytest.approx(np.mean(ious), abs=1e-6)


def _narrow(args, device):
    from attentionshift_torch.models import AttnShiftDetector

    return AttnShiftDetector(device=device, **NARROW).init_weights(0)


def _narrow_rcnn(device):
    from attentionshift_torch.models.mask_rcnn import MaskRCNN

    return MaskRCNN(num_classes=20, depths=(1, 1, 1, 1), frozen_stages=0, rpn_channels=32,
                    num_proposals=48, rpn_nms_pre=200, rcnn_samples=32, mask_sample_cap=16,
                    test_max_per_img=8, device=device).init_weights(1)


def test_learning_check_main_on_cpu(tmp_path, monkeypatch, capsys):
    """Every branch of the twin in one run on the CPU (``--no-pallas``
    accepted there): 2 steps on the lobes corpus, milestones 0 and 2 with
    the detection chain, the curve file, a bf16 ``--save-ckpt`` and a
    2-step dagger loop. The rows are well-formed and finite, the printed
    lines are the rows, the curve and the summary."""
    from attentionshift_torch.train import restore_params

    monkeypatch.setattr(lc, "build_model", _narrow)
    monkeypatch.setattr(lc, "build_rcnn", _narrow_rcnn)
    curve, ckpt = tmp_path / "curve.jsonl", tmp_path / "params"
    summary = lc.main(["--device", "cpu", "--no-pallas", "--steps", "2", "--milestones", "0", "2",
                       "--train-images", "2", "--eval-images", "1", "--corpus", "lobes",
                       "--det-eval", "--curve-out", str(curve), "--save-ckpt", str(ckpt),
                       "--save-dtype", "bfloat16", "--dagger", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(x) for x in curve.read_text().splitlines()]
    # compared as JSON text: the step-0 loss is NaN (no step has run)
    assert json.dumps(summary["table"]) == json.dumps(rows) and [r["step"] for r in rows] == [0, 2]
    keys = ["step", "loss", "pseudo_box_iou", "pseudo_mask_iou", "mAP25", "mAP50", "mAP75", "n_det"]
    for r in rows:
        assert list(r) == keys
        assert all(0.0 <= r[k] <= 1.0 for k in keys[2:7]) and 0 <= r["n_det"] <= 20
    assert np.isnan(rows[0]["loss"]) and np.isfinite(rows[1]["loss"])
    assert lines[:2] == curve.read_text().splitlines()
    assert lines[2] == f"saved trained params to {ckpt}"
    dagger = summary["dagger"]
    assert sorted(dagger) == ["dagger_det_mask_iou", "final_loss", "flagship_det_mask_iou", "steps"]
    assert dagger["steps"] == 2 and np.isfinite(dagger["final_loss"])
    assert json.loads(lines[3]) == dict(dagger_step=0, loss=dagger["final_loss"])
    assert json.loads(lines[4]) == dagger and lines[-1] == json.dumps(summary)
    saved = restore_params(str(ckpt))
    assert saved["backbone.cls_token"].dtype == torch.bfloat16 and len(saved) == len(
        _narrow(None, torch.device("cpu")).state_dict())
    from test_torch_support import drop_weights

    drop_weights(ckpt)


def test_learning_check_refuses_no_pallas_on_the_card(monkeypatch):
    """``--no-pallas`` on a CUDA device raises before anything is built:
    the port has no plain path there (the device is faked: this machine
    has no card)."""
    from attentionshift_torch import device

    monkeypatch.setattr(device, "resolve_device", lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(lc, "build_model", lambda *a: pytest.fail("built a model"))
    with pytest.raises(ValueError, match="no plain path on the card"):
        lc.main(["--no-pallas", "--steps", "1"])


def test_debug_overfit_main_on_cpu(monkeypatch, capsys):
    """The twin's loop and checks on the CPU at 16 steps, means over 8 at
    each end (each end sees all 8 images once, and the lr warmup is over
    by step 10): the losses printed and returned, finite, and the check's
    verdict printed last."""
    monkeypatch.setattr(debug_overfit, "build_model", lambda d: _narrow(None, d))
    monkeypatch.setattr(debug_overfit, "STEPS", 16)
    monkeypatch.setattr(debug_overfit, "WINDOW", 8)
    res = debug_overfit.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "OK: the model learns on cpu" and out[2].startswith("16 steps in ")
    assert {"loss_total", "loss_point_cls"} <= res["first"].keys() == res["last"].keys()
    assert all(np.isfinite(v) for v in [*res["first"].values(), *res["last"].values()])


class _Built(Exception):
    """Raised by the optimizer spy: the tool got as far as its optimizer."""


@pytest.mark.parametrize("tool", ["learning_check", "debug_overfit"])
def test_learning_tools_take_the_jax_tools_optimizer(tool, monkeypatch):
    """The JAX tools hand ``build_optimizer`` their whole variables dict, so
    every leaf's layer id is the last one and every lr scale 1.0
    (``attentionshift_tpu/train/optim.py:47-48``); the twins get the same
    scales through ``layer_decay=1.0``. The twins' flagship (ViT-S, built
    here on the CPU) starts from the JAX modules' init rules: q, k, v at
    std 1/sqrt(384), flax's ``lecun_normal``."""
    from attentionshift_torch import train

    seen, real = {}, train.build_optimizer

    def spy(model, **kw):
        seen.update(kw, params=dict(model.named_parameters()))
        raise _Built

    monkeypatch.setattr(train, "build_optimizer", spy)
    with pytest.raises(_Built):
        if tool == "learning_check":
            lc.main(["--device", "cpu", "--steps", "0", "--train-images", "1",
                     "--eval-images", "1"])
        else:
            debug_overfit.main(["--device", "cpu"])
    assert seen["layer_decay"] == 1.0
    opt = real(list(seen["params"].items()), layer_decay=1.0, depth=12)
    assert set(opt.scales) == {1.0}
    qkv = seen["params"]["backbone.blocks.0.attn.qkv.weight"]
    assert abs(float(qkv.std()) * 384 ** 0.5 - 1.0) < 0.02
    assert not seen["params"]["backbone.cls_token"].any()


def test_fpn1_bn_statistics_divergence_pinned():
    """Divergence on purpose (ROADMAP section C): the JAX tools' optimizer
    tree holds ``batch_stats`` too, so ``fpn1_bn``'s running mean and
    variance get Adam moments at lr scale 1.0 (their gradient is zero, so
    the update is too); the port keeps them as buffers, outside the
    optimizer, and a step leaves them as they are."""
    import jax
    import jax.numpy as jnp

    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.train import TrainState, build_optimizer, make_train_step
    from attentionshift_tpu.models.detector import AttnShiftDetector as JDet
    from attentionshift_tpu.train.optim import build_optimizer as jbuild
    from attentionshift_tpu.train.optim import lr_scale_tree

    jkw = {k: v for k, v in NARROW.items() if k != "test_max_per_img"}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: JDet(use_remat=False, **jkw).init(
        {"params": key, "sampling": key, "dropout": key}, jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 8, 2)), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), bool),
        jnp.asarray([[64.0, 64.0]])))
    assert set(jax.tree.leaves(lr_scale_tree(shapes, 0.75, 4))) == {1.0}
    state = jax.eval_shape(jbuild(shapes, depth=4, accumulate_steps=1).init, shapes)
    paths = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(state)}
    assert any("'batch_stats']['backbone']['fpn1_bn']['mean']" in p for p in paths)

    model = AttnShiftDetector(device="cpu", **NARROW).init_weights(0)
    opt = build_optimizer(model, layer_decay=1.0, depth=4, accumulate_steps=1,
                          steps_per_epoch=100, warmup_iters=0)
    assert not [n for n in opt.names if "fpn1_bn.running" in n]
    stats = {k: v.clone() for k, v in model.named_buffers() if "fpn1_bn" in k}
    assert sorted(stats) == ["backbone.fpn1_bn.running_mean", "backbone.fpn1_bn.running_var"]
    rng = np.random.RandomState(0)
    img, pts, lbl, val = lc.make_sample(rng, 0, "lobes")[:4]
    batch = dict(zip(("img", "gt_points", "gt_labels", "gt_valid"),
                     (torch.from_numpy(a[None]) for a in (img, pts, lbl, val))),
                 img_wh=torch.tensor([[512.0, 512.0]]))
    state = TrainState.create(model, opt)
    make_train_step(model)(state, batch, generator=torch.Generator().manual_seed(0))
    assert opt.count == 1
    assert all(torch.equal(v, dict(model.named_buffers())[k]) for k, v in stats.items())


def test_seed_report_on_a_saved_checkpoint(tmp_path, monkeypatch, capsys):
    """``seed_report`` loads a ``--save-ckpt`` file of the twin and reports
    each held-out instance: a candidate box per captured layer, the chosen
    layer among them, IoUs in [0, 1], and a summary over the rows."""
    from attentionshift_torch.tools.analysis import seed_report

    monkeypatch.setattr(lc, "build_model", _narrow)
    ckpt = tmp_path / "params"
    lc.main(["--device", "cpu", "--steps", "0", "--milestones", "0", "--train-images", "1",
             "--eval-images", "1", "--corpus", "lobes", "--save-ckpt", str(ckpt)])
    capsys.readouterr()
    summary = seed_report.main([str(ckpt), "--eval-images", "2", "--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines[-1] == summary and summary["n"] == 4 == len(lines) - 1
    for row in lines[:-1]:
        assert len(row["layer_box_iou"]) == NARROW["cam_layer"] > row["layer"] >= 0
        assert 0.0 <= row["box_iou"] <= 1.0 and 0.0 <= row["mask_iou"] <= 1.0
        assert 0.0 < row["above_thr"] <= 1.0
    from test_torch_support import drop_weights

    drop_weights(ckpt)
