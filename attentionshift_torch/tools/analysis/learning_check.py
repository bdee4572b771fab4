"""End-to-end learning check: pseudo-label and detection quality against the
known masks of a synthetic corpus. The port's twin of
``tools/analysis/learning_check.py``.

    python -m attentionshift_torch.tools.analysis.learning_check [--steps 600] \\
        [--eval-images 8] [--train-images 8] [--corpus discs|lobes|lobes-tex] \\
        [--milestones 0 250 ...] [--det-eval] [--curve-out F.jsonl] [--f32] \\
        [--save-ckpt F [--save-dtype bfloat16]] [--dagger N] [--init-seed S] [--device cpu] \\
        [--no-pallas]

On the blob corpus the true instance masks are known, so the quality of
the pseudo-label engine is measured directly: the flagship model
(ViT-S, 384 wide, 12 blocks, 6 heads, 100 point tokens, 7 captured
layers, bf16) trains on ``--train-images`` images at 512x512, and at each
milestone the tool reports, on held-out images, the IoU of the pseudo
boxes and pseudo masks against the true blobs (``score``) and, with
``--det-eval``, the mask mAP of the detector's own detections at IoU
0.25 / 0.5 / 0.75 (``simple_test`` -> ``eval/masks.py::paste_masks_np``
-> ``eval_map_segm``; ``det_map``). One JSON line per milestone, appended
to ``--curve-out`` when given, and a summary line at the end.

The corpus (``make_sample``) draws with numpy exactly as the JAX tool
does, so both tools train and score on the same images. Every other draw
comes from a ``torch.Generator`` seeded where the JAX tool seeds a key:
train step ``it`` from 42 + it, the scoring from 7, the Mask R-CNN's init
from 1 and its step ``it`` from 1000 + it. Torch cannot replay JAX's
streams, and the two packages' initialisations differ, so the two tools'
trajectories differ by design: compare curves, not rows.

The model starts from ``init_weights(0)`` (``--init-seed`` picks another
seed), which draws by the JAX modules' rules (flax's ``lecun_normal`` kernels), as the JAX tool's
``model.init`` does. The optimizer is ``train.build_optimizer`` with every
lr scale 1.0 (``layer_decay=1.0``), the scales the JAX tool gets by
handing ``build_optimizer`` its whole variables dict; unlike the JAX
tool, the port keeps ``fpn1_bn``'s running statistics as buffers, outside
the optimizer (ROADMAP section C). The model's parameters are f32 masters and it
computes in its dtype, which is what the JAX tool's ``cast_f32`` gives
its scoring. ``--save-ckpt`` writes a ``train.save_params`` file.
``--dagger N`` retrains a Mask R-CNN (ResNet depths 2/2/2/2, f32: the
port's Mask R-CNN runs in f32 only) for N steps on the flagship's final
pseudo labels of the train corpus, then scores both models' detections
by their best mask IoU per true instance.

The model runs on the card unless ``--device cpu`` asks for the plain
PyTorch path (f32). The port has no plain path on the card:
``--no-pallas`` (the JAX tool's switch to plain XLA) is accepted on the
CPU, where the plain versions run anyway, and raises on a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

H, W, G = 512, 512, 8


def make_sample(rng, i, corpus: str = "discs"):
    """Blob image + point supervision + TRUE masks/boxes for scoring.

    ``corpus``: ``discs`` (uniform circles, the historical fixture
    recipe) or ``lobes`` (two overlapping differently-toned lobes per
    instance — gives the mean-shift engine real part structure, so
    trained features can pass the 0.85 fg-occupancy prototype filter;
    VERDICT r4 #5)."""
    img = rng.randn(H, W, 3).astype(np.float32) * 0.1
    yy, xx = np.mgrid[:H, :W]
    if corpus == "lobes-tex":
        # textured background (low-frequency color fields): forces the
        # backbone to learn locally-discriminative embeddings, which is
        # what the 0.85 fg-occupancy prototype filter needs — on the
        # flat corpora the prototypes' >0.8-similarity regions spread
        # over the (self-similar) background and every prototype is
        # rejected (round-5 probe: occupancy ~0.1 flat, ~0.7 textured
        # with an OOD checkpoint)
        for c in range(3):
            f1, f2 = rng.rand(2) * 0.02 + 0.005
            img[..., c] += 0.6 * np.sin(2 * np.pi * (f1 * xx + f2 * yy + rng.rand()))
    pts, lbls, masks, boxes = [], [], [], []
    for j in range(2):
        cx, cy = rng.randint(100, 412), rng.randint(100, 412)
        r = rng.randint(40, 90)
        blob = ((xx - cx) ** 2 + (yy - cy) ** 2) < r * r
        color = np.zeros(3)
        color[(i + j) % 3] = 2.5
        img[blob] += color
        if corpus in ("lobes", "lobes-tex"):
            dx = int(r * 0.8)
            lobe2 = ((xx - cx - dx) ** 2 + (yy - cy) ** 2) < (r * 0.7) ** 2
            img[lobe2] += np.roll(color, 1) * 0.8  # distinct part tone
            if corpus == "lobes-tex":
                # strong high-frequency texture, distinct per lobe
                tex = np.sin(2 * np.pi * 0.08 * (
                    xx * np.cos(rng.rand() * 3) + yy * np.sin(rng.rand() * 3)))
                img[blob] += (1.2 * tex[..., None] * color[None, :])[blob]
                tex2 = np.sin(2 * np.pi * 0.15 * (xx + yy))
                img[lobe2] += (0.9 * tex2[..., None] * np.roll(color, 1)[None, :])[lobe2]
            blob = blob | lobe2
        pts.append([cx, cy])
        lbls.append((i + j) % 3)
        masks.append(blob)
        bx = np.where(blob.any(0))[0]
        by = np.where(blob.any(1))[0]
        boxes.append([bx.min(), by.min(), bx.max() + 1, by.max() + 1])
    g_pts = np.zeros((G, 2), np.float32); g_pts[:2] = pts
    g_lbl = np.zeros((G,), np.int32); g_lbl[:2] = lbls
    g_val = np.zeros((G,), bool); g_val[:2] = True
    return (img, g_pts, g_lbl, g_val, np.stack(masks),
            np.asarray(boxes, np.float32))


def box_iou(a, b):
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    ar = lambda r: max(0.0, r[2] - r[0]) * max(0.0, r[3] - r[1])
    return inter / max(ar(a) + ar(b) - inter, 1e-6)


# ---------------------------------------------------------------- scoring
# Each takes the models' outputs as numpy, so that a test can hold it
# against the JAX package's eval on fixed predictions.


def pseudo_ious(seeds, held) -> tuple[float, float]:
    """Mean pseudo-box and pseudo-mask IoU of the two true instances of each
    held-out sample; ``seeds``: per sample (boxes (G, 4), masks (G, H, W))."""
    bious, mious = [], []
    for (boxes, masks), (_, _, _, _, tmasks, tboxes) in zip(seeds, held, strict=True):
        for gi in range(2):
            bious.append(box_iou(boxes[gi], tboxes[gi]))
            pm = masks[gi] > 0.5
            inter = (pm & tmasks[gi]).sum()
            union = pm.sum() + tmasks[gi].sum() - inter
            mious.append(float(inter / max(union, 1)))
    return float(np.mean(bious)), float(np.mean(mious))


def _pasted(probs, boxes):
    if len(boxes) == 0:
        return np.zeros((0, H, W), bool)
    from ...eval.masks import paste_masks_np

    return paste_masks_np(probs, boxes, H, W) > 0.5


def det_map_of(dets, held, num_classes: int = 20) -> dict:
    """Mask mAP at IoU 0.25 / 0.5 / 0.75 and the detection count;
    ``dets``: per sample the valid detections (boxes (K, 4), mask
    probabilities (K, 28, 28), labels (K,), scores (K,))."""
    from ...eval.mean_ap_segm import eval_map_segm

    pm = [_pasted(probs, boxes) for boxes, probs, _, _ in dets]
    plb = [np.asarray(lb, np.int32) for _, _, lb, _ in dets]
    psc = [np.asarray(sc, np.float32) for _, _, _, sc in dets]
    gm = [s[4].astype(bool) for s in held]
    # gt labels: the first two (valid) slots of each sample
    glb = [np.asarray(s[2][:2], np.int32) for s in held]
    res = {}
    for thr, name in ((0.25, "mAP25"), (0.5, "mAP50"), (0.75, "mAP75")):
        mAP, _, _ = eval_map_segm(pm, plb, psc, gm, glb, num_classes=num_classes, iou_thresh=thr)
        res[name] = round(float(mAP), 4)
    res["n_det"] = int(sum(len(x) for x in plb))
    return res


def det_mask_iou_of(dets, held) -> float:
    """Mean over the true instances of the best IoU of any detection's
    pasted mask (class-agnostic): the localisation of the detector itself,
    as opposed to ``pseudo_ious``'s pseudo-label quality."""
    ious = []
    for (boxes, probs, _, _), (_, _, _, _, tmasks, _) in zip(dets, held, strict=True):
        if len(boxes) == 0:
            ious += [0.0] * len(tmasks)
            continue
        pasted = _pasted(probs, boxes)
        for tm in tmasks:
            inter = (pasted & tm[None]).sum(axis=(1, 2))
            union = pasted.sum(axis=(1, 2)) + tm.sum() - inter
            ious.append(float((inter / np.maximum(union, 1)).max()))
    return float(np.mean(ious))


# ---------------------------------------------------------------- models


def build_model(args, device):
    """The flagship detector of the JAX tool, seeded init (``--init-seed``,
    0 by default)."""
    import torch

    from ...models import AttnShiftDetector

    dtype = torch.float32 if args.f32 or device.type == "cpu" else torch.bfloat16
    return AttnShiftDetector(
        num_classes=20, embed_dim=384, depth=12, num_heads=6, img_size=224,
        point_tokens=100, cam_layer=7, max_gt=G, use_remat=True,
        num_proposals=512, rpn_nms_pre=1000, rcnn_samples=256, mask_sample_cap=64,
        dtype=dtype, device=device,
    ).init_weights(getattr(args, "init_seed", 0))


def build_rcnn(device):
    """The dagger loop's Mask R-CNN (ResNet depths 2/2/2/2, nothing
    frozen), seeded init (seed 1)."""
    from ...models.mask_rcnn import MaskRCNN

    return MaskRCNN(num_classes=20, depths=(2, 2, 2, 2), frozen_stages=0, num_proposals=256,
                    rpn_nms_pre=512, rcnn_samples=128, mask_sample_cap=32, test_max_per_img=8,
                    device=device).init_weights(1)


def _on(device, *arrays):
    """numpy arrays -> tensors with a leading batch axis on ``device``."""
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a)[None]).to(device) for a in arrays]


def _seed_outputs(model, samples, wh):
    """``seed_pseudo_gt`` on each sample, its draws from seed 7 -> numpy
    (boxes (G, 4), masks (G, H, W))."""
    import torch

    outs = []
    for img, pts, lbl, val, *_ in samples:
        gen = torch.Generator(device=model.device).manual_seed(7)
        out = model.seed_pseudo_gt(*_on(model.device, img, pts, lbl, val), wh, generator=gen)
        outs.append((out["pseudo_gt_bboxes"][0].float().cpu().numpy(),
                     out["pseudo_gt_masks"][0].cpu().numpy()))
    return outs


def _test_outputs(model, samples, wh):
    """``simple_test`` on each sample -> numpy valid detections (boxes,
    mask probabilities, labels, scores)."""
    dets = []
    for s in samples:
        (img,) = _on(model.device, s[0])
        o = model.simple_test(img, wh)
        v = o.dets.valid[0].cpu().numpy()
        dets.append((o.dets.boxes[0].float().cpu().numpy()[v],
                     o.mask_probs[0].float().cpu().numpy()[v],
                     o.dets.labels[0].cpu().numpy().astype(np.int32)[v],
                     o.dets.scores[0].float().cpu().numpy()[v]))
    return dets


def score(model, held, wh) -> tuple[float, float]:
    return pseudo_ious(_seed_outputs(model, held, wh), held)


def det_map(model, held, wh) -> dict:
    """The eval chain: simple_test -> paste -> eval_map_segm."""
    return det_map_of(_test_outputs(model, held, wh), held, model.num_classes)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train the flagship on blobs and score what it learns.")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--eval-images", type=int, default=8)
    ap.add_argument("--milestones", type=int, nargs="*", default=None)
    ap.add_argument("--no-pallas", action="store_true",
                    help="plain PyTorch kernels: the CPU's path; raises on a CUDA device")
    ap.add_argument("--f32", action="store_true", help="float32 model")
    ap.add_argument("--train-images", type=int, default=8,
                    help="size of the synthetic training corpus")
    ap.add_argument("--corpus", default="discs", choices=["discs", "lobes", "lobes-tex"],
                    help="instance shape: uniform discs or two-lobed part-structured instances")
    ap.add_argument("--det-eval", action="store_true",
                    help="at each milestone also run the detection chain (simple_test -> mask "
                         "paste -> eval_map_segm) on the held-out corpus and report det mask "
                         "mAP@0.25/0.5/0.75")
    ap.add_argument("--curve-out", default=None, metavar="JSONL",
                    help="append one JSON line per milestone to this file")
    ap.add_argument("--save-ckpt", default=None, metavar="FILE",
                    help="save the trained parameters and buffers (train.save_params)")
    ap.add_argument("--save-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="floating dtype of the tensors --save-ckpt writes")
    ap.add_argument("--dagger", type=int, default=0, metavar="N",
                    help="after flagship training, retrain a Mask R-CNN on its pseudo labels for "
                         "N steps, then score both models' detections held-out")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="seed of the flagship's init (init_weights); the JAX tool's key is 0")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns the summary it printed last."""
    import torch

    from ...device import resolve_device
    from ...train import TrainState, build_optimizer, make_train_step, save_params

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.no_pallas and device.type == "cuda":
        raise ValueError("--no-pallas: the port has no plain path on the card; the plain "
                         "PyTorch versions run with --device cpu")
    milestones = args.milestones or sorted({0, args.steps // 8, args.steps // 2, args.steps})

    model = build_model(args, device)
    rng = np.random.RandomState(0)
    train_data = [make_sample(rng, i, args.corpus) for i in range(args.train_images)]
    held = [make_sample(np.random.RandomState(100 + i), i, args.corpus)
            for i in range(args.eval_images)]
    wh = torch.tensor([[float(W), float(H)]], device=device)
    batches = [dict(zip(("img", "gt_points", "gt_labels", "gt_valid"), _on(device, *s[:4])),
                    img_wh=wh) for s in train_data]

    opt = build_optimizer(model, base_lr=1e-4, layer_decay=1.0, steps_per_epoch=100,
                          accumulate_steps=1, depth=12, warmup_iters=20)
    state = TrainState.create(model, opt)
    step_fn = make_train_step(model)

    table = []
    t0 = time.time()
    last_loss = float("nan")
    for it in range(args.steps + 1):
        if it in milestones:
            bi, mi = score(model, held, wh)
            row = dict(step=it, loss=round(last_loss, 2), pseudo_box_iou=round(bi, 4),
                       pseudo_mask_iou=round(mi, 4))
            if args.det_eval:
                row.update(det_map(model, held, wh))
            table.append(row)
            print(json.dumps(row), flush=True)
            if args.curve_out:
                with open(args.curve_out, "a") as f:
                    f.write(json.dumps(row) + "\n")
        if it == args.steps:
            break
        gen = torch.Generator(device=device).manual_seed(42 + it)
        state, m = step_fn(state, batches[it % len(batches)], generator=gen)
        if it % 50 == 0:
            last_loss = float(m["loss_total"])

    summary = dict(steps=args.steps, wall_s=round(time.time() - t0, 1), table=table)

    if args.save_ckpt:
        to_save = model.state_dict()
        if args.save_dtype == "bfloat16":
            to_save = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                       for k, v in to_save.items()}
        path = save_params(os.path.abspath(args.save_ckpt), to_save)
        summary["ckpt"] = path
        print(f"saved trained params to {path}", flush=True)

    if args.dagger:
        summary["dagger"] = dagger_loop(args, model, train_data, held, wh)

    print(json.dumps(summary))
    return summary


def dagger_loop(args, model, train_data, held, wh) -> dict:
    """AttnShift-dagger: pseudo-label dump -> Mask R-CNN retrain -> score.

    The paper's dagger rows retrain a standard Mask R-CNN on the stage-1
    pseudo labels. Same loop here, in memory on the blob corpus: the
    flagship's final ``seed_pseudo_gt`` output (masks at stride 4) becomes
    full supervision for ``models/mask_rcnn.py`` (the
    ``tools.gen_pseudo_labels`` -> ``configs/mrcnn_refine_voc.py`` path
    without the files)."""
    import torch

    from ...train import TrainState, build_sgd_optimizer, make_refine_train_step

    device = model.device
    # stage 1 output -> full pseudo supervision for the train corpus
    dumped = []
    for s, (boxes, masks) in zip(train_data, _seed_outputs(model, train_data, wh), strict=True):
        img, _, lbl, val = s[:4]
        keys = ("img", "gt_boxes", "gt_labels", "gt_masks", "gt_valid")
        dumped.append(dict(zip(keys, _on(device, img, boxes.astype(np.float32), lbl,
                                         masks[:, ::4, ::4], val)), img_wh=wh))

    rcnn = build_rcnn(device)
    # batch-1 recipe: mmdet's lr 0.02 is for batch 16 -> linear-scaled
    opt = build_sgd_optimizer(rcnn, base_lr=0.0025, steps_per_epoch=100, warmup_iters=20,
                              frozen_stages=0, accumulate_steps=1)
    state_r = TrainState.create(rcnn, opt)
    step_r = make_refine_train_step(rcnn)

    last = float("nan")
    for it in range(args.dagger):
        gen = torch.Generator(device=device).manual_seed(1000 + it)
        state_r, m = step_r(state_r, dumped[it % len(dumped)], generator=gen)
        if it % 50 == 0:
            last = float(m["loss_total"])
            print(json.dumps(dict(dagger_step=it, loss=round(last, 2))), flush=True)

    # held-out detection quality: flagship vs the retrained Mask R-CNN
    res = dict(
        steps=args.dagger, final_loss=round(last, 2),
        flagship_det_mask_iou=round(det_mask_iou_of(_test_outputs(model, held, wh), held), 4),
        dagger_det_mask_iou=round(det_mask_iou_of(_test_outputs(rcnn, held, wh), held), 4),
    )
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
