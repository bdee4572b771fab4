"""Attribute a zero of the flagship's own detector to a stage. The port's
twin of ``tools/analysis/diagnose_det.py``.

    python -m attentionshift_torch.tools.analysis.diagnose_det [--steps 1500] \\
        [--eval-images 4] [--train-images 8] [--lr 1e-4] [--ckpt FILE] [--device cpu]

Trains the flagship as ``learning_check`` does (ViT-S at 512x512, bf16,
``max_gt`` 8, 512 proposals, the discs corpus, AdamW with every lr scale
1.0 and 20 warmup steps; step ``it`` draws from a ``torch.Generator``
seeded 42 + it), printing the metrics every 250 steps and at the last,
then inspects every stage of the detection chain on held-out images, one
JSON line per image with the JAX tool's keys:

- ``rpn_recall``: per true box, the best IoU of a valid ``rpn_test``
  proposal;
- ``truebox_*``: the box head (``roi_test``) on the true boxes (the
  first two RoIs; the proposals fill the rest): P(true class), P(best
  foreground class), the argmax and P(background);
- ``n_det``, ``det_scores_top5``, ``det_best_box_iou``: what
  ``simple_test`` keeps after the score floor and NMS;
- ``det_mask_iou``: the mean over the true masks of the best IoU of a
  detection's mask pasted through ``eval/masks.py::paste_masks_np``.

``--ckpt`` (the port's own option; the JAX tool always trains) probes a
``train.save_params`` file instead of training, such as the one
``learning_check --save-ckpt`` writes; the probe images stay the discs
corpus, whatever corpus the checkpoint trained on. The model runs on the
card unless ``--device cpu`` asks for the plain PyTorch path (f32 there).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .learning_check import G, H, W, box_iou, make_sample


def build_model(device):
    """The JAX tool's flagship (bf16 on the card, f32 on the CPU), seeded
    init (seed 0)."""
    import torch

    from ...models import AttnShiftDetector

    return AttnShiftDetector(
        num_classes=20, embed_dim=384, depth=12, num_heads=6, img_size=224, point_tokens=100,
        cam_layer=7, max_gt=G, use_remat=True, num_proposals=512, rpn_nms_pre=1000,
        rcnn_samples=256, mask_sample_cap=64,
        dtype=torch.float32 if device.type == "cpu" else torch.bfloat16, device=device,
    ).init_weights(0)


def batches_of(samples, device, wh):
    import torch

    keys = ("img", "gt_points", "gt_labels", "gt_valid")
    return [dict({k: torch.from_numpy(np.ascontiguousarray(a)[None]).to(device)
                  for k, a in zip(keys, s[:4])}, img_wh=wh) for s in samples]


def train(model, samples, steps: int, lr: float, wh, log_every: int | None = 250):
    """``steps`` AdamW steps over ``samples`` in turn; prints the metrics
    at every ``log_every``-th step and the last (never without
    ``log_every``). Returns the last metrics."""
    import torch

    from ...train import TrainState, build_optimizer, make_train_step

    device = model.device
    batches = batches_of(samples, device, wh)
    opt = build_optimizer(model, base_lr=lr, layer_decay=1.0, steps_per_epoch=100,
                          accumulate_steps=1, depth=12, warmup_iters=20)
    state = TrainState.create(model, opt)
    step_fn = make_train_step(model)
    m = {}
    for it in range(steps):
        gen = torch.Generator(device=device).manual_seed(42 + it)
        state, m = step_fn(state, batches[it % len(batches)], generator=gen)
        if log_every and (it % log_every == 0 or it == steps - 1):
            print(json.dumps({k: round(float(v), 3) for k, v in sorted(m.items())}
                             | dict(step=it)), flush=True)
    return m


def probe(model, sample, wh, n: int) -> dict:
    """The stage-by-stage probes of one held-out sample -> its JSON row."""
    import torch

    from ...eval.masks import paste_masks_np

    img, pts, lbl, val, tmasks, tboxes = sample
    device = model.device
    imt = torch.from_numpy(img[None]).to(device)
    props = model.rpn_test(imt)
    pb = props.boxes[0].float().cpu().numpy()
    pv = props.valid[0].cpu().numpy()
    rec = [max(box_iou(p, tb) for p in pb[pv]) if pv.any() else 0.0 for tb in tboxes]
    r = model.num_proposals
    rois = np.zeros((1, r, 4), np.float32)
    rois[0, :2] = tboxes
    rois[0, 2:] = pb[:r - 2]
    sc, _ = model.roi_test(imt, torch.from_numpy(rois).to(device), wh)
    sc = sc[0].float().cpu().numpy()  # (R, C + 1)
    out = model.simple_test(imt, wh)
    dsc = out.dets.scores[0].float().cpu().numpy()
    dval = out.dets.valid[0].cpu().numpy()
    dbox = out.dets.boxes[0].float().cpu().numpy()
    diou = [max((box_iou(bb, tb) for bb in dbox[dval]), default=0.0) for tb in tboxes]
    mask_iou = 0.0
    if dval.any():
        probs = out.mask_probs[0].float().cpu().numpy()
        pasted = paste_masks_np(probs[dval], dbox[dval], H, W) > 0.5
        ious = []
        for tm in tmasks:
            inter = (pasted & tm[None]).sum(axis=(1, 2))
            union = pasted.sum(axis=(1, 2)) + tm.sum() - inter
            ious.append(float((inter / np.maximum(union, 1)).max()))
        mask_iou = float(np.mean(ious))
    return dict(
        img=n, true_labels=[int(x) for x in lbl[:2]],
        rpn_recall=[round(float(x), 3) for x in rec],
        # columns: P(true class), P(best fg class), argmax, P(bg) on the TRUE boxes
        truebox_p_true=[round(float(sc[i, lbl[i]]), 4) for i in range(2)],
        truebox_p_maxfg=[round(float(sc[i, :model.num_classes].max()), 4) for i in range(2)],
        truebox_argmax=[int(sc[i].argmax()) for i in range(2)],
        truebox_p_bg=[round(float(sc[i, model.num_classes]), 4) for i in range(2)],
        n_det=int(dval.sum()),
        det_scores_top5=[round(float(s), 4) for s in np.sort(dsc[dval])[::-1][:5]],
        det_best_box_iou=[round(float(x), 3) for x in diou],
        det_mask_iou=round(mask_iou, 4),
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Stage-by-stage probes of the trained detector.")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--eval-images", type=int, default=4)
    ap.add_argument("--train-images", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--ckpt", default=None, metavar="FILE",
                    help="skip training; probe these saved parameters (train.restore_params), "
                         "e.g. a learning_check --save-ckpt file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the tool; returns the held-out rows it printed."""
    import torch

    from ...device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(device)
    rng = np.random.RandomState(0)
    train_data = [make_sample(rng, i) for i in range(args.train_images)]
    held = [make_sample(np.random.RandomState(100 + i), i) for i in range(args.eval_images)]
    wh = torch.tensor([[float(W), float(H)]], device=device)

    if args.ckpt:
        from ...train import restore_params

        model.load_state_dict(restore_params(os.path.abspath(args.ckpt)))
    else:
        t0 = time.time()
        train(model, train_data, args.steps, args.lr, wh)
        print(f"train wall {time.time() - t0:.0f}s", flush=True)
    rows = []
    with torch.no_grad():
        for n, sample in enumerate(held):
            rows.append(probe(model, sample, wh, n))
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
