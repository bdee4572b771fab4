"""Dissect the trained flagship's RPN. The port's twin of
``tools/analysis/probe_rpn.py``.

    python -m attentionshift_torch.tools.analysis.probe_rpn [--steps 1000] \\
        [--save-ckpt FILE] [--ckpt FILE] [--device cpu]

Trains the flagship briefly on the discs corpus as ``diagnose_det`` does
(or, with ``--ckpt``, restores a ``train.save_params`` file instead:
``learning_check --save-ckpt`` and ``--save-ckpt`` here write one), then
reports, on one train and one held-out image, one JSON line each with the
JAX tool's keys:

- the objectness of each FPN level (sigmoid: max, mean, share above 0.5);
- the scores at the anchors whose IoU with a true box exceeds 0.5, and
  the largest score elsewhere;
- the candidate set of ``rpn_proposals`` rebuilt on the host: per level
  the top 1000 scores, their boxes decoded and clipped (``delta2bbox``),
  the share with a positive extent, NaN scores and coordinates;
- the proposals ``rpn_test`` keeps: their count, each true box's best
  IoU, the top 5 scores;
- what the RPN trains on: ``seed_pseudo_gt``'s pseudo boxes of the two
  instances (draws from a generator seeded 7) and their IoU with the
  truth, then the anchors' MaxIoU assignment on them (0.7 / 0.3, low
  quality matches) and the positives of a 256-anchor sample at half
  positives.

The probe images are the discs corpus of ``learning_check``'s
``make_sample`` (as the JAX tool's), whatever corpus a restored
checkpoint trained on. The model runs on the card unless ``--device cpu``
asks for the plain PyTorch path (f32 there).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .learning_check import H, W, box_iou, make_sample


def build_model(device):
    from . import diagnose_det

    return diagnose_det.build_model(device)


def iou_matrix(a, b):
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    ar = lambda r: np.clip(r[:, 2] - r[:, 0], 0, None) * np.clip(r[:, 3] - r[:, 1], 0, None)
    return inter / np.maximum(ar(a)[:, None] + ar(b)[None] - inter, 1e-6)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def raw_maps(model, img):
    """The RPN's raw per-level maps: backbone, FPN, RPN head."""
    out, _, _ = model._extract(img, with_features=True)
    cls_scores, bbox_preds = model.rpn_head(model.neck(out["feature"]))
    return ([c.float().cpu().numpy() for c in cls_scores],
            [r.float().cpu().numpy() for r in bbox_preds])


def report(model, tag: str, sample, wh) -> dict:
    import torch

    from ...core.anchors import grid_anchors, grid_anchors_per_level
    from ...core.assign import max_iou_assign, random_sample
    from ...core.boxes import delta2bbox

    img, pts, lbl, val, _tmasks, tboxes = sample
    device = model.device
    imt = torch.from_numpy(img[None]).to(device)
    cls_scores, bbox_preds = raw_maps(model, imt)
    fsizes = [tuple(c.shape[1:3]) for c in cls_scores]
    rep = dict(tag=tag)
    rep["objectness_per_level"] = [
        dict(max=round(float(s.max()), 4), mean=round(float(s.mean()), 5),
             frac_gt_05=round(float((s > 0.5).mean()), 5))
        for s in (sigmoid(c).ravel() for c in cls_scores)]

    # scores of the anchors overlapping the true boxes
    anchors = grid_anchors(fsizes).numpy()
    flat = np.concatenate([sigmoid(c).reshape(-1) for c in cls_scores])
    near = iou_matrix(anchors, np.asarray(tboxes, np.float32)).max(1) > 0.5
    rep["n_anchors_iou50_true"] = int(near.sum())
    if near.any():
        rep["score_at_true_anchors"] = dict(max=round(float(flat[near].max()), 4),
                                            mean=round(float(flat[near].mean()), 4))
    rep["score_elsewhere_max"] = round(float(flat[~near].max()), 4)

    # rpn_proposals' candidate set, rebuilt on the host
    cand_scores, cand_boxes = [], []
    for c, r, anc in zip(cls_scores, bbox_preds, grid_anchors_per_level(fsizes)):
        n_l = int(np.prod(c.shape[1:]))
        s_l = sigmoid(c.reshape(n_l))
        d_l = r.reshape(n_l, 4)
        ti = np.argsort(-s_l)[:min(1000, n_l)]
        bx = delta2bbox(anc[torch.from_numpy(ti)], torch.from_numpy(d_l[ti]), max_shape=(H, W))
        cand_scores.append(s_l[ti])
        cand_boxes.append(bx.numpy())
    cb, cs = np.concatenate(cand_boxes), np.concatenate(cand_scores)
    okc = (cb[:, 2] - cb[:, 0] > 0) & (cb[:, 3] - cb[:, 1] > 0)
    rep["cand_n"] = int(cb.shape[0])
    rep["cand_ok_frac"] = round(float(okc.mean()), 4)
    rep["cand_nan_scores"] = int(np.isnan(cs).sum())
    rep["cand_nan_boxes"] = int(np.isnan(cb).sum())
    rep["cand_degenerate_examples"] = [[round(float(x), 1) for x in b] for b in cb[~okc][:3]]

    # the proposals the detector uses
    props = model.rpn_test(imt)
    pb = props.boxes[0].float().cpu().numpy()
    pv = props.valid[0].cpu().numpy()
    ps = props.scores[0].float().cpu().numpy()
    rep["n_valid_props"] = int(pv.sum())
    if pv.any():
        rep["prop_best_iou"] = [round(float(x), 3)
                                for x in iou_matrix(pb[pv], np.asarray(tboxes, np.float32)).max(0)]
        rep["prop_score_top5"] = [round(float(s), 4) for s in np.sort(ps[pv])[::-1][:5]]

    # what the RPN is trained on: this image's pseudo boxes
    gen = torch.Generator(device=device).manual_seed(7)
    seed = model.seed_pseudo_gt(*(torch.from_numpy(a[None]).to(device) for a in (img, pts, lbl, val)),
                                wh, generator=gen)
    psb = seed["pseudo_gt_bboxes"][0][:2].float().cpu().numpy()
    rep["pseudo_boxes"] = [[round(float(x), 1) for x in b] for b in psb]
    rep["pseudo_vs_true_iou"] = [round(float(box_iou(psb[i], tboxes[i])), 3) for i in range(2)]

    # the assignment rpn_loss sees on them
    assign = max_iou_assign(torch.from_numpy(anchors), torch.from_numpy(psb),
                            torch.zeros((2,), dtype=torch.int32), torch.ones((2,), dtype=torch.bool),
                            0.7, 0.3, 0.3, match_low_quality=True)
    ag = assign.assigned_gt.numpy()
    rep["rpn_train_n_pos"] = int((ag > 0).sum())
    rep["rpn_train_n_neg"] = int((ag == 0).sum())
    samp = random_sample(assign.assigned_gt, 256, 0.5, generator=torch.Generator().manual_seed(0))
    rep["rpn_train_sampled_pos"] = int(samp.pos_mask.sum())
    return rep


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Dissect the trained flagship's RPN.")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--save-ckpt", default=None, metavar="FILE",
                    help="save the trained parameters and buffers (train.save_params)")
    ap.add_argument("--ckpt", default=None, metavar="FILE",
                    help="skip training; probe these saved parameters (train.restore_params)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the tool; returns the two reports it printed."""
    import torch

    from ...device import resolve_device
    from ...train import restore_params, save_params
    from .diagnose_det import train

    args = parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(device)
    rng = np.random.RandomState(0)
    train_data = [make_sample(rng, i) for i in range(8)]
    held = make_sample(np.random.RandomState(100), 0)
    wh = torch.tensor([[float(W), float(H)]], device=device)
    if args.ckpt:
        model.load_state_dict(restore_params(os.path.abspath(args.ckpt)))
    else:
        m = train(model, train_data, args.steps, 1e-4, wh, log_every=None)
        print(json.dumps({k: round(float(v), 4) for k, v in sorted(m.items())}), flush=True)
        if args.save_ckpt:
            print("saved", save_params(os.path.abspath(args.save_ckpt), model.state_dict()),
                  flush=True)
    reps = []
    with torch.no_grad():
        for tag, sample in (("train0", train_data[0]), ("held0", held)):
            reps.append(report(model, tag, sample, wh))
            print(json.dumps(reps[-1]), flush=True)
    return reps


if __name__ == "__main__":
    main()
