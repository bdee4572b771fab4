"""What the pseudo-label engine sees on the learning check's held-out images.

    python -m attentionshift_torch.tools.analysis.seed_report CKPT \\
        [--corpus lobes] [--eval-images 8] [--device cpu]

Loads a ``learning_check --save-ckpt`` file into the learning check's
flagship (``learning_check.build_model``) and runs ``seed_debug`` on each
held-out image with the scoring's draws (seed 7). Per true instance it
prints one JSON line: the layer the MIL head chose, the IoU of each
layer's candidate box with the true box, the chosen CAM's peak and mean,
the share of its thresholded map (the CAM resized to the CAM stride,
min-max normalised, at ``seed_thr``, as Stage A makes it) that is on,
and the pseudo box and mask IoUs; then a
summary line of the means and of how often each layer was chosen. This
shows where Stage A goes wrong when the pseudo boxes do not move: flat
CAMs, maps thresholded to the whole image, or a wrong layer choice.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import learning_check as lc


def report(model, held, wh) -> tuple[list, dict]:
    """Per-instance rows and their summary for ``held`` samples."""
    import torch

    from ...ops.image import resize
    from ...pseudo.cam import normalize_cam

    rows = []
    for img, pts, lbl, val, tmasks, tboxes in held:
        gen = torch.Generator(device=model.device).manual_seed(7)
        with torch.no_grad():
            out = model.seed_debug(*lc._on(model.device, img, pts, lbl, val), wh, generator=gen)
        best = out["best_attn_idx"][0].cpu().numpy()
        cand = out["candidate_boxes"][0].float().cpu().numpy()  # (G, L, 4)
        cams = out["cams"][0].float().cpu().numpy()  # (L, G, Hp, Wp)
        boxes = out["pseudo_gt_bboxes"][0].float().cpu().numpy()
        masks = out["pseudo_gt_masks"][0].cpu().numpy()
        # the chosen layer's map as Stage A thresholds it: resized to the
        # CAM stride, min-max normalised, compared with seed_thr
        chosen = torch.stack([out["cams"][0, best[gi], gi] for gi in range(len(tboxes))])
        binary = (normalize_cam(resize(chosen.float(), (lc.H // model.cam_stride,
                                                        lc.W // model.cam_stride)))
                  >= model.seed_thr).cpu().numpy()
        for gi in range(len(tboxes)):
            cam = cams[best[gi], gi]
            peak = float(cam.max())
            pm = masks[gi].astype(bool)
            inter = float(np.logical_and(pm, tmasks[gi]).sum())
            union = float(np.logical_or(pm, tmasks[gi]).sum())
            rows.append(dict(
                layer=int(best[gi]),
                layer_box_iou=[round(float(lc.box_iou(c, tboxes[gi])), 4) for c in cand[gi]],
                cam_peak=round(peak, 5), cam_mean=round(float(cam.mean()), 5),
                above_thr=round(float(binary[gi].mean()), 4),
                box_iou=round(float(lc.box_iou(boxes[gi], tboxes[gi])), 4),
                mask_iou=round(inter / max(union, 1.0), 4)))
    layers = [r["layer"] for r in rows]
    summary = dict(
        n=len(rows), layer_counts={str(k): layers.count(k) for k in sorted(set(layers))},
        best_layer_box_iou=round(float(np.mean([max(r["layer_box_iou"]) for r in rows])), 4),
        **{k: round(float(np.mean([r[k] for r in rows])), 4)
           for k in ("box_iou", "mask_iou", "cam_peak", "cam_mean", "above_thr")})
    return rows, summary


def main(argv=None) -> dict:
    import torch

    from ...device import resolve_device
    from ...train import restore_params

    ap = argparse.ArgumentParser(description="seed_debug on the learning check's held-out set.")
    ap.add_argument("ckpt", help="a learning_check --save-ckpt file")
    ap.add_argument("--corpus", default="lobes", choices=["discs", "lobes", "lobes-tex"])
    ap.add_argument("--eval-images", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = lc.build_model(argparse.Namespace(f32=False), device)
    state = {k: v.to(model.state_dict()[k].dtype) for k, v in restore_params(args.ckpt).items()}
    model.load_state_dict(state)
    held = [lc.make_sample(np.random.RandomState(100 + i), i, args.corpus)
            for i in range(args.eval_images)]
    wh = torch.tensor([[float(lc.W), float(lc.H)]], device=device)
    rows, summary = report(model, held, wh)
    for r in rows:
        print(json.dumps(r))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
