"""Metrics of a saved predictions dump, computed again offline: the port's
twin of ``tools/analysis/eval_metric.py``.

    python -m attentionshift_torch.tools.analysis.eval_metric preds.pkl [--iou 0.25 0.5 0.75] \\
        [--per-class]
    python -m attentionshift_torch.tools.analysis.eval_metric preds.pkl --coco

Reads the ``--dump-preds`` pickle of ``attentionshift_torch.tools.test``
and scores it without running inference again: VOC07 mask mAP at any IoU
thresholds (``eval/mean_ap_segm.py``), or COCO segm AP
(``eval/coco_eval.py``) for a COCO dump or with ``--coco``. Prints the
metric dict as JSON.
"""

from __future__ import annotations

import argparse
import json
import pickle


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Score a predictions dump again.")
    ap.add_argument("dump", help="pickle from attentionshift_torch.tools.test --dump-preds")
    ap.add_argument("--iou", type=float, nargs="*", default=[0.25, 0.5, 0.75],
                    help="VOC mask-mAP IoU thresholds")
    ap.add_argument("--coco", action="store_true", help="force COCO segm AP even for a VOC dump")
    ap.add_argument("--per-class", action="store_true",
                    help="also print per-class APs (VOC metric)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns the metrics it printed."""
    args = parse_args(argv)
    with open(args.dump, "rb") as f:
        d = pickle.load(f)
    preds, gts = d["preds"], d["gts"]
    num_classes = d["num_classes"]

    results = {}
    if args.coco or d.get("is_coco"):
        from ...eval.coco_eval import coco_segm_eval

        res = coco_segm_eval(preds["masks"], preds["labels"], preds["scores"], gts["masks"],
                             gts["labels"], num_classes=num_classes, gt_iscrowd=gts.get("crowd"))
        results = {k: float(res[k]) for k in ("AP", "AP50", "AP75")}
    else:
        from ...eval.mean_ap_segm import eval_map_segm

        for thr in args.iou:
            mAP, aps, _ = eval_map_segm(preds["masks"], preds["labels"], preds["scores"],
                                        gts["masks"], gts["labels"], num_classes=num_classes,
                                        iou_thresh=thr)
            results[f"mAP@{thr}"] = float(mAP)
            if args.per_class:
                results[f"per_class@{thr}"] = [float(a) for a in aps]
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
