"""Rank evaluated images by quality and draw the best and worst: the port's
twin of ``tools/analysis/analyze_results.py``.

    python -m attentionshift_torch.tools.analysis.analyze_results PREDS.pkl \\
        --dataset-split val.txt --voc-root VOC2012 --out DIR [-k 10]

Reads the ``--dump-preds`` pickle of ``attentionshift_torch.tools.test``,
scores each image by the mean over its GT instances of the best mask IoU
among same-class predictions, and writes ``good_*`` / ``bad_*`` pngs of
the k best and k worst images: prediction masks, their boxes, labels and
scores on the original image.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def image_score(pm, pl, gm, gl) -> float:
    """Mean over GT instances of the best mask IoU among same-class preds."""
    if len(gl) == 0:
        return 1.0 if len(pl) == 0 else 0.0
    if len(pl) == 0:
        return 0.0
    ious = []
    for g, glab in zip(gm, gl):
        same = [i for i, p in enumerate(pl) if p == glab]
        if not same:
            ious.append(0.0)
            continue
        garea = g.sum()
        best = 0.0
        for i in same:
            inter = (pm[i] & g).sum()
            union = pm[i].sum() + garea - inter
            best = max(best, inter / max(union, 1))
        ious.append(float(best))
    return float(np.mean(ious))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Draw the best and worst evaluated images.")
    ap.add_argument("dump", help="pickle from attentionshift_torch.tools.test --dump-preds")
    ap.add_argument("--dataset-split", required=True,
                    help="val split file (image ids, in eval order)")
    ap.add_argument("--voc-root", required=True)
    ap.add_argument("--out", required=True, help="output directory for pngs")
    ap.add_argument("-k", type=int, default=10, help="images per bucket")
    return ap.parse_args(argv)


def main(argv=None) -> list[str]:
    """Run the tool on ``argv``; returns the paths it wrote."""
    from PIL import Image

    from ...data.voc import VOCInstanceEvalDataset
    from ...utils.visualize import draw_detections

    args = parse_args(argv)
    with open(args.dump, "rb") as f:
        d = pickle.load(f)
    preds, gts = d["preds"], d["gts"]
    dataset = VOCInstanceEvalDataset(args.dataset_split, args.voc_root)
    n = len(preds["labels"])
    scores = [image_score(preds["masks"][i], preds["labels"][i], gts["masks"][i],
                          gts["labels"][i]) for i in range(n)]
    order = np.argsort(scores)
    os.makedirs(args.out, exist_ok=True)
    paths = []

    def dump(indices, tag):
        for rank, i in enumerate(indices):
            img = dataset[int(i)]["img"]
            masks = preds["masks"][i]
            boxes = []
            for m in masks:
                ys, xs = np.nonzero(m)
                boxes.append([xs.min(), ys.min(), xs.max(), ys.max()] if len(xs) else [0, 0, 1, 1])
            vis = draw_detections(
                img, np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(preds["labels"][i]), scores=np.asarray(preds["scores"][i]),
                masks=masks,
            )
            name = f"{tag}_{rank:02d}_score{scores[i]:.3f}_{dataset.ids[int(i)]}.png"
            paths.append(os.path.join(args.out, name))
            Image.fromarray(vis).save(paths[-1])

    dump(order[::-1][: args.k], "good")
    dump(order[: args.k], "bad")
    print(f"wrote {2 * args.k} overlays to {args.out} "
          f"(score range {min(scores):.3f}..{max(scores):.3f})")
    return paths


if __name__ == "__main__":
    main()
