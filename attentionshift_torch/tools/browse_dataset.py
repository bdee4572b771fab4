"""Write augmented training samples as annotated pngs: the port's twin of
``tools/browse_dataset.py``.

    python -m attentionshift_torch.tools.browse_dataset CFG [--num N] [--out-dir D] \\
        [--cfg-options a.b=v ...]

Runs ``CFG``'s train pipeline (``data.train_scales``, ``data.max_gt``,
``data.flip_ratio``) over the first N samples of ``data.train`` with a
``RandomState(0)``, and draws each sample's annotated points on its
denormalised image; prints each png's path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Draw augmented training samples.")
    p.add_argument("config")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--out-dir", default="browse_dataset")
    p.add_argument("--cfg-options", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """Run the tool on ``argv``; returns the paths it wrote."""
    from PIL import Image

    from ..config import Config
    from ..data.build import build_train_dataset
    from ..data.pipeline import TrainPipeline
    from ..utils.visualize import denormalize, draw_detections

    args = parse_args(argv)
    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    dataset = build_train_dataset(cfg.data.train.to_dict())
    pipeline = TrainPipeline(
        scales=[tuple(s) for s in cfg.data.train_scales],
        max_gt=int(cfg.data.max_gt), flip_ratio=float(cfg.data.flip_ratio),
    )
    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    paths = []
    for i in range(min(args.num, len(dataset))):
        out = pipeline(dataset[i], rng)
        img = denormalize(out["img"])
        pts = out["gt_points"][out["gt_valid"]]
        vis = draw_detections(img, np.zeros((0, 4)), points=pts)
        path = os.path.join(args.out_dir, f"sample_{i}.png")
        Image.fromarray(vis).save(path)
        print(path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
