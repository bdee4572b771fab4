"""Dump pseudo boxes and masks for the refinement stage: the port's twin of
``tools/gen_pseudo_labels.py``.

    python -m attentionshift_torch.tools.gen_pseudo_labels CFG [CKPT] --out F \\
        [--scale S L] [--limit N] [--cfg-options a.b=v ...] [--device cpu]

Runs the model's ``seed_pseudo_gt`` over one pass of the train split's
unique images and writes a COCO-style instance json: per annotation the
box (xywh) and the mask as compressed RLE, both in the original image
frame, ``category_id`` = label + 1, ``score`` 1.0. Each image is resized
keeping its ratio to ``--scale`` and padded to the scale's /32 bucket
(swapped for portrait images); its draws come from a generator seeded
with the image index (the JAX tool's ``PRNGKey(i)``). ``CKPT`` is a port
checkpoint (``train.save_checkpoint`` or ``save_params``); without one
every parameter and buffer is zero, as in the JAX tool.

The model runs on the card (bf16) unless ``--device cpu`` asks for the
plain PyTorch path (f32).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
from PIL import Image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Dump pseudo labels as COCO json with the port.")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--scale", type=int, nargs=2, default=(800, 1333))
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def build(args):
    """(cfg, model, dataset) of parsed ``args``: the dataset over one pass
    of the unique train images."""
    from ..config import Config
    from ..data.build import build_train_dataset
    from ..device import resolve_device
    from ..models import AttnShiftDetector
    from ..train.checkpoint import restore_params

    cfg = Config.fromfile(args.config).merge_from_options(args.cfg_options)
    if cfg.get("model_type", "attnshift") == "mask_rcnn":
        raise NotImplementedError("tools.gen_pseudo_labels: model_type='mask_rcnn' is not "
                                  "ported yet")
    dev = resolve_device(args.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = AttnShiftDetector(device=dev, dtype=dtype, **cfg.model.to_dict())
    if args.checkpoint:
        model.load_state_dict(restore_params(args.checkpoint), strict=True)
        print(f"loaded {args.checkpoint}")
    else:
        with torch.no_grad():
            for t in model.state_dict().values():
                t.zero_()
    dataset = build_train_dataset(cfg.data.train.to_dict())
    if hasattr(dataset, "repeat"):
        dataset.repeat = 1  # one pass over the unique images
    return cfg, model, dataset


def prepare(sample: dict, scale, max_gt: int) -> dict:
    """One dataset sample as the model's batch-1 numpy inputs: the image
    resized keeping its ratio to ``scale``, normalised and padded to the
    scale's /32 bucket (swapped for a portrait image), its points scaled
    alongside; with the resize factors and sizes needed to map back."""
    from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD, _pad_to, _resize_keep_ratio

    raw = sample["img"]
    oh, ow = raw.shape[:2]
    sh, lo = scale
    bh, bw = (sh + 31) // 32 * 32, (lo + 31) // 32 * 32
    img, wf, hf = _resize_keep_ratio(raw, (sh, lo))
    h, w = img.shape[:2]
    ph, pw = (bw, bh) if w < h else (bh, bw)  # portrait: the swapped bucket
    norm = _pad_to((img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD, ph, pw)
    pts = np.zeros((max_gt, 2), np.float32)
    lbl = np.zeros((max_gt,), np.int32)
    val = np.zeros((max_gt,), bool)
    k = min(len(sample["labels"]), max_gt)
    pts[:k] = sample["points"][:k] * [wf, hf]
    lbl[:k] = sample["labels"][:k]
    val[:k] = True
    return dict(args=(norm[None], pts[None], lbl[None], val[None],
                      np.asarray([[float(w), float(h)]], np.float32)),
                factors=(wf, hf), size=(h, w), orig=(oh, ow), k=k)


def pseudo_label_image(model, sample: dict, index: int, scale, max_gt: int, draws=None):
    """``seed_pseudo_gt`` on one sample (draws from a generator seeded with
    ``index``, or handed in); returns its annotations, without ids, in the
    original frame: boxes clipped to it (empty ones dropped), masks resized
    with PIL bilinear and thresholded at > 127, compressed to RLE."""
    from ..native import rle_encode, rle_to_string

    inp = prepare(sample, scale, max_gt)
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(index)
    out = model.seed_pseudo_gt(*(torch.from_numpy(a).to(dev) for a in inp["args"]),
                               generator=gen, draws=draws)
    boxes = out["pseudo_gt_bboxes"][0].float().cpu().numpy()  # (G, 4), resized frame
    masks = out["pseudo_gt_masks"][0].to(torch.uint8).cpu().numpy()  # (G, ph, pw)
    wf, hf = inp["factors"]
    h, w = inp["size"]
    oh, ow = inp["orig"]
    lbl = inp["args"][2][0]
    anns = []
    for j in range(inp["k"]):
        x1, y1, x2, y2 = boxes[j] / [wf, hf, wf, hf]
        x1, x2 = np.clip([x1, x2], 0, ow)
        y1, y2 = np.clip([y1, y2], 0, oh)
        if x2 <= x1 or y2 <= y1:
            continue
        m = Image.fromarray(masks[j, :h, :w] * 255)
        m = np.asarray(m.resize((ow, oh), Image.BILINEAR)) > 127
        rle = rle_encode(np.asarray(m, np.uint8))
        anns.append(dict(
            image_id=int(index), category_id=int(lbl[j]) + 1,
            bbox=[float(x1), float(y1), float(x2 - x1), float(y2 - y1)], area=float(m.sum()),
            segmentation=dict(size=[int(oh), int(ow)], counts=rle_to_string(rle).decode("ascii")),
            iscrowd=0, score=1.0,
        ))
    return anns


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns the COCO dict it wrote."""
    args = parse_args(argv)
    cfg, model, dataset = build(args)
    g = int(cfg.data.max_gt)
    images, annotations = [], []
    n = len(dataset) if not args.limit else min(len(dataset), args.limit)
    t0 = time.time()
    for i in range(n):
        s = dataset[i]
        oh, ow = s["img"].shape[:2]
        images.append(dict(id=int(i), file_name=os.path.basename(
            getattr(dataset.samples[i % len(dataset.samples)], "img_path", str(i))),
            width=int(ow), height=int(oh)))
        for ann in pseudo_label_image(model, s, i, tuple(args.scale), g):
            annotations.append(dict(id=len(annotations) + 1, **ann))
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{n} images, {len(annotations)} anns, "
                  f"{(time.time() - t0) / (i + 1):.2f}s/img")
    classes = getattr(dataset, "classes", None) or [
        f"class_{c}" for c in range(int(cfg.model.num_classes))]
    coco = dict(images=images, annotations=annotations,
                categories=[dict(id=c + 1, name=name) for c, name in enumerate(classes)])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(coco, f)
    print(f"wrote {args.out}: {len(images)} images, {len(annotations)} annotations")
    return coco


if __name__ == "__main__":
    main()
