"""COCO point-supervision dataset + eval annotations.

COCO counterpart of the VOC loaders (SURVEY.md section 2 L2): the
reference's COCO path uses the same ``VOCCocoDatasetPoi`` JSON contract
(per-annotation ``point`` field) with COCO categories
(`configs/mae/attnshift_..._qc.py`), and evaluates with pycocotools.
GT masks come from polygon segmentations or RLE, decoded with the native
mask toolkit (pycocotools is unavailable here).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
from PIL import Image

from .. import native
from .voc import Sample

__all__ = ["COCOPointDataset", "COCOEvalDataset"]


class COCOPointDataset:
    """COCO json with per-instance ``point``; yields img + points/labels."""

    def __init__(self, ann_file: str, img_prefix: str, repeat: int = 1):
        self.img_prefix = img_prefix
        with open(ann_file) as f:
            coco = json.load(f)
        cats = sorted(c["id"] for c in coco.get("categories", []))
        self.cat2label = {cid: i for i, cid in enumerate(cats)}
        self.classes = [
            c["name"] for c in sorted(coco.get("categories", []), key=lambda c: c["id"])
        ]
        imgs = {im["id"]: im for im in coco["images"]}
        anns_by_img: dict[Any, list] = {}
        for ann in coco.get("annotations", []):
            if ann.get("ignore", False) or ann.get("iscrowd", False):
                continue
            pt = ann.get("point")
            if pt is None or len(pt) != 2:
                continue
            if ann.get("category_id") not in self.cat2label:
                continue
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.samples: list[Sample] = []
        for img_id, anns in anns_by_img.items():
            info = imgs[img_id]
            self.samples.append(
                Sample(
                    img_path=os.path.join(img_prefix, info["file_name"]),
                    points=np.asarray([a["point"] for a in anns], np.float32),
                    labels=np.asarray(
                        [self.cat2label[a["category_id"]] for a in anns], np.int64
                    ),
                    img_id=img_id,
                    width=info.get("width", 0),
                    height=info.get("height", 0),
                )
            )
        self.repeat = repeat

    def __len__(self):
        return len(self.samples) * self.repeat

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx % len(self.samples)]
        img = np.asarray(Image.open(s.img_path).convert("RGB"))
        return dict(img=img, points=s.points.copy(), labels=s.labels.copy(),
                    img_id=s.img_id)


def _ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), bool)
    if isinstance(seg, list):
        return native.polygons_to_mask(seg, h, w)
    counts = seg.get("counts")
    if isinstance(counts, (bytes, str)):
        rle = native.rle_from_string(counts, seg["size"])
    else:
        rle = {"size": seg["size"], "counts": np.asarray(counts, np.uint32)}
    return native.rle_decode(rle)


class COCOEvalDataset:
    """COCO val images + GT instance masks for segm evaluation."""

    def __init__(self, ann_file: str, img_prefix: str):
        self.img_prefix = img_prefix
        with open(ann_file) as f:
            coco = json.load(f)
        cats = sorted(c["id"] for c in coco.get("categories", []))
        self.cat2label = {cid: i for i, cid in enumerate(cats)}
        self.num_classes = len(cats)
        self.imgs = sorted(coco["images"], key=lambda im: im["id"])
        self.anns_by_img: dict[Any, list] = {}
        for ann in coco.get("annotations", []):
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, idx: int) -> dict:
        info = self.imgs[idx]
        img = np.asarray(
            Image.open(os.path.join(self.img_prefix, info["file_name"])).convert("RGB")
        )
        return dict(img=img, img_id=info["id"])

    def gt_instances(self, idx: int) -> dict:
        info = self.imgs[idx]
        h, w = info["height"], info["width"]
        masks, labels, crowd = [], [], []
        for ann in self.anns_by_img.get(info["id"], []):
            if ann.get("category_id") not in self.cat2label:
                continue
            masks.append(_ann_to_mask(ann, h, w))
            labels.append(self.cat2label[ann["category_id"]])
            crowd.append(bool(ann.get("iscrowd", False)))
        if masks:
            return dict(
                masks=np.stack(masks),
                labels=np.asarray(labels, np.int64),
                iscrowd=np.asarray(crowd, bool),
            )
        return dict(
            masks=np.zeros((0, h, w), bool),
            labels=np.zeros((0,), np.int64),
            iscrowd=np.zeros((0,), bool),
        )
