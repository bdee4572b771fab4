"""VOC point-supervision datasets.

Rebuilds the reference data layer (SURVEY.md section 2 L2):

- ``VOCPointDataset``  <- ``VOCCocoDatasetPoi``
  (`mmdet_plugins/datasets/voc_coco_poi.py:5-107`): COCO-style json whose
  annotations carry a per-instance ``point`` field; yields image path +
  (points, labels).
- ``VOCInstanceEvalDataset`` <- ``VOCDatasetInstance``
  (`mmdet/datasets/voc_instance.py`): VOC2012 val split with instance
  masks decoded from SegmentationObject/SegmentationClass palette pngs
  (chainercv's ``load_label``/``load_instance`` semantics, reimplemented
  with PIL — chainercv is not available in this environment).

Both are plain indexable python objects producing numpy; batching /
augmentation / device transfer live in ``pipeline.py`` / ``loader.py``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
from PIL import Image

__all__ = ["VOC_CLASSES", "VOCPointDataset", "VOCInstanceEvalDataset"]

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


@dataclass
class Sample:
    img_path: str
    points: np.ndarray  # (G, 2) xy
    labels: np.ndarray  # (G,) int64
    img_id: Any = None
    width: int = 0
    height: int = 0


class VOCPointDataset:
    """COCO-json with per-instance ``point`` (training)."""

    def __init__(self, ann_file: str, img_prefix: str, classes=VOC_CLASSES,
                 repeat: int = 1):
        self.img_prefix = img_prefix
        self.classes = classes
        with open(ann_file) as f:
            coco = json.load(f)
        cat2label = {}
        if "categories" in coco:
            name2label = {n: i for i, n in enumerate(classes)}
            for cat in coco["categories"]:
                if cat["name"] in name2label:
                    cat2label[cat["id"]] = name2label[cat["name"]]
        imgs = {im["id"]: im for im in coco["images"]}
        anns_by_img: dict[Any, list] = {}
        for ann in coco.get("annotations", []):
            if ann.get("ignore", False):
                continue
            if cat2label and ann.get("category_id") not in cat2label:
                continue
            pt = ann.get("point")
            if pt is None or len(pt) != 2:
                continue
            anns_by_img.setdefault(ann["image_id"], []).append(ann)

        self.samples: list[Sample] = []
        for img_id, anns in anns_by_img.items():
            info = imgs[img_id]
            pts = np.asarray([a["point"] for a in anns], np.float32)
            lbl = np.asarray(
                [cat2label.get(a["category_id"], a["category_id"]) for a in anns],
                np.int64,
            )
            self.samples.append(
                Sample(
                    img_path=os.path.join(img_prefix, info["file_name"]),
                    points=pts, labels=lbl, img_id=img_id,
                    width=info.get("width", 0), height=info.get("height", 0),
                )
            )
        self.repeat = repeat

    def __len__(self):
        return len(self.samples) * self.repeat

    def __getitem__(self, idx: int) -> dict:
        s = self.samples[idx % len(self.samples)]
        img = np.asarray(Image.open(s.img_path).convert("RGB"))
        return dict(
            img=img, points=s.points.copy(), labels=s.labels.copy(),
            img_id=s.img_id,
        )


def _load_palette_png(path: str) -> np.ndarray:
    """Palette png -> int label map; 255 = VOC 'ignore' border."""
    return np.asarray(Image.open(path), dtype=np.int32)


class VOCInstanceEvalDataset:
    """VOC2012 val split with GT instance masks for mAP_Segm.

    Mirrors ``VOCDatasetInstance.get_ann_info_test``
    (`mmdet/datasets/voc_instance.py:147-169`): instances come from
    SegmentationObject pngs, their class from the majority
    SegmentationClass label under each instance mask.
    """

    def __init__(self, split_file: str, voc_root: str, classes=VOC_CLASSES):
        self.voc_root = voc_root
        self.classes = classes
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.ids)

    def img_path(self, idx: int) -> str:
        return os.path.join(self.voc_root, "JPEGImages", self.ids[idx] + ".jpg")

    def __getitem__(self, idx: int) -> dict:
        img = np.asarray(Image.open(self.img_path(idx)).convert("RGB"))
        return dict(img=img, img_id=self.ids[idx])

    def gt_instances(self, idx: int) -> dict:
        """GT masks (N, H, W) bool + labels (N,) for one image."""
        vid = self.ids[idx]
        obj = _load_palette_png(
            os.path.join(self.voc_root, "SegmentationObject", vid + ".png")
        )
        cls = _load_palette_png(
            os.path.join(self.voc_root, "SegmentationClass", vid + ".png")
        )
        masks, labels = [], []
        for inst_id in np.unique(obj):
            if inst_id in (0, 255):
                continue
            m = obj == inst_id
            vals, counts = np.unique(cls[m & (cls != 255)], return_counts=True)
            if len(vals) == 0:
                continue
            cls_id = int(vals[np.argmax(counts)])
            if cls_id in (0, 255):
                continue
            masks.append(m)
            labels.append(cls_id - 1)  # VOC class png: 1..20
        if masks:
            return dict(
                masks=np.stack(masks), labels=np.asarray(labels, np.int64)
            )
        h, w = obj.shape
        return dict(
            masks=np.zeros((0, h, w), bool), labels=np.zeros((0,), np.int64)
        )
