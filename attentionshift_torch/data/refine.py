"""Self-training refinement data: pseudo-label COCO jsons with masks.

The port's own copy of ``attentionshift_tpu/data/refine.py``.

Feeds ``models.mask_rcnn.MaskRCNN`` with full (pseudo) instance
annotations — the AttnShift-dagger stage. The json is what
``tools/gen_pseudo_labels.py`` dumps: standard COCO ``images`` /
``annotations`` with ``bbox`` (xywh) and ``segmentation`` as compressed
RLE ({"size": [h, w], "counts": str}); any COCO instance json (e.g.
real GT, for a fully-supervised baseline) works too — polygons are
rasterised via the native toolkit.

``RefineTrainPipeline`` mirrors ``TrainPipeline`` (flip -> multiscale
keep-ratio resize -> normalise -> pad to static bucket) transforming
boxes and masks alongside; masks land at ``mask_stride`` resolution of
the padded bucket (28x28 RoI targets need no more). The buckets are
``TrainPipeline``'s, and so is ``bucket_of_size``: the loader counts
each rank's steps per epoch from the image sizes alone.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
from PIL import Image

from ..native import rle_decode, rle_from_string
from .pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    TRAIN_SCALES,
    TrainPipeline,
    _pad_to,
    _resize_keep_ratio,
)

__all__ = ["InstanceCocoDataset", "RefineTrainPipeline"]


@dataclass
class _Inst:
    img_path: str
    boxes: np.ndarray  # (N, 4) xyxy
    labels: np.ndarray  # (N,)
    segs: list  # COCO segmentation objects
    img_id: Any
    width: int
    height: int


def _seg_to_mask(seg, h: int, w: int) -> np.ndarray:
    """COCO segmentation -> (h, w) uint8 bitmap (RLE or polygon)."""
    if isinstance(seg, dict):
        counts = seg["counts"]
        if isinstance(counts, str):
            rle = rle_from_string(counts, seg["size"])
        else:  # uncompressed column-major run list
            rle = {"size": seg["size"], "counts": counts}
        return rle_decode(rle).astype(np.uint8)
    # polygon list
    from ..native import polygons_to_mask

    return polygons_to_mask(seg, h, w)


class InstanceCocoDataset:
    """COCO instance json (bbox + segmentation) for refinement training."""

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
        by_img: dict[Any, list] = {}
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", False) or ann.get("category_id") not in self.cat2label:
                continue
            if "bbox" not in ann or "segmentation" not in ann:
                continue
            by_img.setdefault(ann["image_id"], []).append(ann)
        self.samples: list[_Inst] = []
        for img_id, anns in by_img.items():
            info = imgs[img_id]
            xywh = np.asarray([a["bbox"] for a in anns], np.float32)
            boxes = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], axis=1)
            self.samples.append(
                _Inst(
                    img_path=os.path.join(img_prefix, info["file_name"]),
                    boxes=boxes,
                    labels=np.asarray(
                        [self.cat2label[a["category_id"]] for a in anns], np.int64
                    ),
                    segs=[a["segmentation"] for a in anns],
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
        h, w = img.shape[:2]
        masks = np.stack([_seg_to_mask(seg, h, w) for seg in s.segs])
        return dict(
            img=img, boxes=s.boxes.copy(), labels=s.labels.copy(),
            masks=masks, img_id=s.img_id,
        )


class RefineTrainPipeline(TrainPipeline):
    """Flip -> multiscale resize -> normalise -> pad; boxes+masks ride
    along. Shares the static-bucket machinery with ``TrainPipeline``
    (identical bucket shapes keep the jitted train step at two compiled
    executables across both stages)."""

    def __init__(
        self,
        scales=TRAIN_SCALES,
        max_gt: int = 20,
        flip_ratio: float = 0.5,
        size_divisor: int = 32,
        mask_stride: int = 4,
    ):
        super().__init__(
            scales=scales, max_gt=max_gt, flip_ratio=flip_ratio,
            size_divisor=size_divisor,
        )
        self.mask_stride = mask_stride

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        img = sample["img"]
        boxes = sample["boxes"].astype(np.float32)
        labels = sample["labels"].astype(np.int64)
        masks = sample["masks"]

        if rng.rand() < self.flip_ratio:
            img = img[:, ::-1]
            masks = masks[:, :, ::-1]
            boxes = boxes.copy()
            w = img.shape[1]
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]

        scale = self.scales[rng.randint(len(self.scales))]
        img, wf, hf = _resize_keep_ratio(img, scale)
        boxes = boxes * np.asarray([wf, hf, wf, hf], np.float32)
        h, w = img.shape[:2]

        img = (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
        bucket = self.bucket_of(img)
        ph, pw = self.bucket_shape(bucket)
        img = _pad_to(img, ph, pw)

        # masks: resize each instance to the image's new size, then place
        # in the strided bucket canvas (bilinear >= .5 keeps thin parts
        # better than nearest subsampling)
        ms = self.mask_stride
        mh, mw = ph // ms, pw // ms
        g = min(len(labels), self.max_gt)
        out_masks = np.zeros((self.max_gt, mh, mw), np.uint8)
        th, tw = max(h // ms, 1), max(w // ms, 1)
        for i in range(g):
            mm = Image.fromarray(masks[i].astype(np.uint8) * 255)
            mm = np.asarray(mm.resize((tw, th), Image.BILINEAR))
            out_masks[i, :th, :tw] = (mm > 127).astype(np.uint8)

        bxs = np.zeros((self.max_gt, 4), np.float32)
        lbl = np.zeros((self.max_gt,), np.int32)
        val = np.zeros((self.max_gt,), bool)
        bxs[:g] = boxes[:g]
        lbl[:g] = labels[:g]
        val[:g] = True
        return dict(
            img=img, gt_boxes=bxs, gt_labels=lbl, gt_masks=out_masks,
            gt_valid=val, img_wh=np.asarray([w, h], np.float32), bucket=bucket,
        )
