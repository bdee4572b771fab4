"""Host-side augmentation pipeline (numpy), static-shape outputs.

Rebuilds the reference train pipeline
(`configs/_base_/datasets/voc_instance_aug.py:8-22`):
RandomFlipC(0.5) -> ResizeC(short in {480..800 step 32}, long cap 1333,
keep ratio) -> Normalize(ImageNet) -> Pad(/32), with the point
coordinates transformed alongside (`mmdet_plugins/datasets/pipelines/
transforms.py` semantics).

TPU twist: instead of per-image dynamic padded shapes (which would
recompile jit per shape), every image lands in one of two static
orientation buckets — landscape (pad_h, pad_w) or portrait swapped —
sized to hold the largest train scale (800, 1333) padded to /32. The
batcher groups same-bucket images (the reference's GroupSampler
aspect-ratio grouping, `mmdet/datasets/samplers/group_sampler.py`, which
exists for exactly the same reason).
"""

from __future__ import annotations

import numpy as np
from PIL import Image

__all__ = ["TrainPipeline", "TestPipeline", "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.asarray([58.395, 57.12, 57.375], np.float32)

TRAIN_SCALES = tuple((s, 1333) for s in range(480, 801, 32))


def _resize_keep_ratio(img: np.ndarray, scale: tuple[int, int]):
    """mmdet keep-ratio resize: short side -> scale[0], long capped at
    scale[1]; returns (resized, w_factor, h_factor)."""
    h, w = img.shape[:2]
    short, long = min(scale), max(scale)
    factor = min(short / min(h, w), long / max(h, w))
    new_w, new_h = int(w * factor + 0.5), int(h * factor + 0.5)
    out = np.asarray(
        Image.fromarray(img).resize((new_w, new_h), Image.BILINEAR)
    )
    return out, new_w / w, new_h / h


def _pad_to(img: np.ndarray, ph: int, pw: int) -> np.ndarray:
    h, w = img.shape[:2]
    out = np.zeros((ph, pw) + img.shape[2:], img.dtype)
    out[:h, :w] = img
    return out


class TrainPipeline:
    def __init__(
        self,
        scales=TRAIN_SCALES,
        max_gt: int = 20,
        flip_ratio: float = 0.5,
        size_divisor: int = 32,
        crop_size: tuple[int, int] | None = None,
        brightness_delta: float = 0.0,
    ):
        self.scales = scales
        self.max_gt = max_gt
        self.flip_ratio = flip_ratio
        # RandomCropC (absolute (h, w) crop; points shifted + filtered,
        # `mmdet_plugins/datasets/pipelines/transforms.py:54-108`). A crop
        # that would drop every point is skipped (the reference returns
        # None and the runner redraws the sample).
        self.crop_size = crop_size
        # JitterBrightness (named in the COCO "tune_brightness" config but
        # never shipped upstream — SURVEY.md wart #2): multiplicative
        # brightness factor in [1-delta, 1+delta]
        self.brightness_delta = brightness_delta
        # static bucket: largest scale (800, 1333) padded to /32
        short = max(s[0] for s in scales)
        long = max(s[1] for s in scales)
        pad = lambda v: (v + size_divisor - 1) // size_divisor * size_divisor
        self.bucket_hw = (pad(short), pad(long))  # landscape (h, w)

    def bucket_of(self, img: np.ndarray) -> str:
        h, w = img.shape[:2]
        return "landscape" if w >= h else "portrait"

    def bucket_of_size(self, w: int, h: int) -> str | None:
        """The bucket of a (w, h) source image before it is loaded: flips
        and the keep-ratio resize keep its orientation. None under a crop,
        whose orientation shows only after it is drawn."""
        return None if self.crop_size is not None else ("landscape" if w >= h else "portrait")

    def bucket_shape(self, bucket: str) -> tuple[int, int]:
        bh, bw = self.bucket_hw
        return (bh, bw) if bucket == "landscape" else (bw, bh)

    def __call__(self, sample: dict, rng: np.random.RandomState) -> dict:
        img = sample["img"]
        points = sample["points"].astype(np.float32)
        labels = sample["labels"].astype(np.int64)

        # RandomFlipC (points flip with the image)
        if rng.rand() < self.flip_ratio:
            img = img[:, ::-1]
            points = points.copy()
            points[:, 0] = img.shape[1] - points[:, 0]

        # RandomCropC (optional)
        if self.crop_size is not None:
            ch, cw = self.crop_size
            oy = rng.randint(0, max(img.shape[0] - ch, 0) + 1)
            ox = rng.randint(0, max(img.shape[1] - cw, 0) + 1)
            shifted = points - np.asarray([ox, oy], np.float32)
            hh = min(ch, img.shape[0] - oy)
            ww = min(cw, img.shape[1] - ox)
            keep = (
                (shifted[:, 0] > 0) & (shifted[:, 1] > 0)
                & (shifted[:, 0] < ww) & (shifted[:, 1] < hh)
            )
            if keep.any():
                img = img[oy:oy + ch, ox:ox + cw]
                points = shifted[keep]
                labels = labels[keep]

        # JitterBrightness (optional)
        if self.brightness_delta > 0:
            factor = 1.0 + rng.uniform(-self.brightness_delta, self.brightness_delta)
            img = np.clip(img.astype(np.float32) * factor, 0, 255).astype(img.dtype)

        # ResizeC, multiscale_mode='value'
        scale = self.scales[rng.randint(len(self.scales))]
        img, wf, hf = _resize_keep_ratio(img, scale)
        points = points * np.asarray([wf, hf], np.float32)
        h, w = img.shape[:2]

        # Normalize + Pad to the static bucket
        img = (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
        bucket = self.bucket_of(img)
        ph, pw = self.bucket_shape(bucket)
        img = _pad_to(img, ph, pw)

        # pad instances to max_gt
        g = min(len(labels), self.max_gt)
        pts = np.zeros((self.max_gt, 2), np.float32)
        lbl = np.zeros((self.max_gt,), np.int32)
        val = np.zeros((self.max_gt,), bool)
        pts[:g] = points[:g]
        lbl[:g] = labels[:g]
        val[:g] = True
        return dict(
            img=img, gt_points=pts, gt_labels=lbl, gt_valid=val,
            img_wh=np.asarray([w, h], np.float32), bucket=bucket,
        )


class TestPipeline:
    """Single-scale test: resize keep-ratio to ``scale``, normalize, pad."""

    def __init__(self, scale=(600, 1000), size_divisor: int = 32):
        self.scale = scale
        pad = lambda v: (v + size_divisor - 1) // size_divisor * size_divisor
        self.bucket_hw = (pad(scale[0]), pad(scale[1]))

    def bucket_shape(self, bucket: str) -> tuple[int, int]:
        bh, bw = self.bucket_hw
        return (bh, bw) if bucket == "landscape" else (bw, bh)

    def __call__(self, sample: dict) -> dict:
        img = sample["img"]
        orig_h, orig_w = img.shape[:2]
        img, wf, hf = _resize_keep_ratio(img, self.scale)
        h, w = img.shape[:2]
        img = (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
        bucket = "landscape" if w >= h else "portrait"
        ph, pw = self.bucket_shape(bucket)
        img = _pad_to(img, ph, pw)
        return dict(
            img=img,
            img_wh=np.asarray([w, h], np.float32),
            scale_wh=np.asarray([wf, hf], np.float32),
            orig_wh=np.asarray([orig_w, orig_h], np.int32),
            bucket=bucket,
            img_id=sample.get("img_id"),
        )
