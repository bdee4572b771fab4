"""SBD (Semantic Boundaries Dataset) instance-segmentation dataset.

Rebuilds ``SBDDatasetInstance`` (`mmdet/datasets/sbd_instance.py:16-61`):
per-image ``cls``/``inst`` .mat files (``GTcls.Segmentation`` /
``GTinst.Segmentation``) are converted image-wise -> instance-wise
(chainercv ``voc_utils.image_wise_to_instance_wise`` semantics), boxes
are the mask extents and the annotated point is the box centre — the
reference's recipe for synthesising point supervision from SBD masks.

Train contract matches ``VOCPointDataset`` (img/points/labels); eval
contract matches ``VOCInstanceEvalDataset.gt_instances`` (masks/labels).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .voc import VOC_CLASSES

__all__ = ["SBDInstanceDataset", "image_wise_to_instance_wise"]


def image_wise_to_instance_wise(label_img: np.ndarray, inst_img: np.ndarray):
    """(H, W) class map + (H, W) instance map -> (N, H, W) masks, (N,) labels.

    Instance ids <= 0 are background/ignore (the reference maps 0 and 255
    to -1, `sbd_instance.py:38-39`); each instance's class is the unique
    class label under its mask (chainercv semantics: majority vote for
    robustness to boundary pixels).
    """
    masks, labels = [], []
    for inst_id in np.unique(inst_img):
        if inst_id <= 0:
            continue
        m = inst_img == inst_id
        vals, counts = np.unique(label_img[m & (label_img > 0)], return_counts=True)
        if len(vals) == 0:
            continue
        labels.append(int(vals[np.argmax(counts)]) - 1)  # 1..20 -> 0..19
        masks.append(m)
    h, w = inst_img.shape
    if not masks:
        return np.zeros((0, h, w), bool), np.zeros((0,), np.int64)
    return np.stack(masks), np.asarray(labels, np.int64)


class SBDInstanceDataset:
    """SBD train/val split with synthesised point supervision."""

    def __init__(self, split_file: str, sbd_root: str, classes=VOC_CLASSES,
                 repeat: int = 1):
        self.sbd_root = sbd_root
        self.classes = classes
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.repeat = repeat

    def __len__(self):
        return len(self.ids) * self.repeat

    def img_path(self, idx: int) -> str:
        return os.path.join(
            self.sbd_root, "img", self.ids[idx % len(self.ids)] + ".jpg"
        )

    def _load_label_inst(self, data_id: str):
        import scipy.io

        label = scipy.io.loadmat(
            os.path.join(self.sbd_root, "cls", data_id + ".mat")
        )["GTcls"]["Segmentation"][0][0].astype(np.int32)
        inst = scipy.io.loadmat(
            os.path.join(self.sbd_root, "inst", data_id + ".mat")
        )["GTinst"]["Segmentation"][0][0].astype(np.int32)
        inst[inst == 0] = -1
        inst[inst == 255] = -1
        return label, inst

    def gt_instances(self, idx: int) -> dict:
        label_img, inst_img = self._load_label_inst(self.ids[idx % len(self.ids)])
        masks, labels = image_wise_to_instance_wise(label_img, inst_img)
        return dict(masks=masks, labels=labels)

    def __getitem__(self, idx: int) -> dict:
        gt = self.gt_instances(idx)
        masks, labels = gt["masks"], gt["labels"]
        boxes = np.zeros((len(masks), 4), np.float32)
        for i, m in enumerate(masks):
            ys, xs = np.nonzero(m)
            boxes[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
        points = (boxes[:, :2] + boxes[:, 2:]) / 2.0  # box centres (`:54`)
        img = np.asarray(Image.open(self.img_path(idx)).convert("RGB"))
        return dict(
            img=img, points=points.astype(np.float32), labels=labels,
            img_id=self.ids[idx % len(self.ids)],
        )
