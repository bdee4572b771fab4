"""Dataset construction from config nodes (the build_dataset analog).

The reference instantiates datasets through mmcv registries
(`mmdet/datasets/builder.py`); here a small explicit dispatch covers the
shipped dataset types. ``type`` defaults keep old configs working
(VOC train + VOC eval). The port's own copy of
``attentionshift_tpu/data/build.py``.
"""

from __future__ import annotations

from .coco import COCOEvalDataset, COCOPointDataset
from .voc import VOCInstanceEvalDataset, VOCPointDataset

__all__ = ["build_train_dataset", "build_eval_dataset"]


def build_train_dataset(node: dict):
    kind = node.get("type", "VOCPointDataset")
    if kind == "VOCPointDataset":
        return VOCPointDataset(
            node["ann_file"], node["img_prefix"], repeat=int(node.get("repeat", 1))
        )
    if kind == "COCOPointDataset":
        return COCOPointDataset(
            node["ann_file"], node["img_prefix"], repeat=int(node.get("repeat", 1))
        )
    if kind == "InstanceCocoDataset":
        from .refine import InstanceCocoDataset

        return InstanceCocoDataset(
            node["ann_file"], node["img_prefix"], repeat=int(node.get("repeat", 1))
        )
    raise ValueError(f"unknown train dataset type: {kind}")


def build_eval_dataset(node: dict):
    kind = node.get("type", "VOCInstanceEvalDataset")
    if kind == "VOCInstanceEvalDataset":
        return VOCInstanceEvalDataset(node["split_file"], node["voc_root"])
    if kind == "COCOEvalDataset":
        return COCOEvalDataset(node["ann_file"], node["img_prefix"])
    raise ValueError(f"unknown eval dataset type: {kind}")
