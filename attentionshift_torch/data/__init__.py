"""Datasets, the train and test pipelines and the train loader (numpy, PIL).

The port's own copies of ``attentionshift_tpu/data``, ``refine.py`` (the
refinement stage's dataset and pipeline) included.
"""

from .loader import TrainLoader
from .pipeline import IMAGENET_MEAN, IMAGENET_STD, TestPipeline, TrainPipeline
from .voc import VOC_CLASSES, VOCInstanceEvalDataset, VOCPointDataset

__all__ = [
    "TrainLoader",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "TestPipeline",
    "TrainPipeline",
    "VOC_CLASSES",
    "VOCInstanceEvalDataset",
    "VOCPointDataset",
]

from .coco import COCOEvalDataset, COCOPointDataset

__all__ += ["COCOEvalDataset", "COCOPointDataset"]

from .build import build_eval_dataset, build_train_dataset

__all__ += ["build_eval_dataset", "build_train_dataset"]

from .sbd import SBDInstanceDataset, image_wise_to_instance_wise

__all__ += ["SBDInstanceDataset", "image_wise_to_instance_wise"]

from .refine import InstanceCocoDataset, RefineTrainPipeline

__all__ += ["InstanceCocoDataset", "RefineTrainPipeline"]
