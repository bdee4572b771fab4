"""Evaluation: mask finalisation, VOC-style and COCO-style mask AP,
multi-scale + flip testing and the dataset runner.

The numpy modules (``masks.py``, ``mean_ap_segm.py``, ``coco_eval.py``)
are the port's own copies of the JAX package's; ``aug_test.py`` and
``runner.py`` drive the port's detector on its device, ``runner.py``
over the ranks of a process group too (each evaluates its stride of the
dataset; rank 0 merges through a shared directory).
"""

from .aug_test import AugTester
from .coco_eval import coco_segm_eval
from .masks import finalize_detections, paste_masks_np
from .mean_ap_segm import eval_map, eval_map_segm, mask_iou, voc_ap
from .runner import collect_results_fs, evaluate

__all__ = ["finalize_detections", "paste_masks_np", "eval_map_segm", "mask_iou", "voc_ap",
           "AugTester", "coco_segm_eval", "eval_map", "evaluate", "collect_results_fs"]
