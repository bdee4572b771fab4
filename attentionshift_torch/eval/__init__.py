"""Host-side evaluation: mask finalisation and VOC-style mAP (numpy).

The port's own copies of the JAX package's numpy-only modules
``eval/masks.py`` and ``eval/mean_ap_segm.py``; multi-scale testing, the
dataset runner and the COCO evaluator are not ported yet.
"""

from .masks import finalize_detections, paste_masks_np
from .mean_ap_segm import eval_map, eval_map_segm, mask_iou, voc_ap

__all__ = ["finalize_detections", "paste_masks_np", "eval_map", "eval_map_segm", "mask_iou",
           "voc_ap"]
