"""The pseudo-label engine: rollout -> CAM -> boxes -> refinement ->
mean-shift semantic centers; the point-token decoding and the CRF."""

from .cam import bbox_from_cam, bbox_from_labels, bbox_from_labels_batch, norm_attns, normalize_cam
from .crf import feature_affinity, mean_field_refine, water_fill
from .engine import PseudoLabels, candidate_boxes, masks_and_centers
from .meanshift import (
    SemanticCenters,
    cosine_shift_batch,
    filter_maps,
    get_center_coords,
    mean_shift_grid_prototype,
    merge_maps,
    semantic_centers,
)
from .point2bbox import PointDetections, point2bbox
from .points import sample_in_mask, strided_in_mask, topk_in_mask
from .refine import (
    RefinedMaps,
    cosine_similarity_refined_map,
    sample_fgbg_points,
    sample_mask_points,
)
from .rollout import attention_rollout_point_rows

__all__ = [
    "attention_rollout_point_rows",
    "bbox_from_cam",
    "bbox_from_labels",
    "bbox_from_labels_batch",
    "feature_affinity",
    "mean_field_refine",
    "water_fill",
    "PointDetections",
    "point2bbox",
    "norm_attns",
    "normalize_cam",
    "PseudoLabels",
    "candidate_boxes",
    "masks_and_centers",
    "SemanticCenters",
    "cosine_shift_batch",
    "filter_maps",
    "get_center_coords",
    "mean_shift_grid_prototype",
    "merge_maps",
    "semantic_centers",
    "sample_in_mask",
    "strided_in_mask",
    "topk_in_mask",
    "RefinedMaps",
    "cosine_similarity_refined_map",
    "sample_fgbg_points",
    "sample_mask_points",
]
