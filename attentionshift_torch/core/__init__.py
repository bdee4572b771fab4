"""Boxes, anchors, losses, assigners and samplers, linear sum assignment,
Sinkhorn.

Submodules are imported where they are used; the names below are the
pseudo-label path's and the correspondence solver's."""

from .assign import hungarian_point_assign
from .lsa import linear_sum_assignment
from .sinkhorn import semantic_correspondence, sinkhorn

__all__ = ["hungarian_point_assign", "linear_sum_assignment", "semantic_correspondence",
           "sinkhorn"]
