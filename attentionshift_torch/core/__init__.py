"""Boxes, anchors, losses, assigners and samplers, linear sum assignment.

Submodules are imported where they are used; the two names below are
the pseudo-label path's."""

from .assign import hungarian_point_assign
from .lsa import linear_sum_assignment

__all__ = ["hungarian_point_assign", "linear_sum_assignment"]
