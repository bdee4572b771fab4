"""Assignment: linear sum assignment and the Hungarian point assigner."""

from .assign import hungarian_point_assign
from .lsa import linear_sum_assignment

__all__ = ["hungarian_point_assign", "linear_sum_assignment"]
