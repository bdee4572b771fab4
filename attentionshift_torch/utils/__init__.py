"""Training utilities: the metric logger, the non-finite loss guards and
the profiling helpers (twins of ``attentionshift_tpu/utils``)."""

from .debug import check_finite_losses, finite_or_dump, guard_losses
from .logging import MetricLogger, get_logger
from .profiling import Throughput, profile_time, trace

__all__ = ["check_finite_losses", "finite_or_dump", "guard_losses", "MetricLogger", "get_logger",
           "Throughput", "profile_time", "trace"]
