"""Host utilities: checkpoint / resume and metrics."""

from quantizedmha_tpu_torch.utils.checkpoint import CheckpointManager
from quantizedmha_tpu_torch.utils.metrics import Metrics, default_metrics

__all__ = ["CheckpointManager", "Metrics", "default_metrics"]
