from quantizedmha_tpu_torch.utils.metrics import Metrics

__all__ = ["Metrics"]
