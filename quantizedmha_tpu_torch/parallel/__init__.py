from quantizedmha_tpu_torch.parallel.combine import merge_two_partials

__all__ = ["merge_two_partials"]
