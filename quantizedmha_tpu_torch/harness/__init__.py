from quantizedmha_tpu_torch.harness.verify import ErrorReport, assert_close, compare

__all__ = ["ErrorReport", "assert_close", "compare"]
