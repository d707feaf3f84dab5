from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.kv_cache import (
    PageAllocator,
    PagedKVCacheState,
    append_tokens_batched,
    write_pages,
)
from quantizedmha_tpu_torch.serving.sampling import SamplingParams

__all__ = [
    "Engine",
    "EngineConfig",
    "PageAllocator",
    "PagedKVCacheState",
    "SamplingParams",
    "append_tokens_batched",
    "write_pages",
]
