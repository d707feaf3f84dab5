from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.kv_cache import (
    MixedPageAllocator,
    PageAllocator,
    PagedKVCacheState,
    append_tokens_batched,
    write_pages,
)
from quantizedmha_tpu_torch.serving.mixed_kv import (
    MixedPagedKVState,
    append_token_mixed,
    mixed_paged_decode_attention,
    mixed_paged_prefill_attention,
)
from quantizedmha_tpu_torch.serving.sampling import SamplingParams
from quantizedmha_tpu_torch.serving.speculative import SpecConfig, SpecDecodeEngine

__all__ = [
    "Engine",
    "EngineConfig",
    "MixedPageAllocator",
    "MixedPagedKVState",
    "PageAllocator",
    "PagedKVCacheState",
    "SamplingParams",
    "SpecConfig",
    "SpecDecodeEngine",
    "append_token_mixed",
    "append_tokens_batched",
    "mixed_paged_decode_attention",
    "mixed_paged_prefill_attention",
    "write_pages",
]
