from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig
from quantizedmha_tpu_torch.serving.kv_cache import (
    MixedPageAllocator,
    PageAllocator,
    PagedKVCacheState,
    append_token,
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
from quantizedmha_tpu_torch.serving.sharded import (
    LayerStack,
    Lazy,
    TPEngine,
    TPSpecDecodeEngine,
    expand_param_specs,
    local_config,
    make_tp_mesh,
    shard_params,
    tp_cache_specs,
    tp_mixed_cache_specs,
    tp_param_specs,
)
from quantizedmha_tpu_torch.serving.speculative import SpecConfig, SpecDecodeEngine

__all__ = [
    "LayerStack",
    "Lazy",
    "TPEngine",
    "TPSpecDecodeEngine",
    "expand_param_specs",
    "local_config",
    "make_tp_mesh",
    "shard_params",
    "tp_cache_specs",
    "tp_mixed_cache_specs",
    "tp_param_specs",
    "Engine",
    "EngineConfig",
    "MixedPageAllocator",
    "MixedPagedKVState",
    "PageAllocator",
    "PagedKVCacheState",
    "SamplingParams",
    "SpecConfig",
    "SpecDecodeEngine",
    "append_token",
    "append_token_mixed",
    "append_tokens_batched",
    "mixed_paged_decode_attention",
    "mixed_paged_prefill_attention",
    "write_pages",
]
