from quantizedmha_tpu_torch.configs.attention import (
    AttentionConfig,
    BlockSizes,
    QuantConfig,
    ReferenceWorkload,
)

__all__ = ["AttentionConfig", "BlockSizes", "QuantConfig", "ReferenceWorkload"]
