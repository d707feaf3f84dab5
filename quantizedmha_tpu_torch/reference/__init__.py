from quantizedmha_tpu_torch.reference.mha import (
    apply_rope,
    mha_masked_reference,
    mha_reference,
    mha_reference_shaped,
    mha_with_intermediates,
)
from quantizedmha_tpu_torch.reference.quant_ref import (
    fake_quant_int8,
    mha_int8_reference,
    quantize_int8_tile,
)

__all__ = [
    "apply_rope",
    "mha_masked_reference",
    "mha_reference",
    "mha_reference_shaped",
    "mha_with_intermediates",
    "fake_quant_int8",
    "mha_int8_reference",
    "quantize_int8_tile",
]
