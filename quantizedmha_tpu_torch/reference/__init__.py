from quantizedmha_tpu_torch.reference.mha import (
    apply_rope,
    mha_masked_reference,
    mha_reference_shaped,
)
from quantizedmha_tpu_torch.reference.quant_ref import (
    mha_int8_reference,
    quantize_int8_tile,
)

__all__ = [
    "apply_rope",
    "mha_masked_reference",
    "mha_reference_shaped",
    "mha_int8_reference",
    "quantize_int8_tile",
]
