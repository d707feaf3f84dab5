"""Attention kernels and their wrappers. Import the submodules directly
(`quantizedmha_tpu_torch.ops.flash_attention_int8`, `.decode`, `.quantize`):
nothing here re-exports a function under a submodule's name."""
