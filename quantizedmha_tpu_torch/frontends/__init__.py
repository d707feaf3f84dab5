"""Frontends (counterpart of quantizedmha_tpu/frontends).

The reference shipped pybind11 bindings so PyTorch users could call its
CUDA `solve` through raw device pointers (extensions/torch/torch_ext.cpp).
This package is PyTorch already, so `torch_frontend.flash_solve` is a thin
layer over `api.solve` with the reference binding's checks.
"""
