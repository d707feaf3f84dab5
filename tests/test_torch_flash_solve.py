"""PyTorch port vs JAX package: the torch frontend's `flash_solve` on the
same inputs, flat and batched, and its validation errors.

Tolerances, as the solve ladder's parity tests state them: the f32 rungs
(fa, unfused, reference) rtol = atol = 1e-5; fa_bf16 atol 2^-8 max|v|,
rtol 2^-7; fa_int8 atol max|v| / 127 + 1e-5 (one int8 step of V), rtol
1e-5."""

import numpy as np
import pytest
import torch

from quantizedmha_tpu.frontends.torch_frontend import flash_solve as jflash_solve
from quantizedmha_tpu_torch.frontends.torch_frontend import flash_solve


def _tol(kernel, v):
    vmax = float(v.abs().max())
    if kernel == "fa_bf16":
        return dict(atol=2.0**-8 * vmax, rtol=2.0**-7)
    if kernel == "fa_int8":
        return dict(atol=vmax / 127.0 + 1e-5, rtol=1e-5)
    return dict(atol=1e-5, rtol=1e-5)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
                 for _ in range(3))


@pytest.mark.parametrize("kernel,causal,rope", [
    ("fa", False, False), ("fa", True, True), ("fa_bf16", True, False),
    ("fa_int8", False, True), ("unfused", True, False), ("reference", False, False)])
def test_flash_solve_matches_jax(kernel, causal, rope):
    q, k, v = _qkv((128, 64), 5)
    got = flash_solve(q, k, v, 64, 2, kernel=kernel, causal=causal, use_rope=rope)
    want = jflash_solve(q, k, v, 64, 2, kernel=kernel, causal=causal, use_rope=rope)
    assert isinstance(got, torch.Tensor) and got.device == q.device
    assert got.shape == q.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **_tol(kernel, v))


@pytest.mark.parametrize("kernel", ["fa", "fa_int8"])
def test_batched_inputs_match_jax(kernel):
    q, k, v = _qkv((2, 3, 64, 32), 6)
    got = flash_solve(q, k, v, 32, 2, kernel=kernel, sm_scale=0.2)
    want = jflash_solve(q, k, v, 32, 2, kernel=kernel, sm_scale=0.2)
    assert got.shape == q.shape
    torch.testing.assert_close(got, want, **_tol(kernel, v))
    # Each sequence of the batch is solved on its own.
    flat = flash_solve(q[1, 2], k[1, 2], v[1, 2], 32, 2, kernel=kernel, sm_scale=0.2)
    assert torch.equal(got[1, 2], flat)


def test_validation_errors():
    q, k, v = _qkv((128, 64), 7)
    with pytest.raises(TypeError, match="float32"):
        flash_solve(q.double(), k, v, 64, 2)
    with pytest.raises(TypeError, match="torch.Tensor"):
        flash_solve(q.numpy(), k, v, 64, 2)
    with pytest.raises(ValueError, match="identical shapes"):
        flash_solve(q, k[:64], v, 64, 2)
    with pytest.raises(ValueError, match="d_model"):
        flash_solve(q, k, v, 128, 2)
    with pytest.raises(ValueError, match="unknown kernel"):
        flash_solve(q, k, v, 64, 2, kernel="nope")
    with pytest.raises(ValueError, match="N, d_model"):
        flash_solve(q[0], k[0], v[0], 64, 2)
