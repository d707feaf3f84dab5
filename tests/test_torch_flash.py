"""PyTorch port vs JAX package: the float FlashAttention forward, the
`solve` rungs it carries (fa, fa_bf16) with the unfused baseline, and the
Llama forward under the default attention_impl="flash". JAX runs its
Pallas kernel in interpret mode on the CPU; the port runs the kernel's
plain PyTorch version (the CPU path of the wrapper).

Tolerances. f32: both sides compute every product in f32 and differ only
in summation order and exp/tanh ulps: atol = rtol = 2e-5 on values of
order 1. bf16: Q·K and P·V products are exact in f32 on both sides, but a
score that differs by one f32 ulp can round its bf16 P the other way (one
bf16 ulp, 2^-8 relative, of one key's weight) and the bf16 output itself
rounds: atol = 2^-8 max|v|, rtol = 2^-7 (one output ulp). lse is f32 on
both sides: 1e-5."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu import api as japi
from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu_torch import api as tapi
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from quantizedmha_tpu_torch.ops.unfused import unfused_mha
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (the JAX package's ops/__init__ re-exports a function under this name)
jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention")

F32_TOL = 2e-5
LSE_TOL = 1e-5


def _qkv(b, h, hkv, sq, skv, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, scale, (b, h, sq, d)).astype(np.float32)
    k = rng.normal(0, scale, (b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(0, scale, (b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _pair(q, k, v, dtype):
    """The same inputs as port tensors and JAX arrays of `dtype`."""
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return t, [jnp.asarray(x, jdt) for x in (q, k, v)]


def _close(got, want, v, dtype, what=""):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.bfloat16:
        atol, rtol = 2.0**-8 * float(np.abs(v).max()), 2.0**-7
    else:
        atol = rtol = F32_TOL
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


CASES = {
    # name: (b, h, hkv, sq, skv, d, causal, block_kv, extra kwargs)
    "noncausal_mha": (1, 2, 2, 64, 96, 32, False, 32, {}),
    "causal_gqa": (2, 4, 2, 80, 80, 64, True, 32, {}),
    "causal_mqa_d128": (1, 4, 1, 48, 48, 128, True, 16, {}),
    "uneven_end_aligned": (1, 2, 1, 37, 101, 32, True, 32, {}),
    "window_sinks": (1, 2, 2, 96, 96, 32, True, 32, dict(window=24, attention_sinks=5)),
    "softcap": (1, 2, 1, 64, 64, 64, True, 32, dict(logit_softcap=3.0)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name, dtype):
    b, h, hkv, sq, skv, d, causal, block_kv, kw = CASES[name]
    q, k, v = _qkv(b, h, hkv, sq, skv, d, seed=len(name), scale=1.5)
    (tq, tk, tv), (jq, jk, jv) = _pair(q, k, v, dtype)
    got = tfa.flash_attention(tq, tk, tv, causal=causal, block_kv=block_kv, **kw)
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_kv=block_kv, **kw)
    assert got.dtype == dtype and got.shape == (b, h, sq, d)
    _close(got, want, v, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_save_residuals_with_offsets_matches_jax(dtype):
    """Explicit global offsets (a ring step's q block behind part of kv):
    q rows 0-2 sit before every key and are fully masked (o = 0, lse =
    -inf); the others see a causal prefix."""
    q, k, v = _qkv(1, 4, 2, 40, 72, 32, seed=31)
    (tq, tk, tv), (jq, jk, jv) = _pair(q, k, v, dtype)
    kw = dict(causal=True, block_kv=32, save_residuals=True, q_offset=7, kv_offset=10)
    o, lse = tfa.flash_attention(tq, tk, tv, **kw)
    jo, jlse = jfa.flash_attention(jq, jk, jv, **kw)
    _close(o, jo, v, dtype)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=LSE_TOL, atol=LSE_TOL)
    assert torch.all(o[:, :, :3] == 0) and torch.all(torch.isneginf(lse[:, :, :3]))
    assert torch.isfinite(lse[:, :, 3:]).all()


def test_default_lse_and_window_offsets_match_jax():
    """save_residuals at the default (end-aligned) offsets with a window."""
    q, k, v = _qkv(2, 2, 2, 30, 50, 64, seed=32)
    (tq, tk, tv), (jq, jk, jv) = _pair(q, k, v, torch.float32)
    kw = dict(causal=True, save_residuals=True, window=9, attention_sinks=2)
    o, lse = tfa.flash_attention(tq, tk, tv, **kw)
    jo, jlse = jfa.flash_attention(jq, jk, jv, **kw)
    _close(o, jo, v, torch.float32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=LSE_TOL, atol=LSE_TOL)


def test_bf16_scale_rounds_in_bf16():
    """Q is scaled in its own dtype: at d=128 the bf16 scale is 0.0883789,
    not 128**-0.5 = 0.0883883."""
    assert float(tfa.scaled_q(torch.ones(1, dtype=torch.bfloat16), 128**-0.5)) == 0.08837890625


def test_masking_contract_and_grad_refusal():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 2, 16, 16, 32, seed=33))
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="sinks require a window"):
        tfa.flash_attention(q, k, v, causal=True, attention_sinks=2)
    with pytest.raises(ValueError, match="save_residuals"):
        tfa.flash_attention(q, k, v, causal=True, q_offset=3)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))
    # Inputs that require grad no longer raise: the call is differentiable
    # (tests/test_torch_flash_bwd.py), and the contract holds under grad too.
    q.requires_grad_()
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
    assert tfa.flash_attention(q, k, v, causal=True).grad_fn is not None


@pytest.mark.parametrize("kernel", ["fa", "fa_bf16", "unfused"])
def test_solve_rungs_match_jax(kernel):
    """The solve ladder's float rungs against the JAX solve: fa in f32, the
    bf16 rung (computed in bf16, returned in f32), the unfused baseline."""
    rng = np.random.default_rng(34)
    n, d_model, h = 200, 128, 4
    q, k, v = (rng.normal(0, 1, (n, d_model)).astype(np.float32) for _ in range(3))
    got = tapi.solve(*(torch.from_numpy(x) for x in (q, k, v)), d_model, h,
                     kernel=kernel, causal=True, device="cpu")
    want = japi.solve(*(jnp.asarray(x) for x in (q, k, v)), d_model, h,
                      kernel=kernel, causal=True)
    assert got.dtype == torch.float32 and got.shape == (n, d_model)
    _close(got, want, v, torch.bfloat16 if kernel == "fa_bf16" else torch.float32, kernel)


def test_unfused_guard_and_solve_refusals():
    x = torch.ones((2, 2, 8, 16))
    with pytest.raises(ValueError, match="q_len <= kv_len"):
        unfused_mha(x, x[:, :, :4], x[:, :, :4], causal=True)
    flat = torch.ones((8, 16))
    with pytest.raises(ValueError, match="no window/softcap"):
        tapi.solve(flat, flat, flat, 16, 2, kernel="unfused", logit_softcap=5.0, device="cpu")


def to_numpy_tree(t):
    if isinstance(t, dict):
        return {k: to_numpy_tree(v) for k, v in t.items()}
    return np.asarray(t)


@pytest.mark.parametrize("extra", [{}, dict(sliding_window=12, attention_sinks=2,
                                            logit_softcap=30.0)], ids=["plain", "knobs"])
def test_llama_forward_flash_matches_jax(extra):
    """The default attention_impl ("flash") with float weights in f32: the
    whole model agrees with JAX to f32 summation order."""
    kw = dict(num_layers=2, num_heads=4, num_kv_heads=2, **extra)
    jc = jl.LlamaConfig.tiny(dtype=jnp.float32, **kw)
    tc = tl.LlamaConfig.tiny(dtype=torch.float32, **kw)
    assert jc.attention_impl == tc.attention_impl == "flash"
    jp = jl.init_params(jc, jax.random.PRNGKey(3))
    tp = params_from_numpy(to_numpy_tree(jp), device="cpu")
    toks = np.random.default_rng(35).integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    got = tl.forward(tc, tp, torch.from_numpy(toks)).numpy()
    want = np.asarray(jl.forward(jc, jp, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    ref = np.asarray(jl.forward(dataclasses.replace(jc, attention_impl="reference"), jp,
                                jnp.asarray(toks)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chip_smoke_flash_fwd_check_holds_jax_and_catches_faults(dtype):
    """chip_smoke.py holds the CUDA kernel to the plain version with
    per-element bounds (flash_fwd_tolerances). Here the JAX kernel, whose
    online softmax steps 64 keys at a time (as the CUDA kernel does) where
    the plain version steps 256, stands in for the CUDA kernel and must
    pass; the plain version with a planted fault (one 64-key tile of V
    dropped; the causal diagonal shifted by one) must fail."""
    import chip_smoke

    b, h, hkv, s, d = 1, 4, 2, 256, 64
    q, k, v = _qkv(b, h, hkv, s, s, d, seed=36)
    (tq, tk, tv), (jq, jk, jv) = _pair(q, k, v, dtype)
    offs = tfa._offsets(0, 0, b, "cpu")
    sm = d**-0.5
    kw = dict(sm_scale=sm, causal=True, block_kv=256, window=None, softcap=None, sinks=0)
    o, lse = tfa._flash_fwd_plain(tq, tk, tv, offs, save_residuals=True, **kw)
    w_abs = tfa._flash_fwd_plain(tq, tk, tv.abs(), offs, save_residuals=False, **kw)
    tol, lse_tol = chip_smoke.flash_fwd_tolerances(tq, tk, tv, o, lse, w_abs, sm_scale=sm,
                                                   softcap=None)
    jo, jlse = jfa.flash_attention(jq, jk, jv, causal=True, block_kv=64, save_residuals=True)
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jo, np.float32)).to(dtype), o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jlse)), lse, lse_tol) <= 1.0
    dropped = tv.clone()
    dropped[:, :, 64:128] = 0
    no_tile = tfa._flash_fwd_plain(tq, tk, dropped, offs, save_residuals=False, **kw)
    shifted = tfa._flash_fwd_plain(tq, tk, tv, tfa._offsets(1, 0, b, "cpu"),
                                   save_residuals=False, **kw)
    assert chip_smoke.err_over_tol(no_tile, o, tol) > 5.0
    assert chip_smoke.err_over_tol(shifted, o, tol) > 5.0
