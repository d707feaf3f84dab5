"""PyTorch port vs JAX package: the fused INT8 attention and the reference
ABI. JAX runs its Pallas kernels in interpret mode on the CPU; the port
runs each kernel's plain PyTorch version (the CPU path of the wrapper).

Tolerance: the two sides share every quantization step bit for bit, but
exp/tanh differ by an ulp or so between XLA and PyTorch on the CPU, and a
P' that lands within an ulp of a rounding tie (int8 P, or bf16 P) can round
the other way. One such flip moves an output by at most max|v| / 127, so
each comparison allows exactly that plus 1e-5 of f32 summation order."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu import api as japi
from quantizedmha_tpu.reference import mha as jref
from quantizedmha_tpu.reference import quant_ref as jqref
from quantizedmha_tpu_torch import api as tapi
from quantizedmha_tpu_torch.ops import flash_attention_int8 as tfa
from quantizedmha_tpu_torch.ops.quantize import quantize_kv_blocks
from quantizedmha_tpu_torch.reference import mha as tref
from quantizedmha_tpu_torch.reference import quant_ref as tqref

# (the JAX package's ops/__init__ re-exports a function under this name)
jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention_int8")


def _qkv(b, h, hkv, sq, skv, d, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, scale, (b, h, sq, d)).astype(np.float32)
    k = rng.normal(0, scale, (b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(0, scale, (b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _tol(v):
    return float(np.abs(v).max()) / 127.0 + 1e-5


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


CASES = {
    # name: (b, h, hkv, s, d, causal, block_kv, extra kwargs)
    "d32_noncausal_bf16p": (1, 2, 2, 96, 32, False, 32, {}),
    "d64_causal_gqa_4_2": (1, 4, 2, 128, 64, True, 64, {}),
    "d128_causal_int8p": (2, 2, 1, 80, 128, True, 32, {}),
    "d32_window_sinks_softcap": (1, 2, 2, 128, 32, True, 32,
                                 dict(window=20, attention_sinks=4, logit_softcap=5.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_int8_matches_jax(name):
    b, h, hkv, s, d, causal, block_kv, kw = CASES[name]
    q, k, v = _qkv(b, h, hkv, s, s, d, seed=len(name))
    got = tfa.flash_attention_int8(*_t(q, k, v), causal=causal, block_kv=block_kv, **kw)
    want = jfa.flash_attention_int8(*_j(q, k, v), causal=causal, block_kv=block_kv, **kw)
    assert got.dtype == torch.float32 and got.shape == (b, h, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tol(v))


@pytest.mark.parametrize("pv_dtype,summode", [("int8", "vpu"), ("bf16", "mxu")])
def test_numerics_modes_match_jax(pv_dtype, summode):
    """Both ported numerics variants, forced through the transposed route."""
    q, k, v = _qkv(1, 2, 1, 64, 64, 32, seed=11)
    kw = dict(causal=True, block_kv=32, transposed=True, pv_dtype=pv_dtype, summode=summode)
    got = tfa.flash_attention_int8(*_t(q, k, v), **kw)
    want = jfa.flash_attention_int8(*_j(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tol(v))


@pytest.mark.parametrize("transposed", [True, False])
def test_bf16_p_with_f32_l_is_not_ported(transposed):
    """bf16 P with l summing the f32 P (summode "vpu") has no kernel yet: it
    raises, naming the roadmap, on either route."""
    q, k, v = _t(*_qkv(1, 2, 1, 64, 64, 32, seed=11))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention_int8(q, k, v, causal=True, transposed=transposed,
                                 pv_dtype="bf16", summode="vpu" if transposed else None)


@pytest.mark.parametrize("mode", [0, 1])
def test_chip_smoke_flash_check_holds_jax_and_catches_faults(mode):
    """chip_smoke.py holds the CUDA kernel to the plain version with a
    per-row bound on P-rounding flips (max|v| / l). Here the JAX kernel, an
    independent implementation whose exp differs by ulps, stands in for the
    CUDA kernel and must pass; the plain version with a planted fault (the
    next block's V scale; one 64-key tile of V dropped) must fail."""
    import chip_smoke

    b, h, hkv, s, d, causal, bkv = (1, 4, 2, 256, 128, True, 64) if mode == 0 else \
        (1, 4, 2, 256, 32, False, 64)
    q, k, v = _qkv(b, h, hkv, s, s, d, seed=21 + mode, scale=1.0)
    kq, ks = quantize_kv_blocks(torch.from_numpy(k), bkv)
    vq, vs = quantize_kv_blocks(torch.from_numpy(v), bkv)
    tq = torch.from_numpy(q)
    offs = tfa._offsets(0, 0, b, "cpu")
    kw = dict(sm_scale=d**-0.5, causal=causal, kv_len=s, block_kv=bkv, scale_clamp=1e-8,
              p_scale=127.0, window=None, softcap=None, sinks=0, mode=mode)
    o, lse = tfa._flash_int8_plain(tq, kq, ks, vq, vs, offs, save_residuals=True, **kw)
    _, _, l = tfa._flash_int8_plain_state(tq, kq, ks, vq, vs, offs, **kw)
    tol, lse_tol = chip_smoke.flash_tolerances(o, lse, l, vq, vs, bkv, mode)
    if mode == 0:
        jo, jlse = jfa.flash_attention_int8_prequant(
            jnp.asarray(q), *_j(kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()),
            causal=causal, block_kv=bkv, save_residuals=True)
    else:
        jo, jlse = jfa.flash_attention_int8_t_prequant(
            jnp.asarray(q), *_j(kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()),
            causal=causal, save_residuals=True)
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jo)), o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jlse)), lse, lse_tol) <= 1.0
    shifted = tfa._flash_int8_plain(tq, kq, ks, vq, torch.roll(vs, 1, dims=-1), offs,
                                    save_residuals=False, **kw)
    dropped = vq.clone()
    dropped[:, :, 64:128] = 0
    no_tile = tfa._flash_int8_plain(tq, kq, ks, dropped, vs, offs, save_residuals=False, **kw)
    assert chip_smoke.err_over_tol(shifted, o, tol) > 5.0
    assert chip_smoke.err_over_tol(no_tile, o, tol) > 5.0


def test_prequant_save_residuals_and_tail_mask_match_jax():
    """lse residual, a cache padded past kv_len (tail mask) and explicit
    q/kv offsets, on the standard (int8 P) route."""
    q, k, v = _qkv(2, 4, 2, 48, 96, 64, seed=12)
    kq, ks = quantize_kv_blocks(torch.from_numpy(k), 32)
    vq, vs = quantize_kv_blocks(torch.from_numpy(v), 32)
    kw = dict(kv_len=80, causal=True, q_offset=20, kv_offset=0, save_residuals=True)
    o, lse = tfa.flash_attention_int8_prequant(torch.from_numpy(q), kq, ks, vq, vs, **kw)
    jo, jlse = jfa.flash_attention_int8_prequant(
        jnp.asarray(q), *_j(kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=_tol(v))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)


def test_transposed_prequant_lse_matches_jax():
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=13)
    kq, ks = quantize_kv_blocks(torch.from_numpy(k), 32)
    vq, vs = quantize_kv_blocks(torch.from_numpy(v), 32)
    o, lse = tfa.flash_attention_int8_t_prequant(torch.from_numpy(q), kq, ks, vq, vs,
                                                 causal=True, save_residuals=True)
    jo, jlse = jfa.flash_attention_int8_t_prequant(
        jnp.asarray(q), *_j(kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy()),
        causal=True, save_residuals=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=_tol(v))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)


def test_bf16_inputs_keep_dtype():
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(1, 2, 2, 64, 64, 128, seed=14)))
    out = tfa.flash_attention_int8(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("pv_dtype,summode", [("int8", "vpu"), ("bf16", "mxu")])
def test_quant_ref_golden_matches_jax(pv_dtype, summode):
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=15)
    kw = dict(block_q=32, block_kv=32, causal=True, pv_dtype=pv_dtype, summode=summode)
    got = tqref.mha_int8_reference(*_t(q, k, v), **kw)
    want = jqref.mha_int8_reference(*_j(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tol(v))


def test_goldens_and_rope_match_jax():
    q, k, v = _qkv(1, 4, 2, 40, 40, 32, seed=16)
    kw = dict(causal=True, window=9, softcap=4.0, sinks=2)
    got = tref.mha_masked_reference(*_t(q, k, v), **kw)
    want = jref.mha_masked_reference(*_j(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tref.apply_rope(torch.from_numpy(q), 500000.0).numpy(),
                               np.asarray(jref.apply_rope(jnp.asarray(q), 500000.0)),
                               rtol=1e-5, atol=1e-5)
    kk = np.repeat(k, 2, axis=1)
    vv = np.repeat(v, 2, axis=1)
    np.testing.assert_allclose(
        tref.mha_reference_shaped(*_t(q, kk, vv), causal=True, use_rope=True).numpy(),
        np.asarray(jref.mha_reference_shaped(*_j(q, kk, vv), causal=True, use_rope=True)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel", ["fa_int8", "reference"])
def test_solve_matches_jax(kernel):
    rng = np.random.default_rng(17)
    n, d_model, h = 256, 128, 4
    q, k, v = (rng.normal(0, 1, (n, d_model)).astype(np.float32) for _ in range(3))
    got = tapi.solve(*_t(q, k, v), d_model, h, kernel=kernel, device="cpu")
    want = japi.solve(*_j(q, k, v), d_model, h, kernel=kernel)
    assert got.shape == (n, d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=_tol(v))


def test_solve_constant_input_gate():
    """The reference study's own check: all-ones inputs give exactly 1.0
    (any row-stochastic attention of V = 1); the int8 path must deviate by
    at most 1e-6."""
    n, d_model, h = 512, 128, 4
    ones = torch.ones((n, d_model))
    out = tapi.solve(ones, ones, ones, d_model, h, kernel="fa_int8", device="cpu")
    assert float((out - 1.0).abs().max()) <= 1e-6


def test_solve_config_matches_keywords():
    """An AttentionConfig supplies the defaults, as in the JAX package."""
    from quantizedmha_tpu_torch.configs import AttentionConfig, BlockSizes, QuantConfig
    x = torch.from_numpy(np.random.default_rng(19).normal(0, 1, (3, 128, 64)).astype(np.float32))
    cfg = AttentionConfig(num_heads=2, causal=True, blocks=BlockSizes(block_kv=32),
                          quant=QuantConfig(p_static_scale=100.0))
    got = tapi.solve(x[0], x[1], x[2], 64, config=cfg, device="cpu")
    want = tapi.solve(x[0], x[1], x[2], 64, 2, causal=True, block_kv=32, device="cpu")
    assert not torch.equal(got, want)  # p_static_scale reached the kernel
    from quantizedmha_tpu.configs import AttentionConfig as JCfg, BlockSizes as JB, QuantConfig as JQ
    jcfg = JCfg(num_heads=2, causal=True, blocks=JB(block_kv=32), quant=JQ(p_static_scale=100.0))
    jgot = japi.solve(*_j(*(a.numpy() for a in x)), 64, config=jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=0, atol=_tol(x[2].numpy()))


def test_verify_compare_matches_jax():
    from quantizedmha_tpu.harness import verify as jverify
    from quantizedmha_tpu_torch.harness import verify as tverify
    rng = np.random.default_rng(20)
    ref = rng.normal(0, 1, (64,)).astype(np.float32)
    got = ref + rng.normal(0, 2e-3, (64,)).astype(np.float32)
    got[3] = np.nan
    want = jverify.compare(got, ref, abs_tol=1e-3, rel_tol=1e-3)
    rep = tverify.compare(torch.from_numpy(got), torch.from_numpy(ref), abs_tol=1e-3, rel_tol=1e-3)
    assert str(rep) == str(want) and not rep.ok and rep.n_nonfinite == 1
    assert rep.max_abs == want.max_abs and rep.mean_abs == want.mean_abs
    with pytest.raises(AssertionError):
        tverify.assert_close(torch.from_numpy(got), ref)


@pytest.mark.parametrize("kernel", ["fa", "fa_bf16", "unfused"])
def test_solve_unported_rungs_raise(kernel):
    x = torch.ones((8, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tapi.solve(x, x, x, 16, 2, kernel=kernel, device="cpu")


def test_masking_contract_raises():
    q, k, v = _t(*_qkv(1, 2, 2, 16, 16, 32, seed=18))
    with pytest.raises(ValueError):
        tfa.flash_attention_int8(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError):
        tfa.flash_attention_int8(q, k, v, causal=True, attention_sinks=2)
