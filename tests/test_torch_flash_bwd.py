"""PyTorch port vs JAX package: the FlashAttention backward.

The port's gradients through `flash_attention` (its `torch.autograd.Function`,
whose backward on the CPU is `_flash_bwd_plain`, the two CUDA kernels'
algorithm) against `jax.grad` through the JAX `flash_attention` (its custom
VJP, Pallas `_bwd_pallas` in interpret mode), on the same inputs made with
numpy; `_flash_bwd_plain` against `_bwd_pallas` directly; the goldens
`mha_with_intermediates` and `mha_reference` against JAX's.

Tolerances. f32: both sides compute every product in f32 and differ only
in summation order and exp/tanh ulps: |got - want| <= 2e-5 (1 + max|want|)
(gradients here are of order 1-10). bf16: both backwards compute in f32 from
the same bf16 inputs, but each side's bf16 forward output O (which feeds di
= rowsum(dO·O)) may round one ulp apart, and each gradient rounds to bf16:
2^-7 |want| (one output ulp) + 2^-7 max|want|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.reference import mha as jref
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from quantizedmha_tpu_torch.reference import mha as tref

# (the JAX package's ops/__init__ re-exports a function under this name)
jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention")

F32_TOL = 2e-5


def _inputs(b, h, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, h, sq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, skv, d)).astype(np.float32)
    w = rng.normal(0, 1, (b, h, sq, d)).astype(np.float32)
    return q, k, v, w


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _close(got, want, dtype, what=""):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all(), what
    scale = float(np.abs(want).max())
    if dtype == torch.bfloat16:
        tol = 2.0**-7 * np.abs(want) + 2.0**-7 * scale
    else:
        tol = F32_TOL * (1.0 + scale)
    err = np.abs(got - want)
    assert (err <= tol).all(), f"{what}: max err {err.max()}, worst err/tol {(err / tol).max()}"


def _port_grads(q, k, v, w, dtype, **kw):
    """(o, dq, dk, dv) of sum(o * w) through the port's flash_attention."""
    t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o = tfa.flash_attention(*t, **kw)
    (o.float() * torch.from_numpy(w)).sum().backward()
    return o, *(x.grad for x in t)


def _jax_grads(q, k, v, w, dtype, **kw):
    jdt = _jdt(dtype)
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, **kw).astype(jnp.float32) * w)
    return jax.grad(loss, (0, 1, 2))(*args)


#   (B, H, Hkv, Sq, Skv, D, flash_attention keywords)
CASES = {
    "causal": (1, 2, 2, 64, 64, 32, dict(causal=True)),
    "noncausal": (2, 2, 2, 48, 80, 32, dict(causal=False)),
    "cross_unaligned": (1, 2, 2, 50, 98, 64, dict(causal=True)),
    "gqa": (1, 4, 2, 40, 72, 32, dict(causal=True)),
    "mqa": (1, 4, 1, 33, 33, 64, dict(causal=True)),
    "window": (1, 4, 2, 70, 70, 32, dict(causal=True, window=9)),
    "window_sinks": (1, 4, 2, 70, 90, 32, dict(causal=True, window=9, attention_sinks=3)),
    "softcap": (1, 2, 1, 48, 48, 32, dict(causal=True, logit_softcap=4.0)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_grads_match_jax(name, dtype):
    B, H, Hkv, Sq, Skv, D, kw = CASES[name]
    q, k, v, w = _inputs(B, H, Hkv, Sq, Skv, D, seed=len(name))
    o, *got = _port_grads(q, k, v, w, dtype, **kw)
    assert o.grad_fn is not None
    want = _jax_grads(q, k, v, w, dtype, **kw)
    for g, gw, n in zip(got, want, "qkv"):
        assert g.dtype == dtype
        _close(g, gw, dtype, f"{name} d{n}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_lse_cotangent_matches_golden_and_jax(dtype):
    """A loss on sin(lse) (the dlse fold, di - dlse) as well as on o:
    against autograd through the port's mha_with_intermediates (lse from S)
    and against jax.grad through the JAX flash_attention."""
    q, k, v, w = _inputs(1, 2, 2, 48, 48, 32, seed=7)
    t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention(*t, causal=True, save_residuals=True)
    assert lse.requires_grad
    ((o.float() * torch.from_numpy(w)).sum() + torch.sin(lse).sum()).backward()
    got = [x.grad for x in t]

    r = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    ro, s, _ = tref.mha_with_intermediates(*r, causal=True)
    rlse = torch.logsumexp(s, dim=-1)
    ((ro.float() * torch.from_numpy(w)).sum() + torch.sin(rlse).sum()).backward()
    for g, gr, n in zip(got, r, "qkv"):
        _close(g, gr.grad.float(), dtype, f"golden d{n}")

    jdt = _jdt(dtype)

    def loss(q, k, v):
        jo, jlse = jfa.flash_attention(q, k, v, causal=True, save_residuals=True)
        return jnp.sum(jo.astype(jnp.float32) * w) + jnp.sum(jnp.sin(jlse))
    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    for g, gw, n in zip(got, want, "qkv"):
        _close(g, gw, dtype, f"jax d{n}")


def test_fully_masked_rows_get_zero_grad():
    """q_offset 0 against kv_offset 10: the first 10 q rows see no key (lse
    -inf, o 0). Their dq is exactly 0, nothing is NaN, and the rest equals
    JAX's."""
    q, k, v, w = _inputs(1, 2, 2, 40, 60, 32, seed=3)
    kw = dict(causal=True, save_residuals=True, q_offset=0, kv_offset=10)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention(*t, **kw)
    assert torch.isinf(lse[:, :, :10]).all() and (o[:, :, :10] == 0).all()
    (o * torch.from_numpy(w)).sum().backward()
    assert (t[0].grad[:, :, :10] == 0).all()

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, **kw)[0] * w)
    want = jax.grad(loss, (0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for g, gw, n in zip((x.grad for x in t), want, "qkv"):
        _close(g, gw, torch.float32, f"d{n}")


def test_per_batch_offsets_equal_each_sequence_alone():
    """[batch] offsets (ring-style): each sequence's gradients equal the same
    sequence's run alone with scalar offsets."""
    q, k, v, w = _inputs(2, 4, 2, 32, 48, 32, seed=4)
    q_off, kv_off = torch.tensor([20, 5]), torch.tensor([0, 12])
    kw = dict(causal=True, save_residuals=True, window=24, attention_sinks=2)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, _ = tfa.flash_attention(*t, q_offset=q_off, kv_offset=kv_off, **kw)
    (o * torch.from_numpy(w)).sum().backward()
    for b in range(2):
        s = [torch.from_numpy(x[b:b + 1]).requires_grad_() for x in (q, k, v)]
        ob, _ = tfa.flash_attention(*s, q_offset=int(q_off[b]), kv_offset=int(kv_off[b]), **kw)
        (ob * torch.from_numpy(w[b:b + 1])).sum().backward()
        for g, gb in zip(t, s):
            torch.testing.assert_close(g.grad[b:b + 1], gb.grad, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_plain_matches_bwd_pallas(dtype):
    """_flash_bwd_plain against JAX's _bwd_pallas on the same residuals
    (JAX's forward o and lse), with a dlse cotangent, GQA, window, sinks and
    softcap at explicit offsets."""
    q, k, v, do = _inputs(1, 4, 2, 60, 80, 32, seed=11)
    dlse = np.random.default_rng(12).normal(0, 1, (1, 4, 60)).astype(np.float32)
    jdt = _jdt(dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    kw = dict(window=30, softcap=5.0, sinks=4)
    sm = 32 ** -0.5
    o, lse = jfa._fwd(jq, jk, jv, sm_scale=sm, causal=True, block_q=None, block_kv=None,
                      save_residuals=True,
                      q_offset=20, kv_offset=0, window=30, softcap=5.0, sinks=4)
    want = jfa._bwd_pallas(sm, True, jq, jk, jv, o, lse, jdo, dlse=jnp.asarray(dlse),
                           q_offset=20, kv_offset=0, **kw)
    tt = [torch.from_numpy(np.array(x, np.float32)).to(dtype) for x in (jq, jk, jv, o, jdo)]
    got = tfa._flash_bwd_plain(
        tt[0], tt[1], tt[2], tt[3], torch.from_numpy(np.array(lse)), tt[4],
        tfa._offsets(20, 0, 1, "cpu"), torch.from_numpy(dlse), sm_scale=sm, causal=True, **kw)
    for g, gw, n in zip(got, want, "qkv"):
        _close(g, gw, dtype, f"d{n}")


def test_bwd_reference_matches_jax():
    q, k, v, do = _inputs(1, 2, 2, 40, 56, 32, seed=13)
    sm = 32 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._fwd(jq, jk, jv, sm_scale=sm, causal=True, block_q=None, block_kv=None,
                      save_residuals=True)
    want = jfa._bwd_reference(sm, True, jq, jk, jv, o, lse, jdo)
    got = tfa._bwd_reference(sm, True, *(torch.from_numpy(np.array(x))
                                         for x in (q, k, v, o, lse, do)))
    for g, gw, n in zip(got, want, "qkv"):
        _close(g, gw, torch.float32, f"d{n}")


@pytest.mark.parametrize("causal", [False, True])
def test_mha_with_intermediates_matches_jax(causal):
    q, k, v, _ = _inputs(2, 3, 3, 24, 40, 16, seed=5)
    got = tref.mha_with_intermediates(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                                      use_rope=True)
    want = jref.mha_with_intermediates(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                       use_rope=True)
    for g, gw, n in zip(got, want, ("o", "s", "p")):
        np.testing.assert_allclose(g.numpy(), np.asarray(gw), atol=2e-5, rtol=2e-5, err_msg=n)


def test_mha_reference_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(0, 1, (48, 64)).astype(np.float32) for _ in range(3))
    got = tref.mha_reference(*(torch.from_numpy(x) for x in (q, k, v)), 64, 4, causal=True)
    want = jref.mha_reference(*(jnp.asarray(x) for x in (q, k, v)), 64, 4, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_no_grad_takes_the_direct_path():
    """Without grad (every serving path) flash_attention calls the forward
    directly: no autograd Function, no grad_fn."""
    q, k, v, _ = _inputs(1, 2, 2, 16, 16, 32, seed=8)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    assert tfa.flash_attention(*t, causal=True).grad_fn is None
    r = [x.clone().requires_grad_() for x in t]
    with torch.no_grad():
        o = tfa.flash_attention(*r, causal=True)
    assert o.grad_fn is None and not o.requires_grad
    torch.testing.assert_close(o, tfa.flash_attention(*t, causal=True), atol=0, rtol=0)
