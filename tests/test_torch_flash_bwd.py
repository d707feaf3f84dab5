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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def _rounding_case(dtype):
    """Residuals (o, lse from the port's forward) of a GQA causal case at
    explicit offsets with softcap and a dlse, and the plain backward's f32
    sums (`_bwd_sums`, before the cast) on them."""
    q, k, v, do = _inputs(1, 4, 2, 40, 56, 32, seed=21)
    dlse = torch.from_numpy(np.random.default_rng(22).normal(0, 1, (1, 4, 40)).astype(np.float32))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    offsets = tfa._offsets(16, 0, 1, "cpu")
    kw = dict(sm_scale=32 ** -0.5, causal=True, window=None, softcap=6.0, sinks=0)
    o, lse = tfa._flash_fwd_plain(tq, tk, tv, offsets, block_kv=56, save_residuals=True, **kw)
    sums = tfa._bwd_sums(tq, tk, tv, o, lse, tdo, offsets, dlse, **kw)
    q_pos, k_pos = tfa._bwd_positions(offsets, 40, 56)
    di = tfa._bwd_di(o, tdo, dlse)
    pairs = [tfa._bwd_pairs(tq[:, 2 * h:2 * h + 2], tk[:, h], tv[:, h], tdo[:, 2 * h:2 * h + 2],
                            lse[:, 2 * h:2 * h + 2], di[:, 2 * h:2 * h + 2], q_pos, k_pos, **{
                                n: kw[n] for n in ("sm_scale", "causal", "window", "softcap",
                                                   "sinks")})
             for h in range(2)]
    return (tq, tk, tdo), pairs, sums


def _np_second_products(tq, tk, tdo, pairs, round_bf16):
    """dQ, dK, dV in f64 numpy from the f32 p and ds of each kv head's group,
    rounded to bf16 by ml_dtypes (jnp.bfloat16) first when round_bf16."""
    q, k, do = (x.float().numpy().astype(np.float64) for x in (tq, tk, tdo))
    dq, dk, dv = np.zeros(q.shape), np.zeros(k.shape), np.zeros(k.shape)
    for h, (p, _, ds) in enumerate(pairs):
        p, ds = p.numpy(), ds.numpy()
        if round_bf16:
            p, ds = (x.astype(jnp.bfloat16).astype(np.float32) for x in (p, ds))
        p, ds = p.astype(np.float64), ds.astype(np.float64)
        grp = slice(2 * h, 2 * h + 2)
        dv[:, h] = np.einsum("bgqk,bgqd->bkd", p, do[:, grp])
        dk[:, h] = np.einsum("bgqk,bgqd->bkd", ds, q[:, grp])
        dq[:, grp] = ds @ k[:, h][:, None]
    return dq, dk, dv


def _within_f32(got, want):
    err = np.abs(got.numpy() - want)
    return float((err / (F32_TOL * (1.0 + np.abs(want).max()))).max())


def test_bwd_plain_bf16_rounds_p_and_ds():
    """bf16 inputs: the plain backward's f32 sums equal an f64 numpy
    computation that rounds P and dS to bf16 (ml_dtypes) before dV = PᵀdO,
    dK = dSᵀQ and dQ = dS·K, at the f32 tolerance; without that rounding
    they differ by more (the rounding is what the kernel and the TPU's
    Precision.DEFAULT do)."""
    ops, pairs, sums = _rounding_case(torch.bfloat16)
    rounded = _np_second_products(*ops, pairs, round_bf16=True)
    exact = _np_second_products(*ops, pairs, round_bf16=False)
    for g, want, n in zip(sums, rounded, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        assert _within_f32(g, want) <= 1.0, n
    assert max(_within_f32(g, w) for g, w in zip(sums, exact)) > 1.0


def test_bwd_plain_f32_does_not_round():
    """f32 inputs (Precision.HIGHEST on the TPU): no bf16 rounding of P or
    dS. The plain backward equals the unrounded f64 computation at the f32
    tolerance and differs from the rounded one, and equals JAX's
    _bwd_pallas at 2e-5."""
    ops, pairs, sums = _rounding_case(torch.float32)
    exact = _np_second_products(*ops, pairs, round_bf16=False)
    rounded = _np_second_products(*ops, pairs, round_bf16=True)
    for g, want, n in zip(sums, exact, ("dq", "dk", "dv")):
        assert _within_f32(g, want) <= 1.0, n
    assert max(_within_f32(g, w) for g, w in zip(sums, rounded)) > 1.0
    q, k, v, do = _inputs(1, 4, 2, 40, 56, 32, seed=21)
    dlse = np.random.default_rng(22).normal(0, 1, (1, 4, 40)).astype(np.float32)
    sm = 32 ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._fwd(jq, jk, jv, sm_scale=sm, causal=True, block_q=None, block_kv=None,
                      save_residuals=True, q_offset=16, kv_offset=0, window=None, softcap=6.0,
                      sinks=0)
    want = jfa._bwd_pallas(sm, True, jq, jk, jv, o, lse, jdo, dlse=jnp.asarray(dlse),
                           q_offset=16, kv_offset=0, window=None, softcap=6.0, sinks=0)
    got = tfa._flash_bwd_plain(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)),
        tfa._offsets(16, 0, 1, "cpu"), torch.from_numpy(dlse), sm_scale=sm, causal=True,
        window=None, softcap=6.0, sinks=0)
    for g, gw, n in zip(got, want, "qkv"):
        _close(g, gw, torch.float32, f"d{n}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chip_smoke_flash_bwd_check_holds_jax_and_catches_faults(dtype):
    """chip_smoke.py holds the two backward kernels to _flash_bwd_plain with
    per-element bounds (flash_bwd_tolerances). JAX's _bwd_pallas on the same
    residuals (another summation order; on the CPU in f32, P and dS never
    rounded to bf16) stands in for the kernels and must pass; the plain
    version with a planted fault (the group's last q head left out of dV;
    the causal diagonal shifted by one) must fail."""
    import chip_smoke

    b, h, hkv, s, d = 1, 4, 2, 128, 64
    q, k, v, do = _inputs(b, h, hkv, s, s, d, seed=31)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, do))
    offs = tfa._offsets(0, 0, b, "cpu")
    kw = dict(sm_scale=d**-0.5, causal=True, window=None, softcap=None, sinks=0)
    o, lse = tfa._flash_fwd_plain(tq, tk, tv, offs, block_kv=s, save_residuals=True, **kw)
    plain = tfa._flash_bwd_plain(tq, tk, tv, o, lse, tdo, offs, **kw)
    tols = chip_smoke.flash_bwd_tolerances(tq, tk, tv, o, lse, tdo, None, offs, plain, **kw)
    jdt = _jdt(dtype)
    j = [jnp.asarray(x.float().numpy(), jdt) for x in (tq, tk, tv, o, tdo)]
    want = jfa._bwd_pallas(kw["sm_scale"], True, j[0], j[1], j[2], j[3],
                           jnp.asarray(lse.numpy()), j[4])
    for g, p, t, n in zip(want, plain, tols, "qkv"):
        got = torch.from_numpy(np.array(g, np.float32)).to(dtype)
        assert chip_smoke.err_over_tol(got, p, t) <= 1.0, f"d{n}"
    no_head = tdo.clone()
    no_head[:, 1::2] = 0  # the last q head of each kv head's group
    dv_fault = tfa._flash_bwd_plain(tq, tk, tv, o, lse, no_head, offs, **kw)[2]
    assert chip_smoke.err_over_tol(dv_fault, plain[2], tols[2]) > 5.0
    shifted = tfa._flash_bwd_plain(tq, tk, tv, o, lse, tdo, tfa._offsets(1, 0, b, "cpu"), **kw)
    assert max(chip_smoke.err_over_tol(g, p, t) for g, p, t in zip(shifted, plain, tols)) > 5.0



@pytest.mark.parametrize("data", ["random", "grid"])
def test_chip_smoke_flash_bwd_check_f32_d256_holds_jax_and_sees_bf16_ds(data, monkeypatch):
    """The card's gate on the f32 backward at d=256 (Gemma-2 trained in
    f32): chip_smoke.flash_bwd_tolerances in f32, at 1 x 4/2 heads x 64
    tokens with softcap 50, a window of 30 and a dlse cotangent, holds JAX's
    _bwd_pallas (interpret mode, Precision.HIGHEST: another summation order)
    against _flash_bwd_plain, and rejects the plain version with dS rounded
    to bf16 before the second products (what the f32 route must never do)
    in dQ and dK. On random normal inputs the bound of two summation orders
    over 256 products leaves the rounding just over it (> 1); on
    chip_smoke's grid (flash_bwd_grid_inputs: exact raw dots, held with
    exact_dots) by more than 10x, as the faults phase requires of a d=256
    fault."""
    import chip_smoke

    d, s, sm = 256, 64, 256 ** -0.5
    if data == "grid":
        case = (1, 4, 2, s, s, 30)
        q, k, v, do, dlse, _ = (x.numpy() for x in chip_smoke.flash_bwd_grid_inputs(
            torch.Generator().manual_seed(41), case, device="cpu"))
    else:
        q, k, v, do = _inputs(1, 4, 2, s, s, d, seed=41)
        dlse = np.random.default_rng(42).normal(0, 1, (1, 4, s)).astype(np.float32)
    masks = dict(window=30, softcap=50.0, sinks=0)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, lse = jfa._fwd(jq, jk, jv, sm_scale=sm, causal=True, block_q=None, block_kv=None,
                      save_residuals=True, q_offset=0, kv_offset=0, **masks)
    want = jfa._bwd_pallas(sm, True, jq, jk, jv, o, lse, jdo, dlse=jnp.asarray(dlse),
                           q_offset=0, kv_offset=0, **masks)
    tq, tk, tv, to, tlse, tdo = (torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do))
    offs, tdlse = tfa._offsets(0, 0, 1, "cpu"), torch.from_numpy(dlse)
    kw = dict(sm_scale=sm, causal=True, **masks)
    plain = tfa._flash_bwd_plain(tq, tk, tv, to, tlse, tdo, offs, tdlse, **kw)
    tols = chip_smoke.flash_bwd_tolerances(tq, tk, tv, to, tlse, tdo, tdlse, offs, plain,
                                           exact_dots=data == "grid", **kw)
    for g, p, t, n in zip(want, plain, tols, "qkv"):
        got = torch.from_numpy(np.array(g, np.float32))
        assert chip_smoke.err_over_tol(got, p, t) <= 1.0, f"d{n}"
    pairs = tfa._bwd_pairs

    def ds_in_bf16(*a, **kw):
        p, dp, ds = pairs(*a, **kw)
        return p, dp, ds.to(torch.bfloat16).float()
    monkeypatch.setattr(tfa, "_bwd_pairs", ds_in_bf16)
    rounded = tfa._flash_bwd_plain(tq, tk, tv, to, tlse, tdo, offs, tdlse, **kw)
    floor = 10.0 if data == "grid" else 1.0
    for i in (0, 1):  # dQ = dS·K, dK = dSᵀQ
        assert chip_smoke.err_over_tol(rounded[i], plain[i], tols[i]) > floor, "dqk"[i]
