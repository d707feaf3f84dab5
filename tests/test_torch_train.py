"""PyTorch port vs JAX package: training the Llama model (`loss_fn`,
`sgd_train_step`) on `LlamaConfig.tiny()` with parameters converted from
JAX's `init_params`. JAX differentiates through its flash attention's
custom VJP (Pallas in interpret mode); the port through its
`torch.autograd.Function`, whose backward on the CPU is `_flash_bwd_plain`.

Tolerances, per leaf, with g the leaf's gradient and G = max|g_jax|:
f32, everything computed in f32 on both sides, summation order only:
loss 1e-6 relative, gradients 1e-5 G (measured <= 1.1e-6 G), updated
parameters 1e-6 |p| + lr 1e-5 G. bf16 (the default): activations are
rounded to bf16 at other places in the two frameworks (XLA fuses
elementwise chains in f32), so the loss may move by 2e-3 relative and a
gradient, a sum over the batch's tokens of products of rounded
activations, by 2^-4 G (measured 0.011-0.027 G); an updated parameter by
one bf16 ulp of the result (2^-7 |p|) plus lr 2^-4 G.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LR = 1e-2
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": dict(loss=1e-6, grad=1e-5, param=1e-6),
       "bf16": dict(loss=2e-3, grad=2.0**-4, param=2.0**-7)}


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (2, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(tokens):
    """Per dtype: (JAX params as numpy, loss, grads, sgd_train_step's new
    params and loss), computed once."""
    out = {}
    for name, (_, jdt) in DTYPES.items():
        cfg = jl.LlamaConfig.tiny(dtype=jdt)
        params = jl.init_params(cfg, jax.random.PRNGKey(0))
        toks = jnp.asarray(tokens)
        # Under one jit: interpret-mode Pallas runs eagerly several times
        # slower, and one program compiles the two calls' shared work once.
        (loss, grads), (new, step_loss) = jax.jit(lambda p: (
            jax.value_and_grad(lambda q: jl.loss_fn(cfg, q, toks))(p),
            jl.sgd_train_step(cfg, p, toks, lr=LR)))(params)
        to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        out[name] = (to_np(params), float(loss), to_np(grads), to_np(new), float(step_loss))
    return out


def _port(name, np_params):
    dtype = DTYPES[name][0]
    return tl.LlamaConfig.tiny(dtype=dtype), params_from_numpy(np_params, device="cpu")


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _grads(cfg, params, tokens):
    """The gradient of every float leaf of loss_fn, in the params' layout
    (the per-layer leaves' gradients stacked)."""
    leaves = tl.float_leaves(params)
    tl.loss_fn(cfg, leaves, torch.from_numpy(tokens)).backward()
    grads = {k: v.grad for k, v in leaves.items() if k != "layers"}
    grads["layers"] = {k: torch.stack([r.grad for r in rows])
                       for k, rows in leaves["layers"].items()}
    return grads


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_loss_fn_matches_jax(name, tokens, jax_runs):
    np_params, jloss, *_ = jax_runs[name]
    cfg, params = _port(name, np_params)
    with torch.no_grad():
        loss = tl.loss_fn(cfg, params, torch.from_numpy(tokens))
    assert loss.dtype == torch.float32
    assert abs(float(loss) - jloss) <= TOL[name]["loss"] * abs(jloss)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_gradients_match_jax(name, tokens, jax_runs):
    np_params, jloss, jgrads, *_ = jax_runs[name]
    got, want = _f32(params_to_numpy(_grads(*_port(name, np_params), tokens))), _f32(jgrads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        tol = TOL[name]["grad"] * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{jax.tree_util.keystr(path)}: {err} > {tol}"


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_sgd_train_step_matches_jax(name, tokens, jax_runs):
    """One step: the loss and every updated leaf against JAX's
    sgd_train_step; the port updates in place and returns the same dict."""
    np_params, _, jgrads, jnew, jloss = jax_runs[name]
    cfg, params = _port(name, np_params)
    wq = params["layers"]["wq"]
    out, loss = tl.sgd_train_step(cfg, params, torch.from_numpy(tokens), lr=LR)
    assert out is params and out["layers"]["wq"] is wq and not loss.requires_grad
    assert abs(float(loss) - jloss) <= TOL[name]["loss"] * abs(jloss)
    got, want = _f32(params_to_numpy(out)), _f32(jnew)
    grad_tol = jax.tree.leaves(jax.tree.map(lambda g: TOL[name]["grad"] * float(np.abs(
        np.asarray(g, np.float32)).max()), jgrads))
    for (path, w), g, gt in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got),
                                grad_tol):
        tol = TOL[name]["param"] * np.abs(w) + LR * gt
        assert (np.abs(g - w) <= tol).all(), jax.tree_util.keystr(path)
    # The share of weights the step changed (in bf16 lr·g rounds away for
    # many) is JAX's, within 2 points.
    old = jax.tree.leaves(_f32(np_params))
    share = [np.mean([(a != b).mean() for a, b in zip(jax.tree.leaves(t), old)])
             for t in (got, want)]
    assert share[0] > 0.1 and abs(share[0] - share[1]) <= 0.02, share


def test_three_steps_lower_the_loss(tokens, jax_runs):
    """As tests/test_model.py:44 asks of JAX: the bf16 default config's loss
    falls over a few steps at lr 1e-2."""
    cfg, params = _port("bf16", jax_runs["bf16"][0])
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        l0 = float(tl.loss_fn(cfg, params, toks))
    losses = [float(tl.sgd_train_step(cfg, params, toks, lr=LR)[1]) for _ in range(3)]
    assert losses[0] == pytest.approx(l0, abs=1e-6)
    assert losses[-1] < l0, (l0, losses)


def test_reference_attention_trains_alike(tokens, jax_runs):
    """attention_impl="reference" (autograd through the golden) gives the
    flash path's gradients within the f32 tolerance."""
    grads = []
    for impl in ("flash", "reference"):
        cfg, params = _port("f32", jax_runs["f32"][0])
        cfg = dataclasses.replace(cfg, attention_impl=impl)
        grads.append(_grads(cfg, params, tokens)["layers"]["wq"])
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5 * float(grads[1].abs().max()),
                               rtol=0)


def test_flash_int8_raises_under_grad(tokens, jax_runs):
    """attention_impl="flash_int8" raises inside loss_fn under grad, as
    jax.grad through the JAX INT8 kernel does; without grad it runs."""
    cfg, params = _port("f32", jax_runs["f32"][0])
    cfg = dataclasses.replace(cfg, attention_impl="flash_int8")
    toks = torch.from_numpy(tokens)
    with pytest.raises(NotImplementedError, match="not differentiable"):
        tl.sgd_train_step(cfg, params, toks)
    with torch.no_grad():
        assert torch.isfinite(tl.loss_fn(cfg, params, toks))


def test_flash_int8_raises_under_grad_like_jax():
    """The INT8 attention itself, at (1, 2, 64, 32) causal: JAX's jax.grad
    fails, the port raises when an input requires grad (on the CPU as on
    the card) and runs when none does or grad is off."""
    from quantizedmha_tpu.ops.flash_attention_int8 import flash_attention_int8 as jint8
    from quantizedmha_tpu_torch.ops.flash_attention_int8 import flash_attention_int8 as tint8
    x = np.random.default_rng(1).normal(0, 1, (3, 1, 2, 64, 32)).astype(np.float32)
    with pytest.raises(Exception):
        jax.grad(lambda q: jnp.sum(jint8(q, x[1], x[2], causal=True)))(jnp.asarray(x[0]))
    q, k, v = (torch.from_numpy(a) for a in x)
    with pytest.raises(NotImplementedError):
        tint8(q.clone().requires_grad_(), k, v, causal=True)
    with pytest.raises(NotImplementedError):
        tint8(q, k.clone().requires_grad_(), v, causal=True)
    with torch.no_grad():
        tint8(q.clone().requires_grad_(), k, v, causal=True)
    assert tint8(q, k, v, causal=True).grad_fn is None


def test_quantized_weights_refuse_a_train_step(tokens, jax_runs):
    from quantizedmha_tpu_torch.quant.weights import quantize_llama_params
    cfg, params = _port("f32", jax_runs["f32"][0])
    with pytest.raises(TypeError, match="float parameters"):
        tl.sgd_train_step(cfg, quantize_llama_params(params, bits=8), torch.from_numpy(tokens))


def test_forward_without_grad_takes_the_direct_path(tokens, jax_runs, monkeypatch):
    """Serving calls the model with no input requiring grad (or under
    no_grad): flash_attention never enters its autograd Function, and the
    logits carry no grad_fn."""
    def refuse(*a, **k):
        raise AssertionError("the autograd Function was entered")
    monkeypatch.setattr(tfa._FlashAttention, "apply", refuse)
    cfg, params = _port("bf16", jax_runs["bf16"][0])
    toks = torch.from_numpy(tokens)
    assert tl.forward(cfg, params, toks).grad_fn is None
    with torch.no_grad():
        logits = tl.forward(cfg, tl.float_leaves(params), toks)
    assert logits.grad_fn is None
