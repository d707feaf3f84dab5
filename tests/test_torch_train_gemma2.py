"""PyTorch port vs JAX package: training a Gemma-2-shaped model, whose
attention runs at head_dim 256 (the flash backward's d=256 instances,
TPU kernels `_bwd_dkv_kernel` and `_bwd_dq_kernel`).

The config is Gemma-2's in miniature, the same in both packages: head_dim
256, 4 q over 2 kv heads, hidden 128, 2 layers, a 16-key window on layer 0
and full attention on layer 1, attention softcap 50 and final softcap 30,
sandwich norms, (1 + w) RMSNorms, the embedding scale, query_pre_attn_scalar
256 and gelu_tanh, on 2 x 48 tokens (the window bites). JAX differentiates
through its flash attention's custom VJP (Pallas in interpret mode); the
port through its `torch.autograd.Function`, whose backward on the CPU is
`_flash_bwd_plain`. Parameters are carried across by `params_from_numpy`.

Tolerances, those of test_torch_train.py (TOL there), per leaf, with G =
max|g_jax| of the leaf: f32, summation order only: loss 1e-6 relative,
gradients 1e-5 G, updated parameters 1e-6 |p| + lr 1e-5 G. bf16:
activations round to bf16 at other places in the two frameworks, so the
loss may move by 2e-3 relative, a gradient by 2^-4 G and an updated
parameter by 2^-7 |p| + lr 2^-4 G.

`_flash_bwd_plain` at d=256 against JAX's `_bwd_pallas` on the same
residuals, with the tolerances of test_torch_flash_bwd.py (`_close` there):
f32 2e-5 (1 + max|want|); bf16 2^-7 |want| + 2^-7 max|want|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from quantizedmha_tpu_torch.ops import cuda_lib
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_flash_bwd import _close, _inputs
from test_torch_train import TOL, _f32, _grads

jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention")

LR = 1e-2
D = 256
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
GEMMA2_TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_layers=2,
                   num_heads=4, num_kv_heads=2, head_dim=D, rope_theta=10000.0,
                   window_pattern=(16, None), hidden_act="gelu_tanh", sandwich_norms=True,
                   rms_plus_one=True, embed_scale=True, query_pre_attn_scalar=256.0,
                   logit_softcap=50.0, final_logit_softcap=30.0)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(3).integers(0, 256, (2, 48)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(tokens):
    """Per dtype: (JAX params as numpy, loss, grads, sgd_train_step's new
    params and loss), computed once."""
    out = {}
    for name, (_, jdt) in DTYPES.items():
        cfg = jl.LlamaConfig(dtype=jdt, **GEMMA2_TINY)
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
    cfg = tl.LlamaConfig(dtype=DTYPES[name][0], **GEMMA2_TINY)
    return cfg, params_from_numpy(np_params, device="cpu")


def test_config_is_gemma2_shaped():
    """The tiny config keeps every Gemma-2 piece of LlamaConfig.gemma2_9b()
    but its widths and depth, and its windows alternate as the preset's."""
    cfg, full = tl.LlamaConfig(**GEMMA2_TINY), tl.LlamaConfig.gemma2_9b()
    for f in ("head_dim", "hidden_act", "sandwich_norms", "rms_plus_one", "embed_scale",
              "query_pre_attn_scalar", "logit_softcap", "final_logit_softcap", "rope_theta"):
        assert getattr(cfg, f) == getattr(full, f), f
    assert full.layer_windows[:2] == (4096, None) and cfg.layer_windows == (16, None)
    assert cfg.num_heads // cfg.num_kv_heads == full.num_heads // full.num_kv_heads


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_gradients_match_jax(name, tokens, jax_runs):
    """The loss and every leaf's gradient against jax.value_and_grad."""
    np_params, jloss, jgrads, *_ = jax_runs[name]
    cfg, params = _port(name, np_params)
    with torch.no_grad():
        loss = tl.loss_fn(cfg, params, torch.from_numpy(tokens))
    assert abs(float(loss) - jloss) <= TOL[name]["loss"] * abs(jloss)
    got, want = _f32(params_to_numpy(_grads(cfg, params, tokens))), _f32(jgrads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        tol = TOL[name]["grad"] * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol, f"{jax.tree_util.keystr(path)}: {err} > {tol}"


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_sgd_train_step_matches_jax(name, tokens, jax_runs):
    """One step: the loss and every updated leaf against JAX's
    sgd_train_step."""
    np_params, _, jgrads, jnew, jloss = jax_runs[name]
    cfg, params = _port(name, np_params)
    out, loss = tl.sgd_train_step(cfg, params, torch.from_numpy(tokens), lr=LR)
    assert abs(float(loss) - jloss) <= TOL[name]["loss"] * abs(jloss)
    got, want = _f32(params_to_numpy(out)), _f32(jnew)
    grad_tol = jax.tree.leaves(jax.tree.map(lambda g: TOL[name]["grad"] * float(np.abs(
        np.asarray(g, np.float32)).max()), jgrads))
    for (path, w), g, gt in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got),
                                grad_tol):
        tol = TOL[name]["param"] * np.abs(w) + LR * gt
        assert (np.abs(g - w) <= tol).all(), jax.tree_util.keystr(path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bwd_plain_matches_bwd_pallas_at_256(dtype):
    """_flash_bwd_plain at d=256 against JAX's _bwd_pallas on JAX's forward
    residuals: GQA 2, softcap 50, a window of 30 with 4 sinks, offsets
    (q 20, kv 0) and a dlse cotangent."""
    q, k, v, do = _inputs(1, 4, 2, 60, 80, D, seed=31)
    dlse = np.random.default_rng(32).normal(0, 1, (1, 4, 60)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    kw = dict(window=30, softcap=50.0, sinks=4)
    sm = D ** -0.5
    o, lse = jfa._fwd(jq, jk, jv, sm_scale=sm, causal=True, block_q=None, block_kv=None,
                      save_residuals=True, q_offset=20, kv_offset=0, **kw)
    want = jfa._bwd_pallas(sm, True, jq, jk, jv, o, lse, jdo, dlse=jnp.asarray(dlse),
                           q_offset=20, kv_offset=0, **kw)
    tt = [torch.from_numpy(np.array(x, np.float32)).to(dtype) for x in (jq, jk, jv, o, jdo)]
    got = tfa._flash_bwd_plain(
        tt[0], tt[1], tt[2], tt[3], torch.from_numpy(np.array(lse)), tt[4],
        tfa._offsets(20, 0, 1, "cpu"), torch.from_numpy(dlse), sm_scale=sm, causal=True, **kw)
    for g, gw, n in zip(got, want, "qkv"):
        assert g.dtype == dtype
        _close(g, gw, dtype, f"d{n}")


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_launch_carries_head_dim_256(name, monkeypatch):
    """The backward at d=256, f32 and bf16, builds both launches (no card
    needed; the stream is stubbed): dK/dV then dQ, each with D = 256, the
    bf16 flag of the dtype (0 in f32: the CUDA-core kernels), Gemma-2's
    masks and softcap, and outputs of the inputs' shapes and dtype."""
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    dtype = DTYPES[name][0]
    q = torch.zeros((1, 4, 48, D), dtype=dtype)
    kv = torch.zeros((1, 2, 48, D), dtype=dtype)
    launches, (dq, dk, dv), _ = tfa._flash_bwd_launch(
        q, kv, kv, q, torch.zeros((1, 4, 48)), q, tfa._offsets(0, 0, 1, q.device),
        torch.zeros((1, 4, 48)), sm_scale=D**-0.5, causal=True, window=16, softcap=50.0,
        sinks=0)
    assert [k for k, _ in launches] == [tfa.FLASH_BWD_DKV, tfa.FLASH_BWD_DQ]
    for kernel, args in launches:
        assert kernel.launches == 0
        # (B, H, Hkv, Sq, Skv, D, sm_scale, has_softcap, softcap, causal,
        #  window, sinks, bf16, stream) end each argument list.
        assert args[-14:-8] == (1, 4, 2, 48, 48, D)
        assert args[-7:-1] == (1, 50.0, 1, 16, 0, int(dtype == torch.bfloat16))
    assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype

