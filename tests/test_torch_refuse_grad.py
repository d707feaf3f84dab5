"""PyTorch port vs JAX package: the kernels with no backward.

`jax.grad` through the JAX package's paged decode and prefill attention
(INT8 and INT4 caches) and its fused w4 matmul raises. The port's entry
points raise NotImplementedError when their float input requires grad, on
the CPU as on the card (where the kernel's output would carry no autograd
history and drop the gradient without a word), and run under
`torch.no_grad()` or without `requires_grad`. qdense's dequantize-then-
matmul route for more than 64 rows stays differentiable in x, in JAX and
here: its gradient equals `jax.grad` through the JAX qdense to 2e-5 (1 +
max|g|) (f32 on both sides, summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.ops import decode as jdec
from quantizedmha_tpu.ops import paged_prefill as jpre
from quantizedmha_tpu.ops import w4_matmul as jw4
from quantizedmha_tpu.quant import weights as jw
from quantizedmha_tpu_torch.ops import decode as tdec
from quantizedmha_tpu_torch.ops import paged_prefill as tpre
from quantizedmha_tpu_torch.ops import w4_matmul as tw4
from quantizedmha_tpu_torch.quant import weights as tw

HKV, PAGE, D, PAGES = 2, 16, 32, 5


def _cache(int4, rng):
    width = D // 2 if int4 else D
    kp, vp = rng.integers(-127, 128, (2, HKV, PAGES, PAGE, width)).astype(np.int8)
    ks, vs = rng.uniform(0.002, 0.02, (2, HKV, PAGES)).astype(np.float32)
    return kp, vp, ks, vs


def _decode_case(int4):
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, 4, D)).astype(np.float32)
    rest = (*_cache(int4, rng), np.array([5, 20], np.int32), np.array([[1, 2], [3, 4]], np.int32))
    return q, rest


def _prefill_case(int4):
    rng = np.random.default_rng(2)
    q = rng.normal(0, 1, (2, 4, 8, D)).astype(np.float32)
    rest = (*_cache(int4, rng), np.array([5, 20], np.int32), np.array([0, 12], np.int32),
            np.array([[1, 2], [3, 4]], np.int32))
    return q, rest


def _w4_case():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.1, (256, 96)).astype(np.float32)
    x = rng.normal(0, 1, (4, 256)).astype(np.float32)
    jq = jw.quantize_weight4(jnp.asarray(w), group=64, packing="halves")
    tq = tw.quantize_weight4(torch.from_numpy(w), group=64, packing="halves")
    kw = dict(group=64, packing="halves")
    return x, (jq.packed, jq.scale), (tq.packed, tq.scale), kw


# name: (JAX function, port function, case builder)
ENTRIES = {
    "paged_decode": (jdec.paged_decode_attention, tdec.paged_decode_attention,
                     lambda: _decode_case(False)),
    "paged_decode_int4": (jdec.paged_decode_attention_int4, tdec.paged_decode_attention_int4,
                          lambda: _decode_case(True)),
    "paged_prefill": (jpre.paged_prefill_attention, tpre.paged_prefill_attention,
                      lambda: _prefill_case(False)),
    "paged_prefill_int4": (jpre.paged_prefill_attention_int4,
                           tpre.paged_prefill_attention_int4, lambda: _prefill_case(True)),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_paged_attention_refuses_grad_like_jax(name):
    jfn, tfn, case = ENTRIES[name]
    q, rest = case()
    with pytest.raises(Exception):
        jax.grad(lambda a: jnp.sum(jfn(a, *(jnp.asarray(x) for x in rest))))(jnp.asarray(q))
    t_rest = [torch.from_numpy(x) for x in rest]
    with pytest.raises(NotImplementedError, match="not differentiable"):
        tfn(torch.from_numpy(q).requires_grad_(), *t_rest)
    with torch.no_grad():
        under_no_grad = tfn(torch.from_numpy(q).requires_grad_(), *t_rest)
    plain = tfn(torch.from_numpy(q), *t_rest)
    assert plain.grad_fn is None and torch.isfinite(plain).all()
    torch.testing.assert_close(under_no_grad, plain, atol=0, rtol=0)


def test_w4_matmul_refuses_grad_like_jax():
    x, (jp, js), (tp, ts), kw = _w4_case()
    with pytest.raises(Exception):
        jax.grad(lambda a: jnp.sum(jw4.w4_matmul(a, jp, js, **kw)))(jnp.asarray(x))
    with pytest.raises(NotImplementedError, match="not differentiable"):
        tw4.w4_matmul(torch.from_numpy(x).requires_grad_(), tp, ts, **kw)
    with torch.no_grad():
        under_no_grad = tw4.w4_matmul(torch.from_numpy(x).requires_grad_(), tp, ts, **kw)
    plain = tw4.w4_matmul(torch.from_numpy(x), tp, ts, **kw)
    assert plain.grad_fn is None and torch.isfinite(plain).all()
    torch.testing.assert_close(under_no_grad, plain, atol=0, rtol=0)


def test_qdense_prefill_route_stays_differentiable_like_jax():
    """128 rows of x against a w4 weight: qdense takes the dequantize-then-
    matmul route (not w4_matmul), and its gradient in x equals JAX's."""
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.1, (256, 96)).astype(np.float32)
    x = rng.normal(0, 1, (128, 256)).astype(np.float32)
    cot = rng.normal(0, 1, (128, 96)).astype(np.float32)
    jq = jw.quantize_weight4(jnp.asarray(w), group=64, packing="halves")
    tq = tw.quantize_weight4(torch.from_numpy(w), group=64, packing="halves")
    want = np.asarray(jax.grad(lambda a: jnp.sum(jw.qdense(a, jq) * cot))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (tw.qdense(xt, tq) * torch.from_numpy(cot)).sum().backward()
    got = xt.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * (1 + np.abs(want).max()))
