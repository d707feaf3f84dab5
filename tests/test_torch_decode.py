"""PyTorch port vs JAX package: paged INT8-KV decode attention
(ops/decode.py:paged_decode_attention). JAX runs its Pallas decode kernels
in interpret mode; the port runs the plain PyTorch page walk.

Tolerance: both sides compute in f32 from the same int8 pages and scales;
they differ only in summation order and in where the V scale is applied
(the JAX kernel folds several pages per grid step and moves the V scale
onto P; the port scales each page's P·V). That is a few f32 ulps:
rtol = atol = 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.ops.decode import paged_decode_attention as jdecode
from quantizedmha_tpu_torch.ops.decode import paged_decode_attention as tdecode


def _cache(hkv, num_pages, page, d, seed, layers=None):
    rng = np.random.default_rng(seed)
    lead = (layers,) if layers else ()
    kp = rng.integers(-127, 128, lead + (hkv, num_pages, page, d)).astype(np.int8)
    vp = rng.integers(-127, 128, lead + (hkv, num_pages, page, d)).astype(np.int8)
    ks = rng.uniform(0.002, 0.02, lead + (hkv, num_pages)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, lead + (hkv, num_pages)).astype(np.float32)
    return kp, vp, ks, vs


def _case(hq, hkv, d, lengths, page=16, max_pages=4, seed=0, layers=None):
    rng = np.random.default_rng(seed + 100)
    batch = len(lengths)
    num_pages = batch * max_pages + 1
    tables = (rng.permutation(num_pages - 1)[:batch * max_pages] + 1).reshape(
        batch, max_pages).astype(np.int32)
    q = rng.normal(0, 1, (batch, hq, d)).astype(np.float32)
    return (q, *_cache(hkv, num_pages, page, d, seed, layers),
            np.asarray(lengths, np.int32), tables)


def _both(args, **kw):
    got = tdecode(*(torch.from_numpy(a) for a in args), **kw)
    want = jdecode(*(jnp.asarray(a) for a in args), **kw)
    return got, want


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (4, 2, 128), (4, 1, 32), (8, 1, 128)])
def test_paged_decode_matches_jax(hq, hkv, d):
    args = _case(hq, hkv, d, lengths=[1, 16, 17, 50], seed=hq + d)
    got, want = _both(args)
    assert got.shape == (4, hq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,sinks", [(20, 0), (20, 3), (5, 0)])
def test_paged_decode_window_matches_jax(window, sinks):
    args = _case(4, 2, 32, lengths=[3, 30, 41, 64], seed=7)
    got, want = _both(args, window=window, attention_sinks=sinks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_paged_decode_softcap_and_residuals_match_jax():
    args = _case(4, 2, 64, lengths=[9, 33, 48], seed=8)
    (o, lse), (jo, jlse) = _both(args, logit_softcap=3.0, save_residuals=True,
                                 sm_scale=0.2)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)


def test_paged_decode_stacked_layer_matches_jax():
    args = _case(4, 2, 32, lengths=[5, 40], seed=9, layers=3)
    layer = 2
    got = tdecode(*(torch.from_numpy(a) for a in args), layer=layer)
    want = jdecode(*(jnp.asarray(a) for a in args), layer=jnp.int32(layer))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tdecode(*(torch.from_numpy(a) for a in args))


def test_paged_decode_bf16_query_keeps_dtype():
    q, *rest = _case(4, 2, 32, lengths=[7, 20], seed=10)
    out = tdecode(torch.from_numpy(q).to(torch.bfloat16), *(torch.from_numpy(a) for a in rest))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_sinks_without_window_raise():
    args = _case(4, 2, 32, lengths=[7], seed=11)
    with pytest.raises(ValueError):
        tdecode(*(torch.from_numpy(a) for a in args), attention_sinks=2)
