"""PyTorch port vs JAX package: quantization passes and the paged-cache
bookkeeping. Quantized payloads and scales must match BIT FOR BIT (both
frameworks divide in f32 and round half to even); the allocator must make
the same decisions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.ops import quantize as jq
from quantizedmha_tpu.quant import weights as jw
from quantizedmha_tpu.serving import kv_cache as jkv
from quantizedmha_tpu_torch.ops import quantize as tq
from quantizedmha_tpu_torch.quant import weights as tw
from quantizedmha_tpu_torch.serving import kv_cache as tkv


def _data(shape, seed, outliers=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, shape).astype(np.float32)
    if outliers:
        x.flat[rng.integers(0, x.size, 3)] *= 40.0
        x[..., :2, :] *= 1e-9  # near-zero rows exercise the clamp
    return x


def _eq(a_t, b_j):
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(b_j))


@pytest.mark.parametrize("shape,block", [((2, 3, 64, 32), 16), ((1, 2, 96, 128), 32),
                                         ((1, 1, 40, 64), 40)])
def test_quantize_kv_blocks_bit_exact(shape, block):
    x = _data(shape, 0)
    tv, ts = tq.quantize_kv_blocks(torch.from_numpy(x), block)
    jv, js = jq.quantize_kv_blocks(jnp.asarray(x), block)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tv, jv)
    _eq(ts, js)
    # dequantize is one f32 multiply per element: bit-exact too
    _eq(tq.dequantize_kv_blocks(tv, ts, block), jq.dequantize_kv_blocks(jv, js, block))


def test_true_div_is_ieee_division():
    # bf16-valued amaxes over 127 (the quant scales) and a softcap: the
    # quotient must be the correctly rounded f32 one that JAX computes.
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 8, 4096).astype(np.float32)).bfloat16().float()
    for c in (127.0, 30.0):
        _eq(tq.true_div(x, c), jnp.asarray(x.numpy()) / jnp.float32(c))


def test_quantize_kv_blocks_rejects_ragged_seq():
    with pytest.raises(ValueError):
        tq.quantize_kv_blocks(torch.zeros(1, 1, 10, 8), 4)


@pytest.mark.parametrize("shape,dtype", [((64, 48), np.float32), ((3, 32, 16), np.float32),
                                         ((64, 48), "bf16")])
def test_quantize_weight_bit_exact(shape, dtype):
    w = _data(shape, 1, outliers=False)
    if dtype == "bf16":
        wt = torch.from_numpy(w).to(torch.bfloat16)
        wj = jnp.asarray(w).astype(jnp.bfloat16)
    else:
        wt, wj = torch.from_numpy(w), jnp.asarray(w)
    t = tw.quantize_weight(wt)
    j = jw.quantize_weight(wj)
    _eq(t.values, j.values)
    _eq(t.scale, j.scale)
    if dtype != "bf16":  # the input is untouched
        np.testing.assert_array_equal(wt.numpy(), w)


@pytest.mark.parametrize("shape", [(2, 16, 32), (4, 8, 128)])
def test_quantize_page_bit_exact(shape):
    x = _data(shape, 2)
    tv, ts = tkv.quantize_page(torch.from_numpy(x))
    jv, js = jkv.quantize_page(jnp.asarray(x))
    _eq(tv, jv)
    _eq(ts, js)


def _states(hkv=2, pages=6, page=4, d=8, seed=3):
    rng = np.random.default_rng(seed)
    kp = rng.integers(-127, 128, (hkv, pages, page, d)).astype(np.int8)
    vp = rng.integers(-127, 128, (hkv, pages, page, d)).astype(np.int8)
    ks = rng.uniform(0.01, 0.05, (hkv, pages)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, (hkv, pages)).astype(np.float32)
    t = tkv.PagedKVCacheState(*(torch.from_numpy(a.copy()) for a in (kp, vp, ks, vs)))
    j = jkv.PagedKVCacheState(*(jnp.asarray(a) for a in (kp, vp, ks, vs)))
    return t, j


def _state_eq(t, j):
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        _eq(getattr(t, name), getattr(j, name))


def test_write_pages_bit_exact():
    t, j = _states()
    k = _data((2, 8, 8), 4)
    v = _data((2, 8, 8), 5)
    ids = np.array([4, 1], np.int32)
    tkv.write_pages(t, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(ids), 4)
    j = jkv.write_pages(j, jnp.asarray(k), jnp.asarray(v), jnp.asarray(ids), 4)
    _state_eq(t, j)


def test_append_slot0_fit_then_clamp_bit_exact():
    """A page's scale is fitted by its slot-0 token; later tokens (here up
    to 3x larger) are quantized with that scale and clamped into +-127."""
    t, j = _states()
    rng = np.random.default_rng(6)
    page_ids = np.array([2, 5, 0], np.int32)
    for slot, mag in ((0, 1.0), (1, 3.0), (2, 0.5), (3, 1.0)):
        k = (rng.normal(0, 1, (3, 2, 8)) * mag).astype(np.float32)
        v = (rng.normal(0, 1, (3, 2, 8)) * mag).astype(np.float32)
        slots = np.full(3, slot, np.int32)
        tkv.append_tokens_batched(t, torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(page_ids), torch.from_numpy(slots))
        j = jkv.append_tokens_batched(j, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(page_ids), jnp.asarray(slots))
        _state_eq(t, j)
    assert (t.k_pages.abs() == 127).any()  # the 3x token was clamped


def test_layer_view_appends_in_place():
    st = tkv.PagedKVCacheState.create(2, 4, 4, 8, num_layers=3, device="cpu")
    k = torch.ones(1, 2, 8)
    tkv.append_tokens_batched(st.layer(1), k, 2 * k, torch.tensor([3]), torch.tensor([0]))
    assert st.k_pages[1, :, 3, 0].eq(127).all() and st.k_pages[0].eq(0).all()
    assert torch.allclose(st.v_scales[1, :, 3], torch.full((2,), 2 / 127))


def _drive(alloc_cls):
    a = alloc_cls(10, 4, scrap_page=0)
    log = [a.admit(0, 6), a.admit(1, 3)]
    log += [a.extend(0) for _ in range(5)] + [a.extend(1)]
    a.share([a.tables[0][0]])
    log.append(a.block_table_array([0, 1], 5).tolist())
    a.release(0)
    log += [a.free_pages, a.admit(2, 9)]
    log += [a.extend(2) for _ in range(12)]
    log += [a.trim_window(2, window=6, sinks=2), a.tables[2], a.free_pages]
    log.append(a.block_table_array([1, 2], 6).tolist())
    a.release(1)
    log += [a.free_pages, a.lengths_array([2]).tolist(), a.can_admit(40)]
    return log


def test_page_allocator_matches_jax():
    assert _drive(tkv.PageAllocator) == _drive(jkv.PageAllocator)
