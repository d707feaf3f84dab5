"""PyTorch port vs JAX package: the pieces of the mixed INT8-sink /
INT4-bulk KV cache. INT4 quantize / unpack / dequantize
(ops/quantize.py), merge_two_partials (parallel/combine.py), the INT4
decode and paged prefill (ops/decode.py, ops/paged_prefill.py), the mixed
attention, writes and appends (serving/mixed_kv.py) and MixedPageAllocator
(serving/kv_cache.py). JAX runs its Pallas kernels in interpret mode; the
port runs their plain versions. Inputs are made with numpy from a seed.

Tolerances: quantized payloads and scales bit for bit. Attention outputs
and lse rtol = atol = 1e-5: both sides compute in f32 from the same pages
and scales and differ in summation order only (JAX sums the two unpacked
halves' dots, the port one dot over the concatenated halves). The merge:
1e-6, f32 rounding of the same formula. The bf16-q INT4 prefill tests hold
chip_smoke.py's per-element bound of the tensor-core kernel (P rounded to
bf16 with the sub-tile V scale folded in) to an emulation of that rounding
and to JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.ops import quantize as jq
from quantizedmha_tpu.ops.decode import paged_decode_attention_int4 as jdecode4
from quantizedmha_tpu.ops.paged_prefill import paged_prefill_attention_int4 as jprefill4
from quantizedmha_tpu.parallel.combine import merge_two_partials as jmerge
from quantizedmha_tpu.serving import kv_cache as jkv
from quantizedmha_tpu.serving import mixed_kv as jmx
from quantizedmha_tpu_torch.ops import quantize as tq
from quantizedmha_tpu_torch.ops.decode import paged_decode_attention_int4 as tdecode4
from quantizedmha_tpu_torch.ops.paged_prefill import paged_prefill_attention_int4 as tprefill4
from quantizedmha_tpu_torch.parallel.combine import merge_two_partials as tmerge
from quantizedmha_tpu_torch.serving import kv_cache as tkv
from quantizedmha_tpu_torch.serving import mixed_kv as tmx
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


# --- ops/quantize.py -------------------------------------------------------


@pytest.mark.parametrize("scale_block", [None, 4])
def test_int4_quantize_unpack_dequantize_bit_exact(scale_block):
    """Payloads, scales, unpacked halves and dequantized values equal JAX's
    bit for bit, rounding ties (x / scale = 2.5, -3.5, 0.5) included."""
    x = np.random.default_rng(0).normal(0, 1, (2, 3, 16, 8)).astype(np.float32)
    x[0, 0, :4] = 0.0
    x[0, 0, 0, :4] = [7.0, 2.5, -3.5, 0.5]  # scale 1: ties round half to even
    jp, js = jq.quantize_kv_blocks_int4(jnp.asarray(x), 8, scale_block=scale_block)
    tp, ts = tq.quantize_kv_blocks_int4(torch.from_numpy(x), 8, scale_block=scale_block)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if scale_block == 4:
        lo = tq.unpack_int4_halves(tp)[0]
        assert lo[0, 0, 0, :4].tolist() == [7, 2, -4, 0]
    for t, j in zip(tq.unpack_int4_halves(tp), jq.unpack_int4_halves(jp)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    block = scale_block or 8
    np.testing.assert_array_equal(tq.dequantize_kv_blocks_int4(tp, ts, block).numpy(),
                                  np.asarray(jq.dequantize_kv_blocks_int4(jp, js, block)))


# --- parallel/combine.py ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_two_partials_matches_jax(dtype):
    """Rows finite in both, -inf in one partial, -inf in both (o = 0, lse =
    -inf); the output rounds to o_a's dtype once, after an f32 merge."""
    rng = np.random.default_rng(1)
    o_a, o_b = rng.normal(0, 1, (2, 2, 3, 5, 8)).astype(np.float32)
    lse_a, lse_b = rng.normal(0, 3, (2, 2, 3, 5)).astype(np.float32)
    lse_a[0, 0, :2] = -np.inf
    lse_b[0, 0, 1:3] = -np.inf
    lse_b[1, 2, 4] = -np.inf
    o_a[0, 0, :2] = 0.0
    o_b[0, 0, 1:3] = 0.0
    o_a_t, o_b_t = (torch.from_numpy(o).to(getattr(torch, dtype)) for o in (o_a, o_b))
    o, lse = tmerge(o_a_t, torch.from_numpy(lse_a), o_b_t, torch.from_numpy(lse_b))
    jo, jlse = jmerge(jnp.asarray(o_a_t.float().numpy()).astype(dtype), jnp.asarray(lse_a),
                      jnp.asarray(o_b_t.float().numpy()).astype(dtype), jnp.asarray(lse_b))
    assert o.dtype == o_a_t.dtype
    assert torch.all(o[0, 0, 1] == 0) and torch.isneginf(lse[0, 0, 1])
    _close(lse, jlse, 1e-6)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                               rtol=1e-6 if dtype == "float32" else 2**-7, atol=1e-6)


# --- INT4 attention ---------------------------------------------------------


def _int4_cache(hkv, d, page, subs, num_pages, rng):
    kp, vp = rng.integers(-128, 128, (2, hkv, num_pages, page, d // 2)).astype(np.int8)
    shape = (hkv, num_pages) if subs is None else (hkv, num_pages, subs)
    ks, vs = rng.uniform(0.02, 0.3, (2,) + shape).astype(np.float32)
    return kp, vp, ks, vs


def _tables(batch, max_pages, num_pages, rng):
    return (rng.permutation(num_pages - 1)[:batch * max_pages] + 1).reshape(
        batch, max_pages).astype(np.int32)


# (hq, hkv, d, subs (None: 2-D scales), kwargs)
INT4_CASES = {
    "subs1_2d": (4, 2, 32, None, {}),
    "subs4": (4, 2, 64, 4, {}),
    "window": (4, 2, 32, 4, dict(window=10)),
    "window_sinks": (4, 2, 32, 4, dict(window=10, attention_sinks=3)),
    "softcap_mqa": (4, 1, 128, 2, dict(logit_softcap=2.0, sm_scale=0.2)),
}


@pytest.mark.parametrize("case", list(INT4_CASES))
def test_int4_decode_matches_jax(case):
    """Lengths 0 (o = 0, lse = -inf), one page, page-ragged and full."""
    hq, hkv, d, subs, kw = INT4_CASES[case]
    rng = np.random.default_rng(len(case))
    page, max_pages = 16, 3
    cache = _int4_cache(hkv, d, page, subs, 8, rng)
    tables = _tables(3, 2, 8, rng)
    tables = np.concatenate([tables, tables[:, :1]], axis=1)[:, :max_pages]
    q = rng.normal(0, 1, (3, hq, d)).astype(np.float32)
    lengths = np.asarray([0, 17, 32], np.int32)
    o, lse = tdecode4(*_t(q, *cache, lengths, tables), save_residuals=True, **kw)
    jo, jlse = jdecode4(*_j(q, *cache, lengths, tables), save_residuals=True, **kw)
    _close(o, jo)
    _close(lse, jlse)
    assert torch.all(o[0] == 0) and torch.all(torch.isneginf(lse[0]))


@pytest.mark.parametrize("case", list(INT4_CASES))
def test_int4_prefill_matches_jax(case):
    """Three sequences: a chunk inside the context, one whose q_start is
    negative and straddles 0 within the tile (rows -5..6: the negative ones
    give o = 0, lse = -inf), and one wholly negative with length 0."""
    hq, hkv, d, subs, kw = INT4_CASES[case]
    rng = np.random.default_rng(len(case) + 50)
    cache = _int4_cache(hkv, d, 16, subs, 9, rng)
    tables = _tables(3, 2, 9, rng)
    q = rng.normal(0, 1, (3, hq, 12, d)).astype(np.float32)
    lengths = np.asarray([20, 7, 0], np.int32)
    starts = np.asarray([8, -5, -12], np.int32)
    o, lse = tprefill4(*_t(q, *cache, lengths, starts, tables), save_residuals=True, **kw)
    jo, jlse = jprefill4(*_j(q, *cache, lengths, starts, tables), save_residuals=True, **kw)
    _close(o, jo)
    _close(lse, jlse)
    assert torch.all(o[1, :, :5] == 0) and torch.all(torch.isneginf(lse[1, :, :5]))
    assert torch.isfinite(lse[1, :, 5:]).all() and torch.all(torch.isneginf(lse[2]))


def test_int4_shape_checks():
    rng = np.random.default_rng(3)
    kp, vp, ks, vs = _t(*_int4_cache(2, 32, 16, 4, 4, rng))
    q = torch.zeros((1, 4, 32))
    lengths, tables = torch.tensor([5]), torch.tensor([[1]])
    with pytest.raises(ValueError, match="sub-tiles"):
        tdecode4(q, kp, vp, ks, vs[..., :2], lengths, tables)
    with pytest.raises(ValueError, match="not a multiple"):
        tdecode4(q, kp, vp, ks[..., :3], vs[..., :3], lengths, tables)
    with pytest.raises(ValueError, match="head_dim // 2"):
        tdecode4(torch.zeros((1, 4, 64)), kp, vp, ks, vs, lengths, tables)


# --- serving/mixed_kv.py ----------------------------------------------------

BOUNDARY, PAGE, SUBS = 16, 8, 4


def _mixed_state(rng, hkv=2, d=32, n8=7, n4=12):
    """A one-layer mixed cache with random payloads and scales, as numpy."""
    k8, v8 = rng.integers(-127, 128, (2, hkv, n8, PAGE, d)).astype(np.int8)
    s8k, s8v = rng.uniform(0.002, 0.02, (2, hkv, n8)).astype(np.float32)
    k4, v4, s4k, s4v = _int4_cache(hkv, d, PAGE, SUBS, n4, rng)
    return (k8, v8, s8k, s8v, k4, v4, s4k, s4v)


def _states(arrays):
    return (tmx.MixedPagedKVState(*_t(*arrays)), jmx.MixedPagedKVState(*_j(*arrays)))


@pytest.mark.parametrize("kw", [{}, dict(window=12, attention_sinks=BOUNDARY),
                                dict(logit_softcap=3.0)], ids=["plain", "window", "softcap"])
def test_mixed_decode_matches_jax(kw):
    """Lengths below, at and past the boundary (two INT8 pages)."""
    rng = np.random.default_rng(4)
    t_state, j_state = _states(_mixed_state(rng))
    q = rng.normal(0, 1, (3, 4, 32)).astype(np.float32)
    lengths = np.asarray([5, 16, 37], np.int32)
    t8 = _tables(3, 2, 7, rng)
    t4 = _tables(3, 3, 12, rng)
    got = tmx.mixed_paged_decode_attention(*_t(q), t_state, *_t(lengths, t8, t4), BOUNDARY, **kw)
    want = jmx.mixed_paged_decode_attention(jnp.asarray(q), j_state,
                                            *_j(lengths, t8, t4), BOUNDARY, **kw)
    _close(got, want)


@pytest.mark.parametrize("kw", [{}, dict(window=12, attention_sinks=BOUNDARY)],
                         ids=["plain", "window"])
def test_mixed_prefill_matches_jax(kw):
    """A chunk below the boundary, one spanning it (its INT4 rows start at
    a negative position) and one past it."""
    rng = np.random.default_rng(5)
    t_state, j_state = _states(_mixed_state(rng))
    q = rng.normal(0, 1, (3, 4, 8, 32)).astype(np.float32)
    starts = np.asarray([0, 12, 24], np.int32)
    lengths = starts + 8
    t8 = _tables(3, 2, 7, rng)
    t4 = _tables(3, 2, 12, rng)
    got = tmx.mixed_paged_prefill_attention(*_t(q), t_state, *_t(lengths, starts, t8, t4),
                                            BOUNDARY, **kw)
    want = jmx.mixed_paged_prefill_attention(jnp.asarray(q), j_state,
                                             *_j(lengths, starts, t8, t4), BOUNDARY, **kw)
    _close(got, want)


def test_mixed_attention_gates():
    t_state, _ = _states(_mixed_state(np.random.default_rng(6)))
    args = (torch.zeros((1, 4, 32)), t_state, torch.tensor([3]), torch.ones((1, 2), dtype=torch.int32),
            torch.ones((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="page-aligned"):
        tmx.mixed_paged_decode_attention(*args, 12)
    with pytest.raises(ValueError, match="attention_sinks"):
        tmx.mixed_paged_decode_attention(*args, BOUNDARY, window=8, attention_sinks=4)


def _equal_live(t_state, j_state, pages8, pages4):
    """Payloads and scales of the live pages equal, bit for bit."""
    for name, pages in (("k8", pages8), ("v8", pages8), ("k8_scales", pages8),
                        ("v8_scales", pages8), ("k4", pages4), ("v4", pages4),
                        ("k4_scales", pages4), ("v4_scales", pages4)):
        got = getattr(t_state, name)[:, pages].numpy()
        want = np.asarray(getattr(j_state, name))[:, pages]
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_write_pages_mixed_matches_jax():
    """Two INT8 pages and three INT4 pages of one sequence, the last page
    half padding (zeros). Bit for bit against the JAX package's per-page
    quantizers called eagerly; within one ulp of its write_pages_mixed,
    whose lax.scan lets XLA turn the division by the constant 7 (and 127)
    into a multiplication by its reciprocal, so its scales may sit one ulp
    off and a payload one step off at a rounding tie."""
    rng = np.random.default_rng(7)
    arrays = _mixed_state(rng)
    t_state, j_state = _states(arrays)
    k, v = rng.normal(0, 1, (2, 2, 5 * PAGE, 32)).astype(np.float32)
    k[:, 4 * PAGE + 4:] = 0.0
    v[:, 4 * PAGE + 4:] = 0.0
    p8, p4 = np.asarray([3, 1], np.int32), np.asarray([2, 8, 5], np.int32)
    tmx.write_pages_mixed(t_state, *_t(k, v, p8, p4))
    eager = {n: np.array(a) for n, a in zip(("k8", "v8", "k8_scales", "v8_scales", "k4", "v4",
                                              "k4_scales", "v4_scales"), arrays)}
    for i, (ids, int4) in enumerate([(p8, False)] * 2 + [(p4, True)] * 3):
        pid = ids[i if not int4 else i - 2]
        for name, x in (("k", k), ("v", v)):
            page = jnp.asarray(x[:, i * PAGE:(i + 1) * PAGE])
            if int4:
                q, s = jmx.quantize_page_int4(page, SUBS)
                eager[f"{name}4"][:, pid], eager[f"{name}4_scales"][:, pid] = q, s
            else:
                q, s = jkv.quantize_page(page)
                eager[f"{name}8"][:, pid], eager[f"{name}8_scales"][:, pid] = q, s
    _equal_live(t_state, tmx.MixedPagedKVState(*_j(*eager.values())), p8, p4)
    j_state = jmx.write_pages_mixed(j_state, *_j(k, v, p8, p4))
    for name in ("k8_scales", "v8_scales", "k4_scales", "v4_scales"):
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)), rtol=2**-23, atol=0)
    for name in ("k8", "v8", "k4", "v4"):
        got = getattr(t_state, name).numpy().astype(np.int32)
        want = np.asarray(getattr(j_state, name)).astype(np.int32)
        if name in ("k4", "v4"):
            got, want = (torch.cat(tq.unpack_int4_halves(torch.from_numpy(
                a.astype(np.int8))), -1).numpy() for a in (got, want))
        assert np.abs(got - want).max() <= 1, name


def test_append_tokens_batched_mixed_matches_jax():
    """Five steps of four lanes, at positions below and past the boundary,
    first and later slots of a sub-tile (fit, then clamp into the fitted
    scale); the non-owning pool's scrap page 0 is excluded."""
    rng = np.random.default_rng(8)
    t_state, j_state = _states(_mixed_state(rng))
    pos = np.asarray([4, 14, 16, 30], np.int32)
    pid8 = np.asarray([1, 2, 0, 0], np.int32)
    pid4 = np.asarray([0, 0, 3, 4], np.int32)
    for step in range(5):
        k, v = (rng.normal(0, 1 + step, (2, 4, 2, 32))).astype(np.float32)
        slots = (pos % PAGE).astype(np.int32)
        tmx.append_tokens_batched_mixed(t_state, *_t(k, v, pos), BOUNDARY,
                                        *_t(pid8, pid4, slots))
        j_state = jmx.append_tokens_batched_mixed(j_state, *_j(k, v, pos), BOUNDARY,
                                                  *_j(pid8, pid4, slots))
        pos = pos + 1
        pid8 = np.where(pos < BOUNDARY, pid8, 0).astype(np.int32)
        pid4 = np.where((pos >= BOUNDARY) & (pid4 == 0), 6, pid4).astype(np.int32)
    _equal_live(t_state, j_state, [1, 2], [3, 4, 6])


def test_append_token_mixed_routes_like_jax():
    rng = np.random.default_rng(9)
    t_state, j_state = _states(_mixed_state(rng))
    k, v = rng.normal(0, 1, (2, 2, 32)).astype(np.float32)
    for position, page, slot in ((5, 2, 5), (20, 3, 4)):
        tmx.append_token_mixed(t_state, *_t(k, v), position=position,
                               boundary_tokens=BOUNDARY, page_id=page, slot=slot)
        j_state = jmx.append_token_mixed(j_state, *_j(k, v), position=position,
                                         boundary_tokens=BOUNDARY, page_id=jnp.int32(page),
                                         slot=jnp.int32(slot))
    _equal_live(t_state, j_state, [2], [3])


# --- MixedPageAllocator --------------------------------------------------------


def test_mixed_page_allocator_matches_jax():
    """admit / extend across the boundary / trim_window of the INT4 bulk /
    release, block tables and lengths, step for step."""
    trace = {}
    for name, cls in (("jax", jkv.MixedPageAllocator), ("port", tkv.MixedPageAllocator)):
        a = cls(6, 10, 4, 8)
        steps = [a.admit(0, 5), a.admit(1, 13)]
        steps += [a.extend(0) for _ in range(6)] + [a.extend(1) for _ in range(3)]
        steps.append(a.trim_window(1, 6, 8))
        steps += [tuple(t.tolist() for t in a.block_tables([0, 1], 5)),
                  a.lengths_array([0, 1]).tolist(), a.free_pages,
                  [a.a8.tables[0], a.a4.tables[1]]]
        a.check_extend_headroom([0, 1], 4, 5)
        with pytest.raises(RuntimeError, match="int4 pages"):
            a.check_extend_headroom([0, 1], 20, 5)
        a.release(0)
        a.release(1)
        steps += [a.a8.free_pages, a.a4.free_pages, sorted(a.a4._free)]
        trace[name] = steps
    assert trace["port"] == trace["jax"]
    with pytest.raises(ValueError):
        tkv.MixedPageAllocator(4, 4, 4, 6)


def test_chip_smoke_int4_checks_hold_jax_and_catch_faults(monkeypatch):
    """chip_smoke.py's per-element bounds for the INT4 kernels
    (int4_tolerances): the JAX kernels, another summation order, stand in
    for the CUDA ones and pass; the plain versions with the planted faults'
    analogues (high nibble read unsigned, sub-tile scale index off by one,
    negative q_start clamped to 0, an empty row's lse 0) fail by over 5x."""
    import chip_smoke
    from quantizedmha_tpu_torch.ops import decode as tdec
    from quantizedmha_tpu_torch.ops.paged_prefill import _paged_prefill_int4_plain

    rng = np.random.default_rng(10)
    cache = _int4_cache(2, 64, 16, 4, 9, rng)
    tables = _tables(2, 4, 9, rng)
    q = rng.normal(0, 1, (2, 8, 20, 64)).astype(np.float32)
    lengths, starts = np.asarray([50, 12], np.int32), np.asarray([30, -8], np.int32)
    args = _t(q, *cache, lengths, starts, tables)
    sm = 64**-0.5
    kw = dict(sm_scale=sm, window=None, softcap=None, sinks=0, save_residuals=True)
    o, lse = _paged_prefill_int4_plain(*args, **kw)
    tol, lse_tol = chip_smoke.int4_tolerances(args[0], *args[1:5], o, lse, sm_scale=sm,
                                              softcap=None)
    jo, jlse = jprefill4(*_j(q, *cache, lengths, starts, tables), save_residuals=True)
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jo)), o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jlse)), lse, lse_tol) <= 1.0
    ks, vs = args[3], args[4]
    faulty = {
        "sub_index": _paged_prefill_int4_plain(*args[:3], torch.roll(ks, -1, dims=-1),
                                               torch.roll(vs, -1, dims=-1), *args[5:], **kw),
        "q_start_clamp": _paged_prefill_int4_plain(*args[:6], args[6].clamp(min=0), args[7],
                                                   **kw),
    }
    with monkeypatch.context() as m:
        m.setattr(tdec, "unpack_int4_halves",
                  lambda p: ((p.to(torch.int32) << 28) >> 28, (p.to(torch.int32) & 0xFF) >> 4))
        faulty["unsigned_high"] = _paged_prefill_int4_plain(*args, **kw)
    for name, (fo, flse) in faulty.items():
        ratio = max(chip_smoke.err_over_tol(fo, o, tol), chip_smoke.err_over_tol(flse, lse, lse_tol))
        assert ratio > 5.0, name
    empty_lse0 = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    assert chip_smoke.err_over_tol(empty_lse0, lse, lse_tol) > 5.0


def _kernel_rounding_int4(q, kp, vp, ks, vs, lengths, starts, tables, **kw):
    """The plain INT4 page walk with the bf16 kernel's one extra rounding:
    each p · v_scale (its key's sub-tile scale) rounded to bf16 (round to
    nearest even) before P·V."""
    from quantizedmha_tpu_torch.ops.decode import _int4_page
    from quantizedmha_tpu_torch.ops.paged_prefill import _prefill_walk
    heads = torch.arange(kp.shape[0])

    def load(page):
        k, k_sc = _int4_page(kp, ks, heads, page)
        v, v_sc = _int4_page(vp, vs, heads, page)
        return k, k_sc, lambda p: (p * v_sc).to(torch.bfloat16).float() @ v
    return _prefill_walk(q, kp.shape[0], lengths, starts, tables, kp.shape[2], load, **kw)


@pytest.mark.parametrize("case", ["subs4", "window_sinks", "softcap_mqa"])
def test_chip_smoke_int4_bf16_tolerance_holds_kernel_rounding_and_jax(case):
    """int4_tolerances with the bf16-P term (w_abs from prefill_w_abs,
    |v| taken after unpacking) admits the kernel's rounding emulated on the
    CPU and the JAX kernel on bf16 q, a negative q_start included; the
    planted faults' analogues (V scales rolled to the next sub-tile; the
    causal diagonal shifted by one) still fail by over 5x."""
    import chip_smoke
    from quantizedmha_tpu_torch.ops.paged_prefill import _paged_prefill_int4_plain

    hq, hkv, d, subs, masks = INT4_CASES[case]
    rng = np.random.default_rng(60 + d)
    cache = _int4_cache(hkv, d, 32, subs or 1, 9, rng)
    tables = _tables(2, 4, 9, rng)
    q = rng.normal(0, 1, (2, hq, 20, d)).astype(np.float32)
    lengths, starts = np.asarray([50, 12], np.int32), np.asarray([30, -8], np.int32)
    args = _t(q, *cache, lengths, starts, tables)
    args[0] = args[0].to(torch.bfloat16)
    sm = masks.get("sm_scale", d**-0.5)
    kw = dict(sm_scale=sm, window=masks.get("window"), softcap=masks.get("logit_softcap"),
              sinks=masks.get("attention_sinks", 0), save_residuals=True)
    o, lse = _paged_prefill_int4_plain(*args, **kw)
    w_abs = chip_smoke.prefill_w_abs(args[0], args[1:5], *args[5:], int4=True, **kw)
    tol, lse_tol = chip_smoke.int4_tolerances(args[0], *args[1:5], o, lse, sm_scale=sm,
                                              softcap=kw["softcap"], w_abs=w_abs)
    eo, e_lse = _kernel_rounding_int4(*args, **kw)
    assert eo.dtype == torch.bfloat16 and not torch.equal(eo, o)
    assert chip_smoke.err_over_tol(eo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(e_lse, lse, lse_tol) <= 1.0
    jargs = _j(q, *cache, lengths, starts, tables)
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    jo, jlse = jprefill4(*jargs, save_residuals=True, **masks)
    jo = torch.from_numpy(np.asarray(jo).astype(np.float32))
    assert chip_smoke.err_over_tol(jo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jlse)), lse, lse_tol) <= 1.0
    rolled = _paged_prefill_int4_plain(*args[:4], torch.roll(args[4], 1, dims=-1), *args[5:],
                                       **kw)[0]
    shifted = _paged_prefill_int4_plain(*args[:6], args[6] + 1, args[7], **kw)[0]
    assert chip_smoke.err_over_tol(rolled, o, tol) > 5.0
    assert chip_smoke.err_over_tol(shifted, o, tol) > 5.0


def test_chip_smoke_merge_tolerance_holds_jax_merge():
    """merge_tolerance, from each partial's tolerance: JAX's merge of the
    JAX partials (the interpret-mode kernels) stays within it of the port's
    plain composition."""
    import chip_smoke
    from quantizedmha_tpu_torch.ops.decode import _paged_decode_int4_plain, _paged_decode_plain

    rng = np.random.default_rng(11)
    arrays = _mixed_state(rng)
    q = rng.normal(0, 1, (3, 4, 32)).astype(np.float32)
    lengths = np.asarray([5, 16, 37], np.int32)
    t8, t4 = _tables(3, 2, 7, rng), _tables(3, 3, 12, rng)
    len8, len4 = np.minimum(lengths, BOUNDARY), np.maximum(lengths - BOUNDARY, 0)
    sm = 32**-0.5
    kw = dict(sm_scale=sm, window=None, softcap=None, sinks=0, save_residuals=True)
    p8 = _paged_decode_plain(*_t(q, *arrays[:4], len8, t8), **kw)
    p4 = _paged_decode_int4_plain(*_t(q, *arrays[4:], len4, t4), **kw)
    tol8 = chip_smoke.decode_tolerance(p8[0], *_t(arrays[1], arrays[3]))
    lse_tol8 = 1e-5 + 1e-6 * torch.nan_to_num(p8[1].double().abs(), posinf=0.0)
    tols4 = chip_smoke.int4_tolerances(torch.from_numpy(q), *_t(*arrays[4:]), *p4, sm_scale=sm,
                                       softcap=None)
    plain = tmerge(*p8, *p4)[0]
    tol = chip_smoke.merge_tolerance(plain, (p8[1], p4[1]), (p8[0], p4[0]), (tol8, tols4[0]),
                                     (lse_tol8, tols4[1]))
    _, j_state = _states(arrays)
    want = jmx.mixed_paged_decode_attention(jnp.asarray(q), j_state, *_j(lengths, t8, t4),
                                            BOUNDARY)
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(want)), plain, tol) <= 1.0
    assert chip_smoke.err_over_tol(plain * 1.001, plain, tol) > 1.0
