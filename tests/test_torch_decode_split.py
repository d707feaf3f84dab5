"""PyTorch port vs JAX package: the flash-decoding split of the paged
decode (ops/decode.py: decode_splits, the split page walk and its lse
merge, which the CUDA kernel csrc/paged_decode.cu follows). JAX runs its
Pallas decode kernels (INT8 and INT4 pages) in interpret mode; the port
runs its plain version, each sequence's pages cut into decode_splits'
splits, each walked from zero state, the splits merged by lse in order.
Inputs are made with numpy from a seed, at sizes where S > 1 and a split
holds several pages.

Tolerance: rtol = atol = 1e-5, as tests/test_torch_decode.py states: both
sides compute in f32 from the same pages and scales, and the merge adds
one f32 rescale of each split's sums (a few ulps), not a new rounding
step. bf16 q: the outputs are rounded to bf16 on both sides from f32
values that agree to 1e-5, so they may differ by one bf16 ulp (2^-7 of
|o|) where those values straddle a rounding boundary; lse stays f32 at
1e-5. The split walk against the one-split walk: 1e-5 as well."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.ops.decode import paged_decode_attention as jdecode
from quantizedmha_tpu.ops.decode import paged_decode_attention_int4 as jdecode4
from quantizedmha_tpu_torch.ops import decode as tdec
from quantizedmha_tpu_torch.ops.decode import decode_splits
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
PAGE, MAX_PAGES = 16, 24  # decode_splits(3, 2, 24, 16) == (6, 4)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol=TOL, bf16=False):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    rtol = 2.0**-7 if bf16 else tol
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=tol)


def _tables(batch, max_pages, num_pages, rng):
    return (rng.permutation(num_pages - 1)[:batch * max_pages] + 1).reshape(
        batch, max_pages).astype(np.int32)


def _int8_case(hq, hkv, d, lengths, seed, max_pages=MAX_PAGES, page=PAGE):
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    n = batch * max_pages + 1
    kp, vp = rng.integers(-127, 128, (2, hkv, n, page, d)).astype(np.int8)
    ks, vs = rng.uniform(0.002, 0.02, (2, hkv, n)).astype(np.float32)
    q = rng.normal(0, 1, (batch, hq, d)).astype(np.float32)
    return q, kp, vp, ks, vs, np.asarray(lengths, np.int32), _tables(batch, max_pages, n, rng)


def _int4_case(hq, hkv, d, subs, lengths, seed, max_pages=MAX_PAGES, page=PAGE):
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    n = batch * max_pages + 1
    kp, vp = rng.integers(-128, 128, (2, hkv, n, page, d // 2)).astype(np.int8)
    ks, vs = rng.uniform(0.02, 0.3, (2, hkv, n, subs)).astype(np.float32)
    q = rng.normal(0, 1, (batch, hq, d)).astype(np.float32)
    return q, kp, vp, ks, vs, np.asarray(lengths, np.int32), _tables(batch, max_pages, n, rng)


# --- decode_splits ---------------------------------------------------------


@pytest.mark.parametrize("batch,hkv,max_pages,page", [
    (8, 8, 4, 128), (8, 8, 64, 128), (8, 1, 4, 128), (1, 1, 1, 16), (3, 2, 24, 16),
    (64, 8, 64, 128), (1, 1, 1000, 32), (2, 4, 7, 64), (256, 8, 16, 16)])
def test_decode_splits_cover_the_table_once_in_order(batch, hkv, max_pages, page):
    n_splits, per = decode_splits(batch, hkv, max_pages, page)
    assert n_splits >= 1 and per >= 1
    pages = [i for s in range(n_splits) for i in range(s * per, min((s + 1) * per, max_pages))]
    assert pages == list(range(max_pages))
    assert all(s * per < max_pages for s in range(n_splits))  # no split is empty by shape
    assert per * page >= 64 or per == max_pages


def test_decode_splits_at_the_serve_shapes():
    assert decode_splits(8, 8, 1, 128) == (1, 1)
    assert decode_splits(3, 2, 1, 16) == (1, 1)
    assert decode_splits(8, 8, 4, 128)[0] > 1             # serve, main shape
    assert decode_splits(8, 8, 64, 128)[0] > 1            # serve_flash / serve_mixed depth
    assert decode_splits(8, 1, 4, 128)[0] > 1             # MQA
    n_splits, per = decode_splits(8, 8, 64, 128)
    assert 8 * 8 * n_splits >= 3 * 132 and per > 1  # several blocks for each of 132 SMs
    assert decode_splits(3, 2, MAX_PAGES, PAGE) == (6, 4)


# --- the split walk against JAX ---------------------------------------------

# (hq, hkv, d, lengths, kwargs)
INT8_CASES = {
    # window 40 + 3 sinks at 380 tokens: splits 1-4 of 6 lie behind the window
    "window_sinks": (8, 2, 32, [380, 200, 60], dict(window=40, attention_sinks=3)),
    "window": (8, 2, 64, [300, 17, 384], dict(window=70)),
    "short": (8, 2, 32, [1, 5, 63], {}),                  # shorter than one split (64 keys)
    "full": (4, 1, 128, [384, 250, 1], {}),
    "softcap": (8, 2, 64, [370, 65, 128], dict(logit_softcap=3.0, sm_scale=0.2)),
}


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_split_walk_matches_jax(case, q_dtype):
    hq, hkv, d, lengths, kw = INT8_CASES[case]
    q, *rest = _int8_case(hq, hkv, d, lengths, seed=len(case) + d)
    assert decode_splits(len(lengths), hkv, MAX_PAGES, PAGE)[0] > 1
    bf16 = q_dtype == "bfloat16"
    tq = torch.from_numpy(q).to(torch.bfloat16) if bf16 else torch.from_numpy(q)
    jq = jnp.asarray(q).astype(jnp.bfloat16) if bf16 else jnp.asarray(q)
    o, lse = tdec.paged_decode_attention(tq, *_t(*rest), save_residuals=True, **kw)
    jo, jlse = jdecode(jq, *_j(*rest), save_residuals=True, **kw)
    assert o.dtype == tq.dtype
    _close(o, jo, bf16=bf16)
    _close(lse, jlse)


# (hq, hkv, d, subs, lengths, kwargs); the first row of each is empty.
INT4_CASES = {
    "window_sinks": (8, 2, 64, 4, [0, 380, 200], dict(window=40, attention_sinks=3)),
    "short": (8, 2, 32, 2, [0, 1, 40], {}),
    "softcap_mqa": (4, 1, 128, 4, [0, 384, 70], dict(logit_softcap=2.0, sm_scale=0.2)),
}


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(INT4_CASES))
def test_int4_split_walk_matches_jax(case, q_dtype):
    """A length-0 row gives o = 0 and lse = -inf through the merge."""
    hq, hkv, d, subs, lengths, kw = INT4_CASES[case]
    q, *rest = _int4_case(hq, hkv, d, subs, lengths, seed=len(case) + 40)
    assert decode_splits(len(lengths), hkv, MAX_PAGES, PAGE)[0] > 1
    bf16 = q_dtype == "bfloat16"
    tq = torch.from_numpy(q).to(torch.bfloat16) if bf16 else torch.from_numpy(q)
    jq = jnp.asarray(q).astype(jnp.bfloat16) if bf16 else jnp.asarray(q)
    o, lse = tdec.paged_decode_attention_int4(tq, *_t(*rest), save_residuals=True, **kw)
    jo, jlse = jdecode4(jq, *_j(*rest), save_residuals=True, **kw)
    _close(o, jo, bf16=bf16)
    _close(lse, jlse)
    assert torch.all(o[0] == 0) and torch.all(torch.isneginf(lse[0]))


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("case", ["window_sinks", "short"])
def test_split_walk_equals_one_split_walk(case, int4):
    """The same function at S splits (decode_splits) as at one split
    walking the whole table."""
    if int4:
        hq, hkv, d, subs, lengths, kw = INT4_CASES[case]
        args = _t(*_int4_case(hq, hkv, d, subs, lengths, seed=7))
        plain = tdec._paged_decode_int4_plain
    else:
        hq, hkv, d, lengths, kw = INT8_CASES[case]
        args = _t(*_int8_case(hq, hkv, d, lengths, seed=7))
        plain = tdec._paged_decode_plain
    kw = dict(sm_scale=d**-0.5, window=kw.get("window"), softcap=None,
              sinks=kw.get("attention_sinks", 0), save_residuals=True)
    split = plain(*args, **kw)
    whole = plain(*args, splits=(1, MAX_PAGES), **kw)
    for a, b in zip(split, whole):
        _close(a, b.numpy())


def test_merge_skips_empty_splits_and_all_empty_rows():
    """Splits with m = -inf add nothing (their sums are never read); a row
    whose splits are all empty gives o = 0 and lse = -inf."""
    inf = float("-inf")
    m = torch.tensor([1.0, inf]).reshape(1, 2, 1, 1)
    l = torch.tensor([2.0, 0.0]).reshape(1, 2, 1, 1)
    states = [(m, l, torch.tensor([4.0, 0.0]).reshape(1, 2, 1, 1)),
              (torch.full_like(m, inf), torch.zeros_like(l), torch.full_like(m, float("nan")))]
    o, lse = tdec._merge_splits(states, torch.float32, (1, 2, 1), True)
    assert o.tolist() == [[[2.0], [0.0]]]
    assert lse[0, 0].item() == pytest.approx(1.0 + np.log(2.0))
    assert lse[0, 1].item() == float("-inf")


# --- chip_smoke.py's decode checks hold the split and catch its faults -------


def _split_states(monkeypatch, plain, args, kw):
    """(result, the splits' states) of one plain walk."""
    seen = []
    merge = tdec._merge_splits

    def record(states, *a):
        seen.extend(states)
        return merge(states, *a)
    with monkeypatch.context() as mp:
        mp.setattr(tdec, "_merge_splits", record)
        out = plain(*args, **kw)
    return out, seen


def test_chip_smoke_decode_tolerance_catches_merge_faults(monkeypatch):
    """chip_smoke.py's decode tolerances admit JAX's kernel against the
    split walk, and fail the planted merge faults' analogues by over 5x:
    the merge without a split's rescale, a split's sums read from the
    neighbouring split's slot, and (scores all far below zero, so that
    exp(m - 0) underflows) an empty split's m taken as 0."""
    import chip_smoke
    inf = float("-inf")
    hq, hkv, d, lengths, masks = INT8_CASES["window_sinks"]
    q, *rest = _int8_case(hq, hkv, d, lengths, seed=3)
    args = _t(q, *rest)
    kw = dict(sm_scale=d**-0.5, window=40, softcap=None, sinks=3, save_residuals=True)
    (o, lse), states = _split_states(monkeypatch, tdec._paged_decode_plain, args, kw)
    tol = chip_smoke.decode_tolerance(o, args[2], args[4])
    lse_tol = 1e-5 + 1e-6 * torch.nan_to_num(lse.double().abs(), posinf=0.0)
    jo, jlse = jdecode(*_j(q, *rest), save_residuals=True, **masks)
    assert chip_smoke.err_over_tol(torch.from_numpy(np.asarray(jo)), o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.from_numpy(np.asarray(jlse)), lse, lse_tol) <= 1.0
    shape = tuple(o.shape)
    unscaled = [(torch.where(m == inf, m, torch.zeros_like(m)), l, a) for m, l, a in states]
    rolled = [(m, l, states[(s + 1) % len(states)][2]) for s, (m, l, _) in enumerate(states)]
    for name, faulty in (("no_rescale", unscaled), ("neighbour_slot", rolled)):
        fo, flse = tdec._merge_splits(faulty, o.dtype, shape, True)
        ratio = max(chip_smoke.err_over_tol(fo, o, tol),
                    chip_smoke.err_over_tol(flse, lse, lse_tol))
        assert ratio > 5.0, name

    # Scores far below zero: q against all-positive keys.
    q_neg = -(np.abs(q) + 1.0) * 400.0
    k_pos = np.abs(rest[0]).astype(np.int8) + 1
    args = _t(q_neg, k_pos, *rest[1:])
    (o, lse), states = _split_states(monkeypatch, tdec._paged_decode_plain, args, kw)
    assert float(lse[torch.isfinite(lse)].max()) < -200.0
    tol, lse_tol = chip_smoke.paged_prefill_tolerances(args[0], *args[1:5], o, lse,
                                                       sm_scale=kw["sm_scale"], softcap=None)
    assert any(bool((m == inf).all()) for m, _, _ in states)
    m0 = [(torch.where(m == inf, torch.zeros_like(m), m), l, a) for m, l, a in states]
    fo, flse = tdec._merge_splits(m0, o.dtype, shape, True)
    assert chip_smoke.err_over_tol(flse, lse, lse_tol) > 5.0
