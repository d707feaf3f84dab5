"""PyTorch port vs JAX package: the split key walk of the bf16 paged
prefill (ops/paged_prefill.py: prefill_splits, the split page walk and its
lse merge, which the CUDA kernel csrc/paged_prefill.cu follows where its
grid would leave the card short of blocks, as at speculative verify's q
tiles). JAX runs its Pallas prefill kernels (INT8 and INT4 pages) in
interpret mode; the port runs its plain version, each sequence's pages cut
into prefill_splits' splits (or explicit ones), each walked from zero
state, the splits merged by lse in order. Inputs are made with numpy from a
seed, on pages of 16 (a split a multiple of 4 pages, so that no split
boundary falls inside a 64-key tile), at sizes where S > 1 and a split
holds several pages.

Tolerance: rtol = atol = 1e-5, as tests/test_torch_paged_prefill.py
states: both sides compute in f32 from the same pages and scales, and the
merge adds one f32 rescale of each split's sums (a few ulps), not a new
rounding step. bf16 q: the outputs are rounded to bf16 on both sides from
f32 values that agree to 1e-5, so they may differ by one bf16 ulp (2^-7 of
|o|); lse stays f32 at 1e-5. The split walk against the one-split walk:
1e-5 as well.

The kernel's bf16 P under the split: split s rounds bf16(p_j^s ·
v_scale_j) with p_j^s = exp(x_j - m_s) relative to its own running max m_s,
within 2^-8 of the term (relative rounding, whatever the scale), and the
merge's weight w_s = exp(m_s - M) makes w_s · p_j^s = exp(x_j - M) = p_j,
the one walk's p. So the merged error is at most 2^-8 · sum_j p_j |v_j| /
l with l = sum_s w_s l_s = sum_j p_j: chip_smoke.py's
paged_prefill_tolerances term (prefill_w_abs, the one walk on |V|) as it
stands. test_chip_smoke_tolerance_holds_split_rounding checks it on an
emulation of that rounding.

verify_step (bf16, a tiny Gemma-2-style model whose verify shapes give S >
1) against JAX's verify_step on the same INT8 cache: both models round
every activation to bf16, each in its own order, so each sits within its
own bf16 rounding error of the f32 model on the same weights and cache;
the bound is twice JAX's (measured here: max |JAX bf16 - JAX f32| over
the logits), which two independent roundings of that size stay inside by
the triangle inequality. The split's own change is ~1e-6 of the attention
output, far inside it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.models import llama as jl
from quantizedmha_tpu.ops.paged_prefill import paged_prefill_attention as jprefill
from quantizedmha_tpu.ops.paged_prefill import paged_prefill_attention_int4 as jprefill4
from quantizedmha_tpu.serving import llama_adapter as jad
from quantizedmha_tpu_torch.models import llama as tl
from quantizedmha_tpu_torch.models.convert import params_from_numpy
from quantizedmha_tpu_torch.ops import paged_prefill as pp
from quantizedmha_tpu_torch.ops.paged_prefill import prefill_splits
from quantizedmha_tpu_torch.serving import llama_adapter as tad
from test_torch_hybrid_cache import numpy_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
PAGE, MAX_PAGES = 16, 24
BF16 = torch.bfloat16


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol=TOL, bf16=False):
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    rtol = 2.0**-7 if bf16 else tol
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=tol)


def _tables(batch, max_pages, num_pages, rng):
    return (rng.permutation(num_pages - 1)[:batch * max_pages] + 1).reshape(
        batch, max_pages).astype(np.int32)


def _case(hq, hkv, d, C, lengths, q_starts, seed, subs=None):
    """(q, k_pages, v_pages, k_scales, v_scales, lengths, q_starts,
    tables): INT8 pages, or nibble-packed INT4 ones with `subs` scale
    sub-tiles a page."""
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    n = batch * MAX_PAGES + 1
    if subs is None:
        kp, vp = rng.integers(-127, 128, (2, hkv, n, PAGE, d)).astype(np.int8)
        ks, vs = rng.uniform(0.002, 0.02, (2, hkv, n)).astype(np.float32)
    else:
        kp, vp = rng.integers(-128, 128, (2, hkv, n, PAGE, d // 2)).astype(np.int8)
        ks, vs = rng.uniform(0.02, 0.3, (2, hkv, n, subs)).astype(np.float32)
    q = rng.normal(0, 1, (batch, hq, C, d)).astype(np.float32)
    return (q, kp, vp, ks, vs, np.asarray(lengths, np.int32), np.asarray(q_starts, np.int32),
            _tables(batch, MAX_PAGES, n, rng))


# --- prefill_splits -----------------------------------------------------------


# (batch, kv heads, q_len, group, head_dim, max_pages, page)
SHAPES = [(4, 8, 5, 2, 256, 64, 128), (4, 8, 5, 2, 256, 41, 128), (4, 2, 5, 4, 128, 3, 128),
          (8, 8, 5, 4, 128, 41, 128), (3, 2, 5, 4, 32, 24, 16), (1, 1, 9, 1, 64, 1000, 32),
          (2, 4, 3, 8, 128, 7, 48), (1, 8, 2048, 4, 128, 48, 128), (2, 1, 1, 64, 256, 9, 16)]


@pytest.mark.parametrize("shape", SHAPES)
def test_prefill_splits_cover_the_table_once_in_order(shape):
    """The splits cut the table into contiguous ranges of whole pages,
    each a whole number of 64-key tiles, none empty by shape."""
    n_splits, per = prefill_splits(*shape, BF16)
    max_pages, page = shape[5], shape[6]
    assert n_splits >= 1 and per >= 1
    pages = [i for s in range(n_splits) for i in range(s * per, min((s + 1) * per, max_pages))]
    assert pages == list(range(max_pages))
    assert all(s * per < max_pages for s in range(n_splits))
    assert n_splits == 1 or (per * page) % 64 == 0


def test_prefill_splits_at_the_main_shapes():
    """S = 1 where the unsplit grid fills the card (a 2048-row chunk at
    4096 of context, d=128 and d=256: 512 blocks; a grid of one block an
    SM) and for f32 q; S > 1 at verify's shapes (serve_spec's Gemma-2 at
    its 64-page table and the coverage's 41, serve_tp's d=128 at 8 q / 2 kv
    heads)."""
    assert prefill_splits(1, 8, 2048, 4, 128, 48, 128, BF16) == (1, 48)
    assert prefill_splits(1, 8, 2048, 2, 256, 48, 128, BF16) == (1, 48)
    assert prefill_splits(1, 8, 2048, 2, 256, 64, 128, BF16) == (1, 64)
    assert prefill_splits(1, 8, 528, 4, 128, 48, 128, BF16) == (1, 48)   # 136 blocks
    assert prefill_splits(1, 8, 512, 4, 128, 48, 128, BF16)[0] > 1      # 128 blocks
    for shape in SHAPES[:5]:
        assert prefill_splits(*shape, torch.float32) == (1, shape[5])
        assert prefill_splits(*shape, BF16)[0] > 1
    n_splits, per = prefill_splits(4, 8, 5, 2, 256, 64, 128, BF16)
    assert pp.SPLIT_TARGET_BLOCKS // 2 <= 4 * 8 * n_splits <= 2 * pp.SPLIT_TARGET_BLOCKS
    assert prefill_splits(4, 2, 5, 4, 128, 3, 128, BF16) == (3, 1)
    assert prefill_splits(3, 2, 5, 4, 32, MAX_PAGES, PAGE, BF16)[1] % 4 == 0
    assert pp.bf16_block_rows(256) == 64 and pp.bf16_block_rows(128) == 128


# --- the split walk against JAX ---------------------------------------------

# (hq, hkv, d, C, lengths, q_starts, masks)
INT8_CASES = {
    # a window of 40 + 3 sinks at 380 keys: splits 1-4 of 6 lie behind it
    "window_sinks": (8, 2, 32, 5, [380, 200, 60], [375, 195, 55],
                     dict(window=40, attention_sinks=3)),
    "softcap": (8, 2, 64, 5, [370, 65, 128], [365, 60, 123],
                dict(logit_softcap=3.0, sm_scale=0.2)),
    # a 9-row chunk from 0 (rows see one key on), splits past a short length
    "short": (4, 1, 128, 9, [9, 200, 384], [0, 191, 375], {}),
}


def _kw(masks, d, save=True):
    return dict(sm_scale=masks.get("sm_scale", d**-0.5), window=masks.get("window"),
                softcap=masks.get("logit_softcap"), sinks=masks.get("attention_sinks", 0),
                save_residuals=save)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_split_walk_matches_jax(case, q_dtype):
    """bf16 q through the public entry (prefill_splits' S > 1); f32 q, for
    which prefill_splits gives S = 1, through the plain walk with explicit
    splits (6 of 4 pages)."""
    hq, hkv, d, C, lengths, starts, masks = INT8_CASES[case]
    q, *rest = _case(hq, hkv, d, C, lengths, starts, seed=len(case) + d)
    bf16 = q_dtype == "bfloat16"
    jq = jnp.asarray(q).astype(jnp.bfloat16) if bf16 else jnp.asarray(q)
    if bf16:
        assert prefill_splits(len(lengths), hkv, C, hq // hkv, d, MAX_PAGES, PAGE, BF16)[0] > 1
        tq = torch.from_numpy(q).to(BF16)
        o, lse = pp.paged_prefill_attention(tq, *_t(*rest), save_residuals=True, **masks)
    else:
        o, lse = pp._paged_prefill_plain(*_t(q, *rest), splits=(6, 4), **_kw(masks, d))
    jo, jlse = jprefill(jq, *_j(*rest), save_residuals=True, **masks)
    assert o.dtype == (BF16 if bf16 else torch.float32)
    _close(o, jo, bf16=bf16)
    _close(lse, jlse)


# (hq, hkv, d, subs, C, lengths, q_starts, masks): the INT4 partial of a
# mixed-cache verify chunk; a sequence wholly below the boundary (length 0,
# every row at a negative position) and one that straddles it.
INT4_CASES = {
    "window_sinks": (8, 2, 64, 4, 5, [0, 380, 200], [-5, 375, 195],
                     dict(window=40, attention_sinks=3)),
    "straddle": (8, 2, 32, 2, 5, [3, 0, 384], [-2, -5, 379], {}),
    "softcap_mqa": (4, 1, 128, 4, 5, [0, 384, 70], [-5, 379, 65],
                    dict(logit_softcap=2.0, sm_scale=0.2)),
}


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(INT4_CASES))
def test_int4_split_walk_matches_jax(case, q_dtype):
    """Rows at negative positions see nothing: o = 0 and lse = -inf
    through the merge, no NaN."""
    hq, hkv, d, subs, C, lengths, starts, masks = INT4_CASES[case]
    q, *rest = _case(hq, hkv, d, C, lengths, starts, seed=len(case) + 40, subs=subs)
    bf16 = q_dtype == "bfloat16"
    jq = jnp.asarray(q).astype(jnp.bfloat16) if bf16 else jnp.asarray(q)
    if bf16:
        assert prefill_splits(len(lengths), hkv, C, hq // hkv, d, MAX_PAGES, PAGE, BF16)[0] > 1
        o, lse = pp.paged_prefill_attention_int4(torch.from_numpy(q).to(BF16), *_t(*rest),
                                                 save_residuals=True, **masks)
    else:
        o, lse = pp._paged_prefill_int4_plain(*_t(q, *rest), splits=(3, 8), **_kw(masks, d))
    jo, jlse = jprefill4(jq, *_j(*rest), save_residuals=True, **masks)
    _close(o, jo, bf16=bf16)
    _close(lse, jlse)
    dead = np.asarray(starts)[:, None] + np.arange(C)[None] < 0            # [B, C]
    assert dead.any()
    assert torch.all(o.permute(0, 2, 1, 3)[torch.from_numpy(dead)] == 0)
    assert torch.all(torch.isneginf(lse.permute(0, 2, 1)[torch.from_numpy(dead)]))


@pytest.mark.parametrize("case,int4", [("window_sinks", False), ("short", False),
                                       ("window_sinks", True), ("softcap_mqa", True)])
def test_split_walk_equals_one_split_walk(case, int4):
    """The same function at S splits as at one split walking the whole
    table: f32 q at explicit splits, and bf16 q at prefill_splits'."""
    if int4:
        hq, hkv, d, subs, C, lengths, starts, masks = INT4_CASES[case]
        args = _t(*_case(hq, hkv, d, C, lengths, starts, seed=7, subs=subs))
        plain = pp._paged_prefill_int4_plain
    else:
        hq, hkv, d, C, lengths, starts, masks = INT8_CASES[case]
        args = _t(*_case(hq, hkv, d, C, lengths, starts, seed=7))
        plain = pp._paged_prefill_plain
    kw = _kw(masks, d)
    for splits in ((2, 12), (6, 4)):
        split = plain(*args, splits=splits, **kw)
        whole = plain(*args, splits=(1, MAX_PAGES), **kw)
        for a, b in zip(split, whole):
            _close(a, b.numpy())
    qb = args[0].to(BF16)
    split = plain(qb, *args[1:], **kw)
    whole = plain(qb, *args[1:], splits=(1, MAX_PAGES), **kw)
    _close(split[0], whole[0].float().numpy(), bf16=True)
    _close(split[1], whole[1].numpy())


# --- empty splits -------------------------------------------------------------


def _split_states(monkeypatch, plain, args, kw):
    """(result, the splits' states) of one plain walk."""
    seen = []
    merge = pp._merge_splits

    def record(states, *a):
        seen.extend(states)
        return merge(states, *a)
    with monkeypatch.context() as mp:
        mp.setattr(pp, "_merge_splits", record)
        out = plain(*args, **kw)
    return out, seen


def test_empty_splits_are_skipped(monkeypatch):
    """A split past a short sequence's length and one wholly behind the
    window hold m = -inf for every row of that sequence; a split's sums
    are never read where its m is -inf (NaN sums change nothing); rows that
    see nothing give o = 0 and lse = -inf, with no NaN."""
    inf = float("-inf")
    hq, hkv, d, C, lengths, starts, masks = INT8_CASES["window_sinks"]
    args = _t(*_case(hq, hkv, d, C, lengths, starts, seed=11))
    kw = _kw(masks, d)
    (o, lse), states = _split_states(monkeypatch, pp._paged_prefill_plain, args,
                                     dict(kw, splits=(6, 4)))
    ms = torch.stack([m[..., 0] for m, _, _ in states])                  # [S, B, Hkv, rows]
    dead = (ms == inf).flatten(2).all(-1)                                # [S, B]
    # Sequence 0 (380 keys, window 40 + 3 sinks): splits 1-4 behind the
    # window, split 0 holds the sinks; sequence 2 (60 keys): splits 1-5
    # past its length.
    assert dead[1:5, 0].all() and not dead[0, 0] and not dead[5, 0]
    assert dead[1:, 2].all() and not dead[0, 2]
    nan_sums = [(m, l, torch.where(m == inf, torch.full_like(a, float("nan")), a))
                for m, l, a in states]
    fo, flse = pp._merge_splits(nan_sums, o.dtype, tuple(o.shape), True)
    assert torch.equal(fo, o) and torch.equal(flse, lse)

    hq, hkv, d, subs, C, lengths, starts, masks = INT4_CASES["straddle"]
    args = _t(*_case(hq, hkv, d, C, lengths, starts, seed=12, subs=subs))
    o, lse = pp._paged_prefill_int4_plain(args[0].to(BF16), *args[1:], **_kw(masks, d))
    assert not torch.isnan(o.float()).any() and not torch.isnan(lse).any()
    assert torch.all(o[1] == 0) and torch.all(torch.isneginf(lse[1]))   # length 0
    assert torch.all(o[0, :, :2] == 0) and torch.all(torch.isneginf(lse[0, :, :2]))
    assert torch.all(torch.isfinite(lse[0, :, 2:]))


# --- chip_smoke.py's tolerance holds the split and catches its faults -----------


def _kernel_rounding(args, kw):
    """The INT8 split walk with the bf16 kernel's one extra rounding: each
    p · v_scale rounded to bf16 before P·V, relative to its split's max."""
    q, kp, vp, ks, vs, lengths, starts, tables = args
    heads = torch.arange(kp.shape[0])

    def load(page):
        k = kp[:, page].float().transpose(0, 1)
        v = vp[:, page].float().transpose(0, 1)
        k_sc = ks[heads[None, :], page[:, None]][..., None, None]
        v_sc = vs[heads[None, :], page[:, None]][..., None, None]
        return k, k_sc, lambda p: (p * v_sc).to(BF16).float() @ v
    return pp._prefill_walk(q, kp.shape[0], lengths, starts, tables, kp.shape[2], load, **kw)


def test_chip_smoke_tolerance_holds_split_rounding_and_catches_merge_faults(monkeypatch):
    """paged_prefill_tolerances (w_abs of the one walk) admits the split
    walk with P rounded to bf16 per split and JAX's kernel on bf16 q, and
    fails the planted split faults' analogues by over 5x: the merge without
    a split's weight exp(m - M), splits' sums paired with the next split's
    m and l (merged out of order), each split's sums normalised by its own
    l, a split's range one tile (four pages) too long, and an empty split's
    NaN sums read where every split of a row is empty."""
    import chip_smoke
    inf = float("-inf")
    hq, hkv, d, C, lengths, starts, masks = INT8_CASES["softcap"]
    q, *rest = _case(hq, hkv, d, C, lengths, starts, seed=13)
    args = _t(q, *rest)
    args[0] = args[0].to(BF16)
    kw = _kw(masks, d)
    n_splits = prefill_splits(3, hkv, C, hq // hkv, d, MAX_PAGES, PAGE, BF16)[0]
    assert n_splits > 1
    (o, lse), states = _split_states(monkeypatch, pp._paged_prefill_plain, args, kw)
    w_abs = chip_smoke.prefill_w_abs(args[0], args[1:5], *args[5:], **kw)
    tol, lse_tol = chip_smoke.paged_prefill_tolerances(args[0], *args[1:5], o, lse,
                                                       sm_scale=kw["sm_scale"],
                                                       softcap=kw["softcap"], w_abs=w_abs)
    eo, else_ = _kernel_rounding(args, kw)
    assert not torch.equal(eo, o)
    assert chip_smoke.err_over_tol(eo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(else_, lse, lse_tol) <= 1.0
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    jo, jlse = jprefill(jq, *_j(*rest), save_residuals=True, **masks)
    jo = torch.from_numpy(np.asarray(jo).astype(np.float32))
    assert chip_smoke.err_over_tol(jo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.from_numpy(np.asarray(jlse)), lse, lse_tol) <= 1.0

    shape = tuple(o.shape)
    S = len(states)
    unweighted = [(torch.where(m == inf, m, torch.zeros_like(m)), l, a) for m, l, a in states]
    rolled = [(m, l, states[(s + 1) % S][2]) for s, (m, l, _) in enumerate(states)]
    normalised = [(m, l, a / torch.where(l == 0, torch.ones_like(l), l)) for m, l, a in states]
    faults = {"no_weight": pp._merge_splits(unweighted, o.dtype, shape, True),
              "out_of_order": pp._merge_splits(rolled, o.dtype, shape, True),
              "normalised_partial": pp._merge_splits(normalised, o.dtype, shape, True)}
    per = prefill_splits(3, hkv, C, hq // hkv, d, MAX_PAGES, PAGE, BF16)[1]

    def overlapping(q, num_kv_heads, lengths, q_starts, tables, page_size, load, *,
                    splits=None, **kw):
        """The walk with each split's range one tile too long."""
        walk = pp._walk_pages
        calls = iter(range(S))

        def longer(qg, pages, *a, **k):
            s = next(calls)
            return walk(qg, range(s * per, min((s + 1) * per + 4, pages.stop + 4,
                                               tables.shape[1])), *a, **k)
        with monkeypatch.context() as mp:
            mp.setattr(pp, "_walk_pages", longer)
            return prefill_walk(q, num_kv_heads, lengths, q_starts, tables, page_size, load,
                                splits=splits, **kw)
    prefill_walk = pp._prefill_walk
    with monkeypatch.context() as mp:
        mp.setattr(pp, "_prefill_walk", overlapping)
        faults["range_one_tile_long"] = pp._paged_prefill_plain(*args, **kw)
    for name, (fo, flse) in faults.items():
        ratio = max(chip_smoke.err_over_tol(fo, o, tol),
                    chip_smoke.err_over_tol(flse, lse, lse_tol))
        assert ratio > 5.0, name

    # Every split of a row empty (INT4 rows wholly below the boundary): a
    # merge that reads those splits takes exp(-inf - -inf), NaN.
    hq, hkv, d, subs, C, lengths, starts, masks = INT4_CASES["straddle"]
    args = _t(*_case(hq, hkv, d, C, lengths, starts, seed=14, subs=subs))
    args[0] = args[0].to(BF16)
    kw = _kw(masks, d)
    (o, lse), states = _split_states(monkeypatch, pp._paged_prefill_int4_plain, args, kw)
    mx = torch.stack([m for m, _, _ in states]).amax(dim=0)
    l_sum = sum(torch.exp(m - mx) * l for m, l, _ in states)
    read = (sum(torch.exp(m - mx) * a for m, _, a in states) / l_sum).reshape(o.shape)
    tol, _ = chip_smoke.int4_tolerances(args[0], *args[1:5], o, lse, sm_scale=kw["sm_scale"],
                                        softcap=None)
    assert chip_smoke.err_over_tol(read, o, tol) == float("inf")


# --- verify_step --------------------------------------------------------------


def _gemma2_tiny(dtype):
    """A two-layer Gemma-2-style config (a sliding layer of window 24, a
    full one; softcaps, sandwich norms, (1 + w) RMSNorm, GeGLU, scaled
    embeddings), d = 32, 4 q / 2 kv heads."""
    return dict(num_layers=2, window_pattern=(24, None), hidden_act="gelu_tanh",
                sandwich_norms=True, rms_plus_one=True, embed_scale=True,
                query_pre_attn_scalar=32.0, logit_softcap=50.0, final_logit_softcap=30.0,
                dtype=dtype)


def test_bf16_verify_step_with_splits_matches_jax(monkeypatch):
    """Two sequences (40 and 140 prompt tokens) verify four tokens each
    through an INT8 cache on 16-slot tables: prefill_splits gives 4 splits
    of 4 pages, some past the short sequence's length and, on the sliding
    layer, one wholly behind the long one's window. The port's bf16 logits
    sit within twice JAX's own bf16 rounding error (module docstring) of
    JAX's bf16 logits, and the split walk ran."""
    jc = jl.LlamaConfig.tiny(**_gemma2_tiny(jnp.bfloat16))
    tc = tl.LlamaConfig.tiny(**_gemma2_tiny(torch.bfloat16))
    tree = numpy_params(jc, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jc32 = dataclasses.replace(jc, dtype=jnp.float32)
    jp32 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree)
    tp = params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(5)
    n_prompt, S, width = (40, 140), 4, 16
    num_pages = 2 * width + 1
    ids = rng.permutation(num_pages - 1)[:2 * width].reshape(2, width) + 1
    tables = ids.astype(np.int32)
    cache = jad.make_cache(jc32, num_pages, PAGE)
    for b, n in enumerate(n_prompt):
        tokens = rng.integers(0, jc.vocab_size, (1, n))
        _, k_all, v_all = jad.prefill(jc32, jp32, jnp.asarray(tokens, jnp.int32))
        pad = (-n) % PAGE
        k_all, v_all = (jnp.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (k_all, v_all))
        cache = jad.write_prefill(jc32, cache, k_all, v_all,
                                  jnp.asarray(tables[b, :-(-n // PAGE)]), page_size=PAGE)
    tcache = tad.make_cache(tc, num_pages, PAGE, device="cpu")
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        getattr(tcache, name).copy_(torch.from_numpy(np.array(getattr(cache, name))))
    draft = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    pos = np.asarray(n_prompt)[:, None] + np.arange(S)[None]
    sched = np.take_along_axis(tables, pos // PAGE, axis=1).astype(np.int32)
    slots = (pos % PAGE).astype(np.int32)
    pos0 = np.asarray(n_prompt, np.int32)
    jargs = (jnp.asarray(draft), jnp.asarray(pos0), jnp.asarray(sched), jnp.asarray(slots),
             jnp.asarray(tables))
    jlog, _ = jad.verify_step(jc, jp, cache, *jargs, page_size=PAGE)
    jlog32, _ = jad.verify_step(jc32, jp32, cache, *jargs, page_size=PAGE)

    assert prefill_splits(2, 2, S, 2, 32, width, PAGE, BF16) == (4, 4)
    merged = []
    merge = pp._merge_splits

    def record(states, *a):
        merged.append(len(states))
        return merge(states, *a)
    monkeypatch.setattr(pp, "_merge_splits", record)
    got, _ = tad.verify_step(tc, tp, tcache, *_t(draft, pos0, sched, slots, tables),
                             page_size=PAGE)
    assert merged == [4, 4]
    want = np.asarray(jlog, np.float32)
    budget = np.abs(want - np.asarray(jlog32, np.float32)).max()
    err = np.abs(got.float().numpy() - want).max()
    assert got.shape == (2, S, jc.vocab_size)
    assert 0.0 < budget < 1.0
    print("verify_step err", err, "budget", budget)
    assert err <= 2.0 * budget, (err, budget)


def test_paged_prefill_variants_name_committed_lines():
    """Each variant of harness/paged_prefill_variants.json (the d=256
    producer experiments the A/B times) replaces lines that occur exactly
    once in csrc/paged_prefill.cu, as the A/B requires before it builds
    the copy."""
    import json
    import pathlib
    pkg = pathlib.Path(pp.__file__).resolve().parents[1]
    src = (pkg / "csrc" / "paged_prefill.cu").read_text()
    variants = json.loads((pkg / "harness" / "paged_prefill_variants.json").read_text())
    assert variants
    for name, edits in variants.items():
        for old, new in edits:
            assert src.count(old) == 1 and new != old, name
