"""PyTorch port vs JAX package: paged multi-token attention over the INT8
cache (ops/paged_prefill.py:paged_prefill_attention). JAX runs its Pallas
prefill kernel in interpret mode; the port runs the plain PyTorch page
walk.

Tolerance: both sides compute in f32 from the same int8 pages and scales
(scores q·sm_scale·k·k_scale, P·V then ·v_scale, l summing the f32 P) and
differ only in summation order and exp/tanh ulps: rtol = atol = 1e-5, and
1e-5 on lse. The bf16-q tests hold chip_smoke.py's per-element bound of the
tensor-core kernel (P rounded to bf16 with the V scale folded in, the term
2^-8 of the walk on |V|) to an emulation of that rounding and to JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.ops.paged_prefill import paged_prefill_attention as jprefill
from quantizedmha_tpu_torch.ops.decode import paged_decode_attention as tdecode
from quantizedmha_tpu_torch.ops.paged_prefill import paged_prefill_attention as tprefill
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5


def _case(hq, hkv, d, q_len, lengths, q_starts, page=16, max_pages=6, seed=0):
    """Random int8 pages and scales, a permuted block table per sequence,
    and q for a chunk of q_len rows; all from one numpy seed."""
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    num_pages = batch * max_pages + 1
    kp, vp = rng.integers(-127, 128, (2, hkv, num_pages, page, d)).astype(np.int8)
    ks, vs = rng.uniform(0.002, 0.02, (2, hkv, num_pages)).astype(np.float32)
    tables = (rng.permutation(num_pages - 1)[:batch * max_pages] + 1).reshape(
        batch, max_pages).astype(np.int32)
    q = rng.normal(0, 1, (batch, hq, q_len, d)).astype(np.float32)
    return (q, kp, vp, ks, vs, np.asarray(lengths, np.int32),
            np.asarray(q_starts, np.int32), tables)


def _both(args, **kw):
    got = tprefill(*(torch.from_numpy(a) for a in args), **kw)
    want = jprefill(*(jnp.asarray(a) for a in args), **kw)
    return got, want


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 32), (8, 2, 64), (4, 1, 128)],
                         ids=["gqa2_d32", "gqa4_d64", "mqa_d128"])
def test_paged_prefill_matches_jax(hq, hkv, d):
    """A whole prompt in one chunk (q_starts 0, lengths = q_len)."""
    args = _case(hq, hkv, d, q_len=48, lengths=[48], q_starts=[0], seed=hq + d)
    got, want = _both(args)
    assert got.shape == (1, hq, 48, d) and got.dtype == torch.float32
    _close(got, want)


def test_chunk_not_at_the_end_and_unaligned_q_len():
    """A 21-row chunk starting at position 32 of a 53-token context (its
    own rows written, the rest of the table unwritten), and one starting
    past a page boundary at 40 with a longer visible context."""
    for starts, lengths in (([32], [53]), ([40], [80])):
        args = _case(4, 2, 32, q_len=21, lengths=lengths, q_starts=starts, seed=sum(starts))
        got, want = _both(args)
        _close(got, want)


def test_batch_with_different_starts_and_lengths():
    args = _case(4, 2, 64, q_len=24, lengths=[24, 60, 90], q_starts=[0, 36, 50],
                 max_pages=7, seed=5)
    got, want = _both(args)
    _close(got, want)


@pytest.mark.parametrize("kw", [dict(window=20), dict(window=20, attention_sinks=3),
                                dict(logit_softcap=2.0, sm_scale=0.3)],
                         ids=["window", "window_sinks", "softcap"])
def test_masks_softcap_and_lse_match_jax(kw):
    args = _case(4, 2, 32, q_len=40, lengths=[70, 40], q_starts=[30, 0], seed=6)
    (o, lse), (jo, jlse) = _both(args, save_residuals=True, **kw)
    _close(o, jo)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=TOL, atol=TOL)
    assert torch.isfinite(lse).all()


def test_fully_masked_rows_give_zero_and_minus_inf():
    """A sequence with no visible context (length 0): every row is fully
    masked, o = 0 and lse = -inf on both sides."""
    args = _case(4, 2, 32, q_len=8, lengths=[4], q_starts=[0], seed=7)
    q, kp, vp, ks, vs, _, _, tables = args
    (o, lse), (jo, jlse) = _both((q, kp, vp, ks, vs, np.asarray([0], np.int32),
                                  np.asarray([0], np.int32), tables), save_residuals=True)
    assert torch.all(o == 0) and torch.all(torch.isneginf(lse))
    _close(o, jo)
    np.testing.assert_array_equal(lse.numpy(), np.asarray(jlse))


def test_q_len_one_equals_paged_decode():
    """At q_len = 1 with q_starts = length - 1 the chunk is a decode step:
    the port's prefill and decode plain versions agree."""
    args = _case(8, 2, 64, q_len=1, lengths=[17, 50, 96], q_starts=[16, 49, 95],
                 max_pages=6, seed=8)
    q, kp, vp, ks, vs, lengths, _, tables = (torch.from_numpy(a) for a in args)
    got = tprefill(*(torch.from_numpy(a) for a in args), window=30, attention_sinks=2)
    want = tdecode(q[:, :, 0], kp, vp, ks, vs, lengths, tables, window=30,
                   attention_sinks=2)
    np.testing.assert_allclose(got[:, :, 0].numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_bf16_query_keeps_dtype_and_sinks_need_window():
    q, *rest = _case(4, 2, 32, q_len=16, lengths=[16], q_starts=[0], seed=9)
    rest = [torch.from_numpy(a) for a in rest]
    out = tprefill(torch.from_numpy(q).to(torch.bfloat16), *rest)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    with pytest.raises(ValueError):
        tprefill(torch.from_numpy(q), *rest, attention_sinks=2)


def test_chip_smoke_paged_prefill_check_holds_jax_and_catches_faults():
    """chip_smoke.py's per-element bounds (paged_prefill_tolerances): the
    JAX kernel, another summation order, stands in for the CUDA kernel and
    passes; the plain version with a planted fault (one page's V scale
    taken from the next page; the causal diagonal shifted by one) fails."""
    import chip_smoke

    args = _case(8, 2, 64, q_len=40, lengths=[70, 40], q_starts=[30, 0], seed=12)
    q, kp, vp, ks, vs, lengths, starts, tables = (torch.from_numpy(a) for a in args)
    sm = 64**-0.5
    kw = dict(sm_scale=sm, window=None, softcap=None, sinks=0, save_residuals=True)
    from quantizedmha_tpu_torch.ops.paged_prefill import _paged_prefill_plain
    o, lse = _paged_prefill_plain(q, kp, vp, ks, vs, lengths, starts, tables, **kw)
    tol, lse_tol = chip_smoke.paged_prefill_tolerances(q, kp, vp, ks, vs, o, lse,
                                                       sm_scale=sm, softcap=None)
    jo, jlse = jprefill(*(jnp.asarray(a) for a in args), save_residuals=True)
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jo)), o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jlse)), lse, lse_tol) <= 1.0
    rolled = _paged_prefill_plain(q, kp, vp, ks, torch.roll(vs, 1, dims=-1), lengths,
                                  starts, tables, **kw)[0]
    shifted = _paged_prefill_plain(q, kp, vp, ks, vs, lengths, starts + 1, tables, **kw)[0]
    assert chip_smoke.err_over_tol(rolled, o, tol) > 5.0
    assert chip_smoke.err_over_tol(shifted, o, tol) > 5.0


def _kernel_rounding_int8(q, kp, vp, ks, vs, lengths, starts, tables, **kw):
    """The plain page walk with the bf16 kernel's one extra rounding: each
    p · v_scale rounded to bf16 (round to nearest even) before P·V."""
    from quantizedmha_tpu_torch.ops.paged_prefill import _prefill_walk
    heads = torch.arange(kp.shape[0])

    def load(page):
        k = kp[:, page].float().transpose(0, 1)
        v = vp[:, page].float().transpose(0, 1)
        k_sc = ks[heads[None, :], page[:, None]][..., None, None]
        v_sc = vs[heads[None, :], page[:, None]][..., None, None]
        return k, k_sc, lambda p: (p * v_sc).to(torch.bfloat16).float() @ v
    return _prefill_walk(q, kp.shape[0], lengths, starts, tables, kp.shape[2], load, **kw)


# (hq, hkv, d, page, masking kwargs of the walk)
BF16_CASES = {
    "gqa4_d64": (8, 2, 64, 16, {}),
    "window_sinks_d32": (4, 2, 32, 16, dict(window=20, sinks=3)),
    "softcap_mqa_d128": (4, 1, 128, 32, dict(softcap=2.0)),
}


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_chip_smoke_bf16_tolerance_holds_kernel_rounding_and_jax(case):
    """paged_prefill_tolerances with the bf16-P term (w_abs from
    prefill_w_abs) admits the kernel's rounding emulated on the CPU and the
    JAX kernel on bf16 q; the planted faults' analogues (one page's V scale
    taken from the next page; the causal diagonal shifted by one) still
    fail by over 5x."""
    import chip_smoke
    from quantizedmha_tpu_torch.ops.paged_prefill import _paged_prefill_plain

    hq, hkv, d, page, masks = BF16_CASES[case]
    args = _case(hq, hkv, d, q_len=40, lengths=[70, 40], q_starts=[30, 0], page=page,
                 max_pages=5, seed=20 + d)
    q, kp, vp, ks, vs, lengths, starts, tables = (torch.from_numpy(a) for a in args)
    q = q.to(torch.bfloat16)
    sm = d**-0.5
    kw = dict(sm_scale=sm, window=masks.get("window"), softcap=masks.get("softcap"),
              sinks=masks.get("sinks", 0), save_residuals=True)
    o, lse = _paged_prefill_plain(q, kp, vp, ks, vs, lengths, starts, tables, **kw)
    w_abs = chip_smoke.prefill_w_abs(q, (kp, vp, ks, vs), lengths, starts, tables, **kw)
    tol, lse_tol = chip_smoke.paged_prefill_tolerances(q, kp, vp, ks, vs, o, lse, sm_scale=sm,
                                                       softcap=kw["softcap"], w_abs=w_abs)
    eo, e_lse = _kernel_rounding_int8(q, kp, vp, ks, vs, lengths, starts, tables, **kw)
    assert eo.dtype == torch.bfloat16 and not torch.equal(eo, o)
    assert chip_smoke.err_over_tol(eo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(e_lse, lse, lse_tol) <= 1.0
    jargs = [jnp.asarray(a) for a in args]
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    jo, jlse = jprefill(*jargs, save_residuals=True, sm_scale=sm, window=kw["window"],
                        logit_softcap=kw["softcap"], attention_sinks=kw["sinks"])
    jo = torch.from_numpy(np.asarray(jo).astype(np.float32))
    assert chip_smoke.err_over_tol(jo, o, tol) <= 1.0
    assert chip_smoke.err_over_tol(torch.tensor(np.asarray(jlse)), lse, lse_tol) <= 1.0
    rolled = _paged_prefill_plain(q, kp, vp, ks, torch.roll(vs, 1, dims=-1), lengths,
                                  starts, tables, **kw)[0]
    shifted = _paged_prefill_plain(q, kp, vp, ks, vs, lengths, starts + 1, tables, **kw)[0]
    assert chip_smoke.err_over_tol(rolled, o, tol) > 5.0
    assert chip_smoke.err_over_tol(shifted, o, tol) > 5.0
