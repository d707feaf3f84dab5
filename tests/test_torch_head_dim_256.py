"""head_dim 256 (Gemma-2-9B) on the port's attention kernels: the CUDA
wrappers admit it for the routes the serving paths take (rows 3 and 12,
the paged decode; rows 10 and 11, the paged prefill with bf16 and f32 q;
row 5, the flash forward in bf16 and f32; row 1, the INT8 flash forward
with int8 P), the training paths' (rows 6 and 7, the flash backward in
bf16 and f32) and the INT8 flash forward's bf16-P modes (rows 1-2: l over
the bf16 P' or over the f32 P'), so that no route raises, and the plain
versions, which the kernels are held to on the card, agree with the JAX
package's Pallas kernels (interpret mode) at d=256.

Tolerances as in test_torch_decode.py, test_torch_paged_prefill.py and
test_torch_flash.py: f32 from the same int8 pages, summation order only,
rtol = atol = 1e-5 (lse 1e-5); bf16 flash, atol 2^-8 max|v| and rtol 2^-7
(one bf16 rounding of P and of the output); row 1 as
test_torch_flash_int8_int8p_tiles.py states it (chip_smoke.flash_tolerances:
two P-rounding flips of a row and 1e-5 of f32 order; rows where XLA's
jitted Q quantizer gives other int8 Q than the exact one left out)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantizedmha_tpu.ops.decode import paged_decode_attention as jdecode
from quantizedmha_tpu.ops.flash_attention_int8 import flash_attention_int8 as jfa8
from quantizedmha_tpu.ops.paged_prefill import paged_prefill_attention as jprefill
import chip_smoke
import test_torch_flash_int8_tiles as bf16p_tiles
from quantizedmha_tpu_torch.ops import cuda_lib
from quantizedmha_tpu_torch.ops import decode as tdec
from quantizedmha_tpu_torch.ops import flash_attention as tfa
from quantizedmha_tpu_torch.ops import flash_attention_int8 as tfa8
from quantizedmha_tpu_torch.ops import paged_prefill as tpp
from quantizedmha_tpu_torch.ops.flash_attention import _offsets
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

jfa = importlib.import_module("quantizedmha_tpu.ops.flash_attention")
D = 256
TOL = 1e-5


def test_serving_routes_admit_head_dim_256(monkeypatch):
    """Every serving route's wrapper takes d=256 and builds its launch (no
    card needed to build it; the stream is stubbed): the INT8 flash
    forward with int8 P (row 1), the f32 flash forward (row 5's CUDA-core
    route, with no planes scratch) and the paged prefill with f32 q, over
    INT8 pages (row 10) and INT4 pages (row 11)."""
    for mod in (tdec, tpp, tfa, tfa8):
        assert 256 in mod._HEAD_DIMS, mod.__name__
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    q = torch.zeros((1, 2, 8, D), dtype=torch.bfloat16)
    k8 = torch.zeros((1, 1, 8, D), dtype=torch.int8)
    kernel, args, (o, lse), _ = tfa8._flash_int8_launch(
        q, k8, torch.ones((1, 1, 1)), k8, torch.ones((1, 1, 1)), _offsets(0, 0, 1, q.device),
        sm_scale=D**-0.5, causal=True, kv_len=8, block_kv=8, scale_clamp=1e-8, p_scale=127.0,
        window=None, softcap=50.0, sinks=0, mode=0, save_residuals=True)
    assert kernel is tfa8.FLASH_INT8_P and kernel.launches == 0
    assert args[14] == D and args[-3] == 0 and o.shape == q.shape and lse.shape == (1, 2, 8)
    qf = q.float()
    kv = torch.zeros((1, 1, 8, D))
    masks = dict(window=None, softcap=50.0, sinks=0)
    kernel, args, (o, lse), operands = tfa._flash_fwd_launch(
        qf, kv, kv, _offsets(0, 0, 1, q.device), sm_scale=D**-0.5, causal=True, block_kv=8,
        save_residuals=True, **masks)
    assert kernel is tfa.FLASH_FWD_F32 and kernel.launches == 0
    assert operands[-1] is None and args[6] is None  # no bf16 planes at d=256
    assert args[12] == D and args[-2] == 0 and o.dtype == torch.float32
    one = torch.ones(1, dtype=torch.int32)
    tables = torch.ones((1, 2), dtype=torch.int32)
    for int4, kern in ((False, tpp.PAGED_PREFILL), (True, tpp.PAGED_PREFILL_INT4)):
        pages = torch.zeros((1, 3, 16, D // 2 if int4 else D), dtype=torch.int8)
        scales = torch.ones((1, 3, 4) if int4 else (1, 3))
        kernel, args, (o, lse), _ = tpp._paged_prefill_launch(
            qf, pages, pages, scales, scales, one * 8, one * 0, tables, sm_scale=D**-0.5,
            save_residuals=True, int4=int4, **masks)
        assert kernel is kern and kernel.launches == 0
        assert args[19] == D and args[-2] == 0 and o.dtype == torch.float32


def test_routes_left_out_raise_naming_their_item(monkeypatch):
    """No route is left out at head_dim 256: the INT8 flash forward with
    bf16 P builds its launch in both modes (1: l over the bf16 P', 2: l
    over the f32 P'), each on its own counter, and the flash backward (rows
    6 and 7, the training paths') builds both launches at D = 256 (the
    stream stubbed), in f32 with the bf16 flag 0 and in bf16 with it 1."""
    q = torch.zeros((1, 2, 8, D))
    kv = torch.zeros((1, 1, 8, D))
    offs = _offsets(0, 0, 1, q.device)
    masks = dict(window=None, softcap=None, sinks=0)
    monkeypatch.setattr(cuda_lib, "stream_of", lambda t: 0)
    for dt, flag in ((torch.float32, 0), (torch.bfloat16, 1)):
        qd, kvd = q.to(dt), kv.to(dt)
        launches, _, _ = tfa._flash_bwd_launch(qd, kvd, kvd, qd, torch.zeros((1, 2, 8)), qd, offs,
                                               sm_scale=D**-0.5, causal=True, **masks)
        assert [k for k, _ in launches] == [tfa.FLASH_BWD_DKV, tfa.FLASH_BWD_DQ]
        assert all(args[-9] == D and args[-2] == flag for _, args in launches)
    k8 = torch.zeros((1, 1, 8, D), dtype=torch.int8)
    for mode, counter in ((1, tfa8.FLASH_BF16_P), (2, tfa8.FLASH_BF16_P_F32L)):
        kernel, args, (o, lse), _ = tfa8._flash_int8_launch(
            q, k8, torch.ones((1, 1, 1)), k8, torch.ones((1, 1, 1)), offs, sm_scale=D**-0.5,
            causal=False, kv_len=8, block_kv=8, scale_clamp=1e-8, p_scale=127.0, mode=mode,
            save_residuals=False, **masks)
        assert kernel is counter and kernel.launches == 0
        assert args[14] == D and args[-3] == mode and o.shape == q.shape and lse is None


def _pages(rng, hkv, num_pages, page):
    kp, vp = rng.integers(-127, 128, (2, hkv, num_pages, page, D)).astype(np.int8)
    ks, vs = rng.uniform(0.002, 0.02, (2, hkv, num_pages)).astype(np.float32)
    return kp, vp, ks, vs


def test_paged_decode_plain_matches_jax_at_256():
    """Row 3's plain walk, Gemma-2's attention (GQA 2, sm_scale 256^-0.5,
    softcap 50, a window) against the JAX kernel, output and lse."""
    rng = np.random.default_rng(0)
    lengths = np.asarray([9, 40, 23], np.int32)
    tables = (rng.permutation(12)[:9] + 1).reshape(3, 3).astype(np.int32)
    q = rng.normal(0, 1, (3, 4, D)).astype(np.float32)
    args = (q, *_pages(rng, 2, 13, 16), lengths, tables)
    kw = dict(sm_scale=D**-0.5, logit_softcap=50.0, window=20, save_residuals=True)
    o, lse = tdec.paged_decode_attention(*(torch.from_numpy(a) for a in args), **kw)
    jo, jlse = jdecode(*(jnp.asarray(a) for a in args), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=TOL, atol=TOL)


def test_paged_prefill_plain_matches_jax_at_256():
    """Row 10's plain walk: a 24-row chunk at position 16 of two sequences
    over pages of 16, GQA 2, softcap 50, a window of 20."""
    rng = np.random.default_rng(1)
    tables = (rng.permutation(10)[:8] + 1).reshape(2, 4).astype(np.int32)
    q = rng.normal(0, 1, (2, 4, 24, D)).astype(np.float32)
    args = (q, *_pages(rng, 2, 11, 16), np.asarray([40, 30], np.int32),
            np.asarray([16, 6], np.int32), tables)
    kw = dict(sm_scale=D**-0.5, logit_softcap=50.0, window=20, save_residuals=True)
    o, lse = tpp.paged_prefill_attention(*(torch.from_numpy(a) for a in args), **kw)
    jo, jlse = jprefill(*(jnp.asarray(a) for a in args), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=TOL, atol=TOL)


def test_flash_forward_plain_matches_jax_at_256():
    """Row 5's plain version in bf16, causal GQA 2 with softcap 50 and a
    window of 24, against the JAX kernel."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(0, 1.5, s).astype(np.float32)
               for s in ((1, 4, 48, D), (1, 2, 48, D), (1, 2, 48, D)))
    kw = dict(causal=True, block_kv=16, sm_scale=D**-0.5, logit_softcap=50.0, window=24)
    got = tfa.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                              **kw)
    want = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 48, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2.0**-7, atol=2.0**-8 * float(np.abs(v).max()))


# The INT8 flash forward's routes at d=256: (numerics mode, the route's
# keywords). "causal" and "window_sinks": the default route at d > 128,
# _int8_fwd_kernel with int8 P (mode 0); "std_bf16p": the same kernel with
# pv_dtype="bf16" (mode 2); "t_mxu" and "t_vpu": _int8_fwd_kernel_t forced
# by transposed=True, l over the bf16 P' (mode 1) or over the f32 P' (mode
# 2), with the window and sinks in turn.
INT8_ROUTES_256 = {"causal": (0, {}), "window_sinks": (0, dict(window=40, attention_sinks=4)),
                   "std_bf16p": (2, dict(pv_dtype="bf16")),
                   "t_mxu": (1, dict(transposed=True, window=40, attention_sinks=4)),
                   "t_vpu": (2, dict(transposed=True, summode="vpu"))}


@pytest.mark.parametrize("case", list(INT8_ROUTES_256))
def test_flash_int8_plain_matches_jax_at_256(case):
    """Rows 1-2's plain version in the route's numerics mode against JAX's
    flash_attention_int8 with the same keywords (Pallas in interpret
    mode): GQA 2, sm_scale 256^-0.5, softcap 50, quant blocks of 32 (two of
    them, so the softmax steps), causal, S=64; the port's output is the
    plain version's in that mode bit for bit."""
    mode, route = INT8_ROUTES_256[case]
    rng = np.random.default_rng(3 + len(case))
    S = 64
    q = rng.normal(0, 2.0, (1, 4, S, D)).astype(np.float32)
    k, v = rng.normal(0, 1.0, (2, 1, 2, S, D)).astype(np.float32)
    kw = dict(sm_scale=D**-0.5, causal=True, block_kv=32, logit_softcap=50.0, **route)
    got = tfa8.flash_attention_int8(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    want = torch.from_numpy(np.array(jfa8(*(jnp.asarray(x) for x in (q, k, v)), **kw)))
    k_i8, ks = tfa8.quantize_kv_blocks(torch.from_numpy(k), 32)
    v_i8, vs = tfa8.quantize_kv_blocks(torch.from_numpy(v), 32)
    pkw = dict(sm_scale=D**-0.5, causal=True, kv_len=S, block_kv=32, scale_clamp=1e-8,
               p_scale=127.0, window=route.get("window"), softcap=50.0,
               sinks=route.get("attention_sinks", 0), mode=mode)
    operands = (torch.from_numpy(q), k_i8, ks, v_i8, vs, _offsets(0, 0, 1, "cpu"))
    plain = tfa8._flash_int8_plain(*operands, save_residuals=False, **pkw)
    _, _, l = tfa8._flash_int8_plain_state(*operands, **pkw)
    tol, _ = chip_smoke.flash_tolerances(plain, None, l, v_i8, vs, 32, mode)
    assert torch.equal(got, plain)
    keep = ~bf16p_tiles._tie_rows(torch.from_numpy(q))
    assert keep.float().mean() > 0.95
    assert chip_smoke.err_over_tol(got[keep], want[keep], tol.expand_as(got)[keep]) <= 1.0


def test_planted_faults_name_committed_lines():
    """Each of chip_smoke.py's planted faults (the d=256 ones among them)
    names a line that occurs exactly once in its source and changes it, as
    the faults phase requires before it builds the copies; a header's fault
    held to some sources names sources that include the header."""
    import pathlib

    import chip_smoke
    csrc = pathlib.Path(tdec.__file__).resolve().parents[1] / "csrc"
    d256 = [f for f in chip_smoke.PLANTED_FAULTS if f[1].startswith("d=256")]
    assert {f[0] for f in d256} == {"paged_decode.cu", "paged_prefill.cu", "mma_bf16.cuh",
                                    "flash_int8_fwd.cu", "flash_bwd.cu", "flash_fwd.cu"}
    assert sum(f[0] == "flash_bwd.cu" for f in d256) >= 3  # rows 6-7's d=256 kernels
    for fname, what, old, new, *only in chip_smoke.PLANTED_FAULTS:
        assert (csrc / fname).read_text().count(old) == 1 and new != old, what
        for src in (only[0] if only else ()):
            assert src in chip_smoke.FAULT_SOURCES, what
            assert f'#include "{fname}"' in (csrc / f"{src}.cu").read_text(), what
