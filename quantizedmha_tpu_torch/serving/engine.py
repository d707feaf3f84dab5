"""Continuous-batching inference engine (counterpart of
quantizedmha_tpu/serving/engine.py, single paged INT8 pool).

Requests stream in and are admitted when the paged INT8 KV cache has room
(skip-ahead admission with a starvation bound); each prefill runs at a
bucketed length; all active sequences decode together, one token per step
or `decode_chunk` tokens per host round-trip through the on-device decode
loop. Finished sequences release their pages at once, so queued requests
join mid-flight. A request that can never be served fails ITSELF into
`failed`; the rest of the batch keeps decoding.

Not ported yet, and refused with NotImplementedError when set: prefix
caching and interleaved prefill (they run through chunked prefill,
ops/paged_prefill.py), the hybrid and mixed-precision KV pools, and
context-parallel prefill (ROADMAP.md queue 1 items 5-8). A prompt longer
than the largest prefill bucket needs chunked prefill too, so it fails
into `failed`. `async_dispatch` (a TPU host-overlap trick) accepts only
False.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.models.llama import LlamaConfig
from quantizedmha_tpu_torch.serving import llama_adapter
from quantizedmha_tpu_torch.serving.kv_cache import PageAllocator
from quantizedmha_tpu_torch.serving.sampling import SamplingParams, sample
from quantizedmha_tpu_torch.utils.metrics import Metrics

_CHUNKED_TODO = ("chunked prefill (ops/paged_prefill.py), not ported yet "
                 "(ROADMAP.md queue 1 item 5)")


@dataclasses.dataclass
class EngineConfig:
    num_pages: int = 128
    page_size: int = 128
    max_batch: int = 8
    max_pages_per_seq: int = 16
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    eos_id: Optional[int] = None
    max_new_tokens: int = 64
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    # >1: decode_chunk tokens per host round-trip (llama_adapter.decode_loop),
    # pages reserved per chunk; tokens past EOS within a chunk are dropped.
    decode_chunk: int = 1
    async_dispatch: bool = False
    prefix_cache: bool = False
    # Skip-ahead admission: when the queue head doesn't fit, scan up to this
    # many queued requests for one that does; after the head has been
    # bypassed starvation_limit times, admission is strict FCFS again.
    admission_window: int = 8
    starvation_limit: int = 64
    hybrid_kv: bool = False
    hybrid_pages: Optional[Dict[str, int]] = None
    interleaved_prefill: bool = False
    mixed_kv: Optional[Dict[str, int]] = None
    cp_mesh: Any = None
    cp_axis: str = "cp"


_UNPORTED = {
    "prefix_cache": "prefix caching (suffix prefill runs through " + _CHUNKED_TODO + ")",
    "interleaved_prefill": "interleaved prefill (" + _CHUNKED_TODO + ")",
    "hybrid_kv": "the hybrid per-window-group KV pools (ROADMAP.md queue 1 item 6)",
    "mixed_kv": "the mixed int8/int4 KV cache (ROADMAP.md queue 1 item 6, "
                "queue 2 rows ops/decode.py:_decode_kernel_int4, "
                "ops/paged_prefill.py:_prefill_kernel_int4)",
    "cp_mesh": "context-parallel prefill (ROADMAP.md queue 1 item 8)",
}


@dataclasses.dataclass
class _Sequence:
    seq_id: int
    prompt: List[int]
    out: List[int]
    pending: int  # sampled token whose K/V is not yet in the cache
    max_new: int

    @property
    def done_by_len(self) -> bool:
        return len(self.out) >= self.max_new


class Engine:
    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 ecfg: EngineConfig, device="cuda"):
        for name, what in _UNPORTED.items():
            if getattr(ecfg, name):
                raise NotImplementedError(f"EngineConfig.{name}: {what} is not ported yet")
        if ecfg.async_dispatch:
            raise ValueError("async_dispatch overlaps a TPU host round-trip; "
                             "this engine takes only async_dispatch=False")
        bad = [b for b in ecfg.prefill_buckets if b % ecfg.page_size]
        if bad:
            raise ValueError(
                f"prefill_buckets {bad} are not multiples of "
                f"page_size={ecfg.page_size}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = resolve_device(device)
        self.cache = llama_adapter.make_cache(cfg, ecfg.num_pages, ecfg.page_size,
                                              device=self.device)
        self.alloc = PageAllocator(ecfg.num_pages, ecfg.page_size, scrap_page=0)
        self.queue: deque = deque()
        self.active: List[_Sequence] = []
        self.finished: Dict[int, List[int]] = {}
        # Requests that can never be served: {rid: reason}; they also land
        # in `finished` with an empty token list (one terminal surface).
        self.failed: Dict[int, str] = {}
        self._head_bypass = 0
        self._next_id = 0
        self.metrics = Metrics()
        self.sampling = ecfg.sampling.validate()
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.sampling.seed)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- request lifecycle ---------------------------------------------------

    def add_request(self, prompt_tokens: List[int], max_new: Optional[int] = None) -> int:
        if not prompt_tokens:
            raise ValueError("empty prompt: at least one token is required")
        rid = self._next_id
        self._next_id += 1
        self.queue.append((
            rid, list(prompt_tokens),
            max_new if max_new is not None else self.ecfg.max_new_tokens,
        ))
        return rid

    def _bucket(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _try_admit(self) -> bool:
        if not self.queue or len(self.active) >= self.ecfg.max_batch:
            return False
        starved = self._head_bypass >= self.ecfg.starvation_limit
        scan = 1 if starved else min(
            len(self.queue), max(1, self.ecfg.admission_window))
        for idx in range(scan):
            rid, prompt, max_new = self.queue[idx]
            n = len(prompt)
            reason = self._structural_reject(n)
            if reason is not None:
                # No amount of waiting helps: fail the REQUEST, not the engine.
                del self.queue[idx]
                self._fail_request(rid, f"request {rid} (len {n}): {reason}")
                return True
            if not self.alloc.can_admit(n):
                continue
            del self.queue[idx]
            if idx == 0:
                self._head_bypass = 0
            else:
                self._head_bypass += 1
                self.metrics.inc("admission_skips")
            self._dispatch_admit(rid, prompt, max_new)
            return True
        return False

    def _fail_request(self, rid: int, reason: str) -> None:
        self.failed[rid] = reason
        self.finished[rid] = []
        self.metrics.inc("requests_failed")

    def _structural_reject(self, n: int) -> Optional[str]:
        """Why a prompt of length n can NEVER be admitted, or None."""
        if n > max(self.ecfg.prefill_buckets):
            return (f"longer than the largest prefill bucket "
                    f"({max(self.ecfg.prefill_buckets)}) — needs {_CHUNKED_TODO}")
        pages = self.alloc.pages_needed(n)
        if pages > self.ecfg.max_pages_per_seq:
            return (f"needs {pages} pages > max_pages_per_seq "
                    f"({self.ecfg.max_pages_per_seq})")
        return None

    def _dispatch_admit(self, rid: int, prompt: List[int], max_new: int) -> None:
        n = len(prompt)
        pages = self.alloc.admit(rid, n)
        bucket = self._bucket(n)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt
        with self.metrics.timed("prefill"):
            logits, k_all, v_all = llama_adapter.prefill_at(
                self.cfg, self.params, self._t(toks), n - 1)
        self.metrics.inc("requests_admitted")
        self.metrics.inc("prefill_tokens", n)
        # Zero the padding rows past the prompt before the page write: the
        # per-(head, page) scale is fitted over the whole page, and padding
        # K/V would coarsen it for the page's real tokens.
        n_write = len(pages) * self.ecfg.page_size
        k_w, v_w = k_all[:, :, :n_write], v_all[:, :, :n_write]
        if n < n_write:
            keep = (torch.arange(n_write, device=self.device) < n)[None, None, :, None]
            k_w, v_w = k_w * keep, v_w * keep
        llama_adapter.write_prefill(self.cfg, self.cache, k_w, v_w,
                                    self._t(np.asarray(pages, np.int32)),
                                    page_size=self.ecfg.page_size)
        first = self._sample(logits)
        self._activate(_Sequence(rid, prompt, [first], first, max_new))
        self._trim_windows()

    def _activate(self, seq: _Sequence) -> None:
        """Admit a freshly prefilled sequence — unless its FIRST sampled
        token already finishes it (EOS right after prefill, or max_new=1)."""
        eos = self.ecfg.eos_id is not None and seq.pending == self.ecfg.eos_id
        if seq.done_by_len or eos:
            self._finish(seq)
        else:
            self.active.append(seq)

    def _finish(self, seq: _Sequence) -> None:
        self.finished[seq.seq_id] = seq.out
        self.alloc.release(seq.seq_id)
        self.metrics.inc("requests_finished")

    def _check_extend_headroom(self, n_tokens: int) -> None:
        """Raise BEFORE mutating the allocator if extending every active
        sequence by n_tokens could exhaust the pool or a block table."""
        needed = 0
        for seq in self.active:
            length = self.alloc.lengths[seq.seq_id]
            pages_after = -(-(length + n_tokens) // self.ecfg.page_size)
            if pages_after > self.ecfg.max_pages_per_seq:
                raise RuntimeError(
                    f"seq {seq.seq_id}: extending by {n_tokens} token(s) "
                    f"needs {pages_after} pages > max_pages_per_seq "
                    f"({self.ecfg.max_pages_per_seq})")
            needed += max(0, pages_after - len(self.alloc.tables[seq.seq_id]))
        if needed > self.alloc.free_pages:
            raise RuntimeError(
                f"page pool exhausted: decoding {n_tokens} token(s) for "
                f"{len(self.active)} sequences needs {needed} new pages, "
                f"{self.alloc.free_pages} free. Raise num_pages or lower "
                f"max_batch/max_new_tokens.")

    def _sample_batch(self, logits) -> torch.Tensor:
        return sample(logits, self._generator, self.sampling)

    def _sample(self, logits) -> int:
        return int(self._sample_batch(logits)[0])

    def _tables(self, seq_ids: List[int]) -> torch.Tensor:
        """[max_batch, max_pages_per_seq] block tables, padded lanes on the
        scrap page."""
        full = np.full((self.ecfg.max_batch, self.ecfg.max_pages_per_seq),
                       self.alloc.scrap_page, np.int32)
        full[:len(seq_ids)] = self.alloc.block_table_array(
            seq_ids, self.ecfg.max_pages_per_seq)
        return self._t(full)

    # -- one engine step -----------------------------------------------------

    def step(self) -> None:
        while self._try_admit():
            pass
        if not self.active:
            return
        if self.ecfg.decode_chunk > 1:
            self._step_fused(self.ecfg.decode_chunk)
            return
        B = self.ecfg.max_batch
        nseq = len(self.active)
        self._check_extend_headroom(1)
        tokens = np.zeros(B, np.int32)
        positions = np.zeros(B, np.int32)
        slots = np.zeros(B, np.int32)
        lengths = np.ones(B, np.int32)
        pids = np.zeros(B, np.int32)
        for i, seq in enumerate(self.active):
            positions[i] = self.alloc.lengths[seq.seq_id]
            pids[i], slots[i], _ = self.alloc.extend(seq.seq_id)
            tokens[i] = seq.pending
            lengths[i] = self.alloc.lengths[seq.seq_id]
        tables = self._tables([s.seq_id for s in self.active])
        with self.metrics.timed("decode_step"):
            logits, self.cache = llama_adapter.decode_step(
                self.cfg, self.params, self.cache, self._t(tokens),
                self._t(positions), self._t(pids), self._t(slots),
                self._t(lengths), tables)
            next_tokens = self._sample_batch(logits).cpu().numpy()
        self.metrics.inc("decode_steps")
        self.metrics.inc("tokens_generated", nseq)
        self.metrics.set("active_sequences", nseq)
        self._commit(next_tokens[None, :])

    def _step_fused(self, chunk: int) -> None:
        """`chunk` decode iterations on device with one host sync; pages for
        every chunk slot are reserved up front."""
        B = self.ecfg.max_batch
        nseq = len(self.active)
        tokens = np.zeros(B, np.int32)
        lengths0 = np.ones(B, np.int32)
        ids = [s.seq_id for s in self.active]
        self._check_extend_headroom(chunk)
        for i, seq in enumerate(self.active):
            tokens[i] = seq.pending
            lengths0[i] = self.alloc.lengths[seq.seq_id]
            for _ in range(chunk):
                self.alloc.extend(seq.seq_id)
        with self.metrics.timed("decode_chunk"):
            out, self.cache = llama_adapter.decode_loop(
                self.cfg, self.params, self.cache, self._t(tokens),
                self._t(lengths0), self._tables(ids), self._generator,
                n_steps=chunk, page_size=self.ecfg.page_size,
                sampling=self.sampling)
            out = out.cpu().numpy()  # [chunk, B] — the single host sync
        self.metrics.inc("decode_steps", chunk)
        self.metrics.set("active_sequences", nseq)
        self._commit(out, count_each=True)

    def _commit(self, out: np.ndarray, count_each: bool = False) -> None:
        """Book-keep [steps, B] decoded tokens: append until EOS or the
        budget, finish and release what is done."""
        still_active = []
        for i, seq in enumerate(self.active):
            finished = False
            for j in range(out.shape[0]):
                tok = int(out[j, i])
                seq.out.append(tok)
                seq.pending = tok
                if count_each:
                    self.metrics.inc("tokens_generated")
                eos = self.ecfg.eos_id is not None and tok == self.ecfg.eos_id
                if seq.done_by_len or eos:
                    finished = True
                    break
            if finished:
                self._finish(seq)
            else:
                still_active.append(seq)
        self.active = still_active
        self._trim_windows()
        self.metrics.set("free_pages", self.alloc.free_pages)

    def _trim_windows(self) -> None:
        """Rolling-window page recycling for a model whose every layer
        shares one sliding window: pages wholly behind every active
        sequence's window (sinks aside) go back to the free list."""
        w = self.cfg.recyclable_window
        if not w:
            return
        freed = sum(self.alloc.trim_window(seq.seq_id, w, self.cfg.attention_sinks)
                    for seq in self.active)
        if freed:
            self.metrics.inc("pages_trimmed", freed)
            self.metrics.set("free_pages", self.alloc.free_pages)

    def run(self) -> Dict[int, List[int]]:
        """Drive until queue and active set drain; returns {req_id: tokens}."""
        while self.queue or self.active:
            before = len(self.finished)
            self.step()
            if not self.active and self.queue and len(self.finished) == before:
                # Nothing fits an EMPTY cache: the head request needs more
                # pages than the whole pool. Fail IT and keep draining.
                rid, prompt, _ = self.queue.popleft()
                self._fail_request(
                    rid,
                    f"request {rid} (len {len(prompt)}) cannot fit in the "
                    "cache (total page-pool capacity)")
        return dict(self.finished)
