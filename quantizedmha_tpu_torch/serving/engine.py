"""Continuous-batching inference engine (counterpart of
quantizedmha_tpu/serving/engine.py: a single paged INT8 pool, or the mixed
INT8 / INT4 pool pair).

Requests stream in and are admitted when the paged KV cache has room
(skip-ahead admission with a starvation bound); a prompt up to the largest
bucket prefills at a bucketed length through the model's attention, a
longer one in chunks of the largest bucket through the paged cache
(llama_adapter.prefill_chunk); all active sequences decode together, one
token per step or `decode_chunk` tokens per host round-trip through the
on-device decode loop. Finished sequences release their pages at once, so
queued requests join mid-flight. A request that can never be served fails
ITSELF into `failed`; the rest of the batch keeps decoding.

prefix_cache shares page-aligned prompt prefixes already in the cache
(refcounted pages, a sha1 chain over page-sized token chunks) and
prefills only the suffix; interleaved_prefill runs a long prompt's chunks
one per engine step, so active sequences keep decoding between them.

mixed_kv serves from the mixed-precision cache (serving/mixed_kv.py):
INT8 pages for positions below `boundary_tokens` (the attention-sink /
early-context region), nibble-packed INT4 pages for the rest, about twice
the context per byte of cache; attention merges the two partial softmaxes
exactly by lse. Keys: boundary_tokens (page-aligned), int8_pages,
int4_pages, optional subs (INT4 scale sub-tiles a page, default 4). It
needs a uniform window pattern, attention_sinks == boundary_tokens when
windowed, and no prefix_cache. Per-sequence capacity becomes
boundary_tokens + max_pages_per_seq * page_size (the int4 table is the
growth frame).

hybrid_kv gives each window group of a per-layer window pattern (Gemma-2's
alternating 4096-token sliding and full layers) its own page pool and
block tables: a sliding group's pages recycle behind its own window while
the full group keeps its pages, so a sequence holds L_full * O(context) +
L_slide * O(window + sinks) of KV. hybrid_pages sizes each pool by group
key ("full", "w4096"; the rest take num_pages). A uniform pattern makes it
a no-op. hybrid_kv with mixed_kv puts the mixed pool pair on the full group
(its INT4 bulk takes the context that grows) and keeps the sliding groups
plain INT8; it needs a full group and no prefix_cache.

cp_mesh (a DeviceMesh; its `cp_axis` group) runs each bucketed prefill
context-parallel: every rank of the group prefills its shard of the
bucket's sequence with ring attention a layer
(llama_adapter.prefill_cp_at), the whole prompt's K/V are gathered once,
and every rank writes them to its own cache and decodes the same batch
(the SPMD host code is the same on each rank). Buckets must be multiples
of the axis size.

serving/sharded.py's TPEngine is this engine on each rank's shard of the
weights and KV heads: the adapter runs `acfg` (the local config) and
all-reduces over `tp_group`. `async_dispatch` (a TPU host-overlap trick)
accepts only False.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.models.llama import LlamaConfig
from quantizedmha_tpu_torch.serving import llama_adapter
from quantizedmha_tpu_torch.serving.kv_cache import MixedPageAllocator, PageAllocator
from quantizedmha_tpu_torch.serving.sampling import SamplingParams, sample
from quantizedmha_tpu_torch.utils.metrics import Metrics

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
    # Context-parallel bucketed prefill over this DeviceMesh's cp_axis group
    # (module docstring); buckets must be multiples of the axis size.
    cp_mesh: Any = None
    cp_axis: str = "cp"


def _hybrid_pages(groups, ecfg: EngineConfig) -> Dict[str, int]:
    pages_by_group = dict(ecfg.hybrid_pages or {})
    unknown = set(pages_by_group) - set(groups)
    if unknown:
        raise ValueError(
            f"hybrid_pages keys {sorted(unknown)} match no window group of this "
            f"model (groups: {sorted(groups)})")
    return {k: pages_by_group.get(k, ecfg.num_pages) for k in groups}


def build_pools(cfg: LlamaConfig, ecfg: EngineConfig, device):
    """(cache, allocs, primary allocator, hybrid) for a model's KV state;
    SpecDecodeEngine builds its draft's with it too (the draft's own
    pattern decides whether its pools are hybrid).

    hybrid (ecfg.hybrid_kv on a pattern of more than one window group): one
    cache and PageAllocator a group, page 0 of each pool its scrap page;
    `allocs` is the group dict, and the primary allocator (the full group's
    when there is one: its tables are never trimmed) holds the lengths
    every pool shares. With mixed_kv the full group's is a
    MixedPageAllocator over its INT8 / INT4 pair. Otherwise one pool, INT8
    or the mixed INT8 / INT4 pair, and allocs None."""
    groups = llama_adapter.window_groups(cfg)
    hybrid = bool(ecfg.hybrid_kv) and len(groups) > 1
    if ecfg.mixed_kv is not None:
        mk = dict(ecfg.mixed_kv)
        boundary = mk["boundary_tokens"]
        if hybrid:
            pages_by_group = _hybrid_pages(groups, ecfg)
            cache = llama_adapter.make_cache_hybrid_mixed(
                cfg, pages_by_group, ecfg.page_size, n8_pages=mk["int8_pages"],
                n4_pages=mk["int4_pages"], subs=mk.get("subs", 4), device=device)
            allocs = {k: (MixedPageAllocator(mk["int8_pages"], mk["int4_pages"],
                                             ecfg.page_size, boundary)
                          if k == "full" else
                          PageAllocator(pages_by_group[k], ecfg.page_size, scrap_page=0))
                      for k in groups}
            return cache, allocs, allocs["full"], True
        if len(set(cfg.layer_windows)) != 1:
            raise ValueError("mixed_kv needs a uniform window pattern (use hybrid_kv "
                             "for per-layer patterns)")
        if cfg.recyclable_window and cfg.attention_sinks != boundary:
            raise ValueError(
                f"windowed mixed_kv needs attention_sinks ({cfg.attention_sinks}) == "
                f"boundary_tokens ({boundary}): the int8 region must be exactly the "
                "always-visible sinks")
        cache = llama_adapter.make_cache_mixed(
            cfg, mk["int8_pages"], mk["int4_pages"], ecfg.page_size,
            subs=mk.get("subs", 4), device=device)
        alloc = MixedPageAllocator(mk["int8_pages"], mk["int4_pages"], ecfg.page_size,
                                   boundary)
        return cache, None, alloc, False
    if hybrid:
        pages_by_group = _hybrid_pages(groups, ecfg)
        cache = llama_adapter.make_cache_hybrid(cfg, pages_by_group, ecfg.page_size,
                                                device=device)
        allocs = {k: PageAllocator(pages_by_group[k], ecfg.page_size, scrap_page=0)
                  for k in groups}
        primary = "full" if "full" in allocs else sorted(allocs)[0]
        return cache, allocs, allocs[primary], True
    cache = llama_adapter.make_cache(cfg, ecfg.num_pages, ecfg.page_size, device=device)
    return cache, None, PageAllocator(ecfg.num_pages, ecfg.page_size, scrap_page=0), False


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


@dataclasses.dataclass
class _PrefillTask:
    """An in-flight interleaved chunked prefill: its pages are admitted
    (the table is fixed), its chunks run one per engine step."""
    rid: int
    prompt: List[int]
    max_new: int
    # [max_pages_per_seq] int32 on the device; mixed: (table8, table4);
    # hybrid: {group: table}, a mixed group's a pair
    table: Any
    next_start: int
    chunk: int


class Engine:
    # Tensor parallelism (serving/sharded.py's TPEngine sets both): the
    # process group the adapter all-reduces over, None on one rank.
    tp_group = None

    def _local(self, cfg: LlamaConfig) -> LlamaConfig:
        """The config the adapter runs for model `cfg`: a TP rank's local
        config (its share of the heads), here the model's own."""
        return cfg

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any],
                 ecfg: EngineConfig, device="cuda"):
        if ecfg.async_dispatch:
            raise ValueError("async_dispatch overlaps a TPU host round-trip; "
                             "this engine takes only async_dispatch=False")
        bad = [b for b in ecfg.prefill_buckets if b % ecfg.page_size]
        if bad:
            raise ValueError(
                f"prefill_buckets {bad} are not multiples of "
                f"page_size={ecfg.page_size}")
        self.cp_group = None if ecfg.cp_mesh is None else self._cp_group(ecfg)
        if self.cp_group is not None and self.tp_group is not None:
            raise ValueError("cp_mesh and tensor parallelism do not compose in one engine")
        self.cfg = cfg
        self.acfg = self._local(cfg)  # what the adapter runs
        self.params = params
        self.ecfg = ecfg
        self.device = resolve_device(device)
        # Window groups ("full", "w<N>" -> layers) and each group's window:
        # the hybrid pools and their trims key on them.
        self.groups = llama_adapter.window_groups(cfg)
        self.group_windows = {llama_adapter.group_key(w): w for w in set(cfg.layer_windows)}
        self.cache, self.allocs, self.alloc, self.hybrid = build_pools(self.acfg, ecfg,
                                                                      self.device)
        # Three cache modes: `mixed`, one mixed pool pair for a uniform
        # pattern; `hybrid_mixed`, group pools whose full group is mixed;
        # plain hybrid or single otherwise.
        self.mixed = ecfg.mixed_kv is not None and not self.hybrid
        self.hybrid_mixed = ecfg.mixed_kv is not None and self.hybrid
        # The boundary every mixed pool pair splits at (None without one).
        self.boundary = self.alloc.boundary if ecfg.mixed_kv is not None else None
        if ecfg.mixed_kv is not None and ecfg.prefix_cache:
            raise ValueError("prefix_cache does not compose with mixed_kv yet (shared "
                             "pages would need per-pool digest maps AND a "
                             "boundary-stable split)")
        # Prefix cache, per pool group ("shared" for the single pool):
        # (group, chain digest) -> page id and back; each pool's on_free
        # hook drops a page's entry when its last reference goes, window
        # trims included.
        self._prefix_map: Dict[Tuple[str, bytes], int] = {}
        self._page_hash: Dict[Tuple[str, int], bytes] = {}
        if ecfg.prefix_cache:
            for k, a in self._prefix_groups().items():
                a.on_free = functools.partial(self._on_page_free, k)
        self.queue: deque = deque()
        self.active: List[_Sequence] = []
        self.prefilling: List[_PrefillTask] = []  # interleaved_prefill FIFO
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

    @staticmethod
    def _cp_group(ecfg: EngineConfig):
        """The cp axis's process group of ecfg.cp_mesh, its buckets checked."""
        if not isinstance(ecfg.cp_mesh, DeviceMesh):
            raise TypeError(f"cp_mesh takes a torch.distributed DeviceMesh "
                            f"(parallel.make_mesh), got {type(ecfg.cp_mesh).__name__}")
        names = ecfg.cp_mesh.mesh_dim_names or ()
        if ecfg.cp_axis not in names:
            raise ValueError(f"cp_mesh has no axis {ecfg.cp_axis!r} (axes {names})")
        n = ecfg.cp_mesh.size(names.index(ecfg.cp_axis))
        group = ecfg.cp_mesh.get_group(ecfg.cp_axis)
        if dist.get_world_size(group) != n:
            raise ValueError(f"the {ecfg.cp_axis!r} group has {dist.get_world_size(group)} "
                             f"ranks where the mesh gives {n}")
        bad = [b for b in ecfg.prefill_buckets if b % n]
        if bad:
            raise ValueError(f"prefill_buckets {bad} are not multiples of the cp axis size {n}")
        return group

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- hybrid pool helpers -------------------------------------------------

    def _prefix_groups(self) -> Dict[str, PageAllocator]:
        """Every pool by group, as the prefix cache keys them: one a window
        group (hybrid), else the single pool under the key "shared"."""
        return self.allocs if self.hybrid else {"shared": self.alloc}

    def _pools(self):
        """This engine's pools: {group: pool} (hybrid) or the single pool.
        The pool helpers below take such a value for another model's pools
        (speculation passes its draft's)."""
        return self.allocs if self.hybrid else self.alloc

    def _each_alloc(self, pools=None) -> List[PageAllocator]:
        pools = self._pools() if pools is None else pools
        return list(pools.values()) if isinstance(pools, dict) else [pools]

    def _admit_all(self, rid: int, n: int, pools=None):
        """Admit into every pool of a group dict (each checked before any
        is touched, so a failed admission leaks no page) or the single one:
        {group: fresh pages}, or the single pool's pages."""
        pools = self._pools() if pools is None else pools
        if not isinstance(pools, dict):
            return pools.admit(rid, n)
        short = [k for k, a in pools.items() if not a.can_admit(n)]
        if short:
            raise RuntimeError(f"out of pages in group(s) {sorted(short)} admitting {n} tokens")
        return {k: a.admit(rid, n) for k, a in pools.items()}

    def _write_prompt(self, cfg: LlamaConfig, cache, pages, k_all, v_all, n: int) -> None:
        """A bucketed prompt's K/V ([L, Hkv, bucket, hd], n real tokens) to
        its fresh pages: {group: pages} (hybrid), a mixed pool's (below the
        boundary, past it) pair, or one pool's. The padding rows past the
        prompt are zeroed first: the per-(head, page) scale is fitted over
        the whole page, and padding K/V would coarsen it for the page's
        real tokens."""
        ps = self.ecfg.page_size
        n_write = -(-n // ps) * ps
        k_w, v_w = k_all[:, :, :n_write], v_all[:, :, :n_write]
        if n < n_write:
            keep = (torch.arange(n_write, device=self.device) < n)[None, None, :, None]
            k_w, v_w = k_w * keep, v_w * keep
        if isinstance(pages, dict):
            llama_adapter.write_prefill_hybrid(
                cfg, cache, k_w, v_w, {k: self._ids(p) for k, p in pages.items()}, page_size=ps)
        elif isinstance(pages, tuple):
            llama_adapter.write_prefill_mixed(cfg, cache, k_w, v_w, *self._ids(pages),
                                              page_size=ps)
        else:
            llama_adapter.write_prefill(cfg, cache, k_w, v_w, self._ids(pages), page_size=ps)

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

    def _resolve_prefix(self, prompt: List[int]):
        """Usable cached-prefix slots for this prompt, a slot list ({group:
        slot list} when hybrid); empty when disabled, missed, or when
        suffix chunking cannot fit the table."""
        miss = {} if self.hybrid else []
        if not self.ecfg.prefix_cache:
            return miss
        cached = self._cached_prefix(prompt)
        if cached and self._suffix_chunk(len(prompt), self._cached_len(cached)) is None:
            return miss
        return cached

    @staticmethod
    def _cached_len(cached) -> int:
        """Reused prefix pages (table slots; every group's row of a hybrid
        hit has the same length, scrap slots included)."""
        if isinstance(cached, dict):
            return len(next(iter(cached.values()))) if cached else 0
        return len(cached)

    def _fits(self, prompt: List[int]) -> bool:
        n = len(prompt)
        cached = self._resolve_prefix(prompt)
        if not cached:
            return all(a.can_admit(n) for a in self._each_alloc())
        # Fresh pages are needed only past the reused slots.
        m = self._cached_len(cached)
        return all(a.pages_needed(n) - m <= a.free_pages for a in self._each_alloc())

    def _try_admit(self) -> bool:
        if (not self.queue or len(self.active) + len(self.prefilling)
                >= self.ecfg.max_batch):
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
            if not self._fits(prompt):
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
        """Why a prompt of length n can NEVER be admitted (its block table
        cannot hold it), or None. Chunked prefill claims whole chunks of
        table slots, the padded last chunk included."""
        ps = self.ecfg.page_size
        chunk = max(self.ecfg.prefill_buckets)
        # Mixed: the int8 region adds boundary pages of per-sequence
        # capacity on top of the int4 table, the frame of the claims.
        bp = self.alloc.bp if self.mixed else 0
        if n > chunk:
            claim = max(-(-n // chunk) * chunk // ps - bp, 0)
            if claim > self.ecfg.max_pages_per_seq:
                return (f"chunked prefill needs {claim} table slots > "
                        f"max_pages_per_seq ({self.ecfg.max_pages_per_seq})")
        elif -(-n // ps) > self.ecfg.max_pages_per_seq + bp:
            return (f"needs {-(-n // ps)} pages > max_pages_per_seq "
                    f"({self.ecfg.max_pages_per_seq + bp})")
        return None

    def _dispatch_admit(self, rid: int, prompt: List[int], max_new: int) -> None:
        n = len(prompt)
        cached = self._resolve_prefix(prompt)
        if cached:
            self._admit_cached(rid, prompt, max_new, cached)
            return
        if n > max(self.ecfg.prefill_buckets):
            self._admit_chunked(rid, prompt, max_new)
            return
        pages = self._admit_all(rid, n)
        bucket = self._bucket(n)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = prompt
        with self.metrics.timed("prefill"):
            logits, k_all, v_all = self._prefill_bucket(toks, n)
        self.metrics.inc("requests_admitted")
        self.metrics.inc("prefill_tokens", n)
        self._write_prompt(self.acfg, self.cache, pages, k_all, v_all, n)
        first = self._sample(logits)
        self._register_prefix(prompt, rid)
        self._activate(_Sequence(rid, prompt, [first], first, max_new))
        self._trim_windows()

    def _prefill_bucket(self, toks: np.ndarray, n: int):
        """A bucketed prompt's prefill: (logits, k_all, v_all), the whole
        bucket's K/V on every rank; context-parallel over cp_group (this
        rank prefills its contiguous shard of the bucket) when set."""
        if self.cp_group is None:
            return llama_adapter.prefill_at(self.acfg, self.params, self._t(toks), n - 1,
                                            group=self.tp_group)
        size, idx = dist.get_world_size(self.cp_group), dist.get_rank(self.cp_group)
        shard = toks.shape[1] // size
        return llama_adapter.prefill_cp_at(
            self.acfg, self.params, self._t(toks[:, idx * shard:(idx + 1) * shard]), n - 1,
            group=self.cp_group)

    def _ids(self, pages):
        """Fresh page ids on the device; a mixed pool's (INT8, INT4) pair."""
        if isinstance(pages, tuple):
            return tuple(self._ids(p) for p in pages)
        return self._t(np.asarray(pages, np.int32))

    def _table(self, rid: int, allocs=None):
        """One sequence's block table row, [max_pages_per_seq] on the
        device; mixed: the ([boundary_pages], [max_pages_per_seq]) pair;
        hybrid: {group: row}. `allocs` as in _tables_for."""
        t = self._tables_for([rid], 1, allocs)
        if isinstance(t, dict):
            return {k: tuple(x[0] for x in v) if isinstance(v, tuple) else v[0]
                    for k, v in t.items()}
        return tuple(x[0] for x in t) if isinstance(t, tuple) else t[0]

    def _run_chunk(self, prompt: List[int], start: int, chunk: int, table):
        """Prefill prompt[start:start + chunk] (right-padded) through the
        paged cache; returns the logits of its last real token."""
        part = prompt[start:start + chunk]
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :len(part)] = part
        with self.metrics.timed("prefill"):
            logits, self.cache = llama_adapter.prefill_chunk(
                self.acfg, self.params, self.cache, self._t(toks), start, table,
                len(part) - 1, page_size=self.ecfg.page_size, boundary_tokens=self.boundary,
                group=self.tp_group)
        return logits

    def _admit_chunked(self, rid: int, prompt: List[int], max_new: int) -> None:
        """Prefill a prompt longer than the largest bucket in chunks of that
        bucket: each chunk's K/V go to the paged INT8 cache, then the chunk
        attends to the prefix (itself included) from the pages. With
        interleaved_prefill the chunks run one per step() instead."""
        chunk = max(self.ecfg.prefill_buckets)
        n = len(prompt)
        self._admit_all(rid, n)
        table = self._table(rid)
        if self.ecfg.interleaved_prefill:
            self.prefilling.append(_PrefillTask(rid, prompt, max_new, table, 0, chunk))
            return
        logits = None
        for start in range(0, n, chunk):
            logits = self._run_chunk(prompt, start, chunk, table)
        self._complete_prefill(rid, prompt, max_new, logits, n)

    def _complete_prefill(self, rid: int, prompt: List[int], max_new: int, logits,
                          n_prefilled: int) -> None:
        self.metrics.inc("requests_admitted")
        self.metrics.inc("prefill_tokens", n_prefilled)
        first = self._sample(logits)
        self._register_prefix(prompt, rid)
        self._activate(_Sequence(rid, prompt, [first], first, max_new))
        # Never trim mid-chunked-prefill (later chunks read earlier slots):
        # only once the whole prompt is in the cache.
        self._trim_windows()

    # -- automatic prefix caching ---------------------------------------------

    def _page_chain(self, prompt: List[int]):
        """Yield (page_index, chain_digest) for each FULL page of the
        prompt: digest_i = sha1(digest_{i-1} || tokens of page i), so a hit
        certifies the whole prefix, not just one page."""
        ps = self.ecfg.page_size
        h = b""
        for i in range(len(prompt) // ps):
            h = hashlib.sha1(
                h + np.asarray(prompt[i * ps:(i + 1) * ps], np.int32).tobytes()).digest()
            yield i, h

    def _cached_prefix(self, prompt: List[int]):
        """Longest usable run of cached prefix pages, capped so that at least
        one suffix token remains to prefill (its logits give the first
        sampled token): a slot list, or {group: slot list} when hybrid.
        A full-attention pool needs every page of the run; a sliding pool
        (a sliding group's, or the single pool of a model whose every layer
        shares one window) needs only the pages a sequence of that prefix
        length would still hold after trim_window (sink pages and pages
        not wholly behind the window); older slots are None, ride the scrap
        page and stay unread under the window mask. The hash chain makes a
        hit in any group certify the whole token prefix, so each group is
        checked for its pages only. Shrinking the run slides the window
        back, so runs are tried longest first."""
        ps = self.ecfg.page_size
        limit = (len(prompt) - 1) // ps
        digests = [h for i, h in self._page_chain(prompt) if i < limit]
        groups = self._prefix_groups()
        hits = {k: [self._prefix_map.get((k, h)) for h in digests] for k in groups}
        sinks = self.cfg.attention_sinks or 0
        sink_blocks = -(-sinks // ps) if sinks else 0
        for m in range(limit, 0, -1):
            rows: Optional[Dict[str, List[Optional[int]]]] = {}
            for k in groups:
                w = self.group_windows.get(k) if self.hybrid else self.cfg.recyclable_window
                first_block = max(m * ps - w, 0) // ps if w else 0
                row: List[Optional[int]] = []
                for i in range(m):
                    needed = i < sink_blocks or i >= first_block
                    if needed and hits[k][i] is None:
                        rows = None
                        break
                    row.append(hits[k][i] if needed else None)
                if rows is None:
                    break
                rows[k] = row
            if rows is not None:
                return rows if self.hybrid else rows["shared"]
        return {} if self.hybrid else []

    def _register_prefix(self, prompt: List[int], rid: int) -> None:
        if not self.ecfg.prefix_cache:
            return
        for k, a in self._prefix_groups().items():
            table = a.tables[rid]
            for i, h in self._page_chain(prompt):
                page = table[i]
                if page is None:  # window-trimmed slot
                    continue
                if (k, h) not in self._prefix_map and (k, page) not in self._page_hash:
                    self._prefix_map[(k, h)] = page
                    self._page_hash[(k, page)] = h

    def _on_page_free(self, group: str, page: int) -> None:
        h = self._page_hash.pop((group, page), None)
        if h is not None:
            self._prefix_map.pop((group, h), None)

    def _suffix_chunk(self, n: int, n_cached_pages: int) -> Optional[int]:
        """Chunk size for prefilling the uncached suffix (the smallest
        bucket that holds it, else the largest), or None if no bucket fits
        the block table: every chunk, the padded last one included, claims
        chunk // page_size contiguous slots past the cached prefix."""
        ps = self.ecfg.page_size
        suffix = n - n_cached_pages * ps
        largest = max(self.ecfg.prefill_buckets)
        for b in sorted(self.ecfg.prefill_buckets):
            if b < suffix and b != largest:
                continue
            slots = n_cached_pages + -(-suffix // b) * (b // ps)
            if slots <= self.ecfg.max_pages_per_seq:
                return b
        return None

    def _admit_cached(self, rid: int, prompt: List[int], max_new: int, cached_pages) -> None:
        """Admission with a shared page-aligned prefix: the cached pages are
        shared by refcount (identical tokens quantize identically) and only
        the suffix runs through prefill_chunk at its global offset. Hybrid:
        each group shares its own row of slots (a sliding group's carries
        scrap slots behind the window), every pool checked first."""
        n = len(prompt)
        m = self._cached_len(cached_pages)
        c = m * self.ecfg.page_size
        chunk = self._suffix_chunk(n, m)
        if self.hybrid:
            short = [k for k, a in self.allocs.items() if a.pages_needed(n) - m > a.free_pages]
            if short:
                raise RuntimeError(f"out of pages in group(s) {sorted(short)} admitting {n} "
                                   f"tokens with a {m}-page prefix")
            for k, a in self.allocs.items():
                a.admit_with_prefix(rid, n, cached_pages[k])
        else:
            self.alloc.admit_with_prefix(rid, n, cached_pages)
        table = self._table(rid)
        logits = None
        for start in range(c, n, chunk):
            logits = self._run_chunk(prompt, start, chunk, table)
        self.metrics.inc("prefix_tokens_reused", c)
        self.metrics.inc("prefix_cache_hits")
        self._complete_prefill(rid, prompt, max_new, logits, n - c)

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
        for a in self._each_alloc():
            a.release(seq.seq_id)
        self.metrics.inc("requests_finished")

    def _check_extend_headroom(self, n_tokens: int, alloc=None) -> None:
        """Raise BEFORE mutating an allocator if extending every active
        sequence by n_tokens could exhaust a pool or a block table. `alloc`:
        the one allocator to check (speculation passes its draft's), else
        every pool of this engine."""
        for alloc in [alloc] if alloc is not None else self._each_alloc():
            if isinstance(alloc, MixedPageAllocator):
                alloc.check_extend_headroom([s.seq_id for s in self.active], n_tokens,
                                            self.ecfg.max_pages_per_seq)
                continue
            needed = 0
            for seq in self.active:
                length = alloc.lengths[seq.seq_id]
                pages_after = -(-(length + n_tokens) // self.ecfg.page_size)
                if pages_after > self.ecfg.max_pages_per_seq:
                    raise RuntimeError(
                        f"seq {seq.seq_id}: extending by {n_tokens} token(s) "
                        f"needs {pages_after} pages > max_pages_per_seq "
                        f"({self.ecfg.max_pages_per_seq})")
                needed += max(0, pages_after - len(alloc.tables[seq.seq_id]))
            if needed > alloc.free_pages:
                raise RuntimeError(
                    f"page pool exhausted: decoding {n_tokens} token(s) for "
                    f"{len(self.active)} sequences needs {needed} new pages, "
                    f"{alloc.free_pages} free. Raise num_pages or lower "
                    f"max_batch/max_new_tokens.")

    def _sample_batch(self, logits) -> torch.Tensor:
        return sample(logits, self._generator, self.sampling)

    def _sample(self, logits) -> int:
        return int(self._sample_batch(logits)[0])

    def _tables_for(self, seq_ids: List[int], pad_to: int, allocs=None, host: bool = False):
        """[pad_to, max_pages_per_seq] block tables, padded lanes on the
        scrap page; a mixed pool's: the ([pad_to, boundary_pages], [pad_to,
        max_pages_per_seq]) pair; hybrid: {group: tables}. `allocs`: a pool
        or {group: pool} to read (this engine's by default; speculation
        passes its draft's). host: numpy arrays instead of device tensors."""
        allocs = self._pools() if allocs is None else allocs
        mp = self.ecfg.max_pages_per_seq
        put = (lambda a: a) if host else self._t

        def pad(t, scrap):
            full = np.full((pad_to, t.shape[1]), scrap, np.int32)
            full[:len(seq_ids)] = t
            return put(full)

        def one(alloc):
            if isinstance(alloc, MixedPageAllocator):
                return tuple(pad(t, alloc.scrap_page) for t in alloc.block_tables(seq_ids, mp))
            return pad(alloc.block_table_array(seq_ids, mp), alloc.scrap_page)
        if isinstance(allocs, dict):
            return {k: one(a) for k, a in allocs.items()}
        return one(allocs)

    # -- one engine step -----------------------------------------------------

    def _prefill_tick(self) -> None:
        """Run ONE chunk of the oldest in-flight interleaved prefill; after
        its final chunk, sample the first token and activate the sequence.
        The chunk schedule is that of blocking chunked admission, so greedy
        token streams are the same."""
        if not self.prefilling:
            return
        t = self.prefilling[0]
        logits = self._run_chunk(t.prompt, t.next_start, t.chunk, t.table)
        self.metrics.inc("prefill_chunks_interleaved")
        t.next_start += t.chunk
        if t.next_start < len(t.prompt):
            return
        self.prefilling.pop(0)
        self._complete_prefill(t.rid, t.prompt, t.max_new, logits, len(t.prompt))
        self._on_prefill_complete(t.rid, t.prompt)

    def _on_prefill_complete(self, rid: int, prompt: List[int]) -> None:
        """Hook: an interleaved chunked prefill's final chunk landed (the
        sequence may have finished at activation: check self.active)."""

    def step(self) -> None:
        while self._try_admit():
            pass
        self._prefill_tick()
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
        groups = self._prefix_groups()
        # Each lane's page in every pool; a mixed pool's pair (the pool that
        # does not own the position gives its scrap page).
        pids = {k: np.zeros((2 if isinstance(a, MixedPageAllocator) else 1, B), np.int32)
                for k, a in groups.items()}
        for i, seq in enumerate(self.active):
            positions[i] = self.alloc.lengths[seq.seq_id]
            for k, a in groups.items():
                # extend gives (page[, page4], slot, ...); the slot follows
                # from the position, the same in every pool.
                got, n = a.extend(seq.seq_id), len(pids[k])
                pids[k][:, i], slots[i] = got[:n], got[n]
            tokens[i] = seq.pending
            lengths[i] = self.alloc.lengths[seq.seq_id]
        dev = {k: tuple(self._t(r) for r in p) if len(p) == 2 else self._t(p[0])
               for k, p in pids.items()}
        page_ids = dev if self.hybrid else dev["shared"]
        tables = self._tables_for([s.seq_id for s in self.active], B)
        with self.metrics.timed("decode_step"):
            logits, self.cache = llama_adapter.decode_step(
                self.acfg, self.params, self.cache, self._t(tokens),
                self._t(positions), page_ids, self._t(slots),
                self._t(lengths), tables, boundary_tokens=self.boundary, group=self.tp_group)
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
            for a in self._each_alloc():
                for _ in range(chunk):
                    a.extend(seq.seq_id)
        with self.metrics.timed("decode_chunk"):
            out, self.cache = llama_adapter.decode_loop(
                self.acfg, self.params, self.cache, self._t(tokens), self._t(lengths0),
                self._tables_for(ids, B), self._generator, n_steps=chunk,
                page_size=self.ecfg.page_size, sampling=self.sampling,
                boundary_tokens=self.boundary, group=self.tp_group)
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

    def _trim_windows(self, margin: int = 0) -> None:
        """Rolling-window page recycling: pages wholly behind an active
        sequence's window (sinks aside) go back to the free list. Hybrid:
        each sliding group's pool trims by its own window, and the full
        group's is never trimmed; otherwise only a model whose every layer
        shares one sliding window trims its single pool. margin: positions
        kept alive behind the window besides."""
        freed = self._trim(self.cfg, self._pools(), self.group_windows, margin)
        if freed:
            self.metrics.inc("pages_trimmed", freed)
            self.metrics.set("free_pages", self.alloc.free_pages)

    def _trim(self, cfg: LlamaConfig, pools, group_windows, margin: int = 0) -> int:
        """_trim_windows over `pools` of model `cfg` (speculation passes its
        draft's): a group dict's sliding pools by their windows
        (group_windows), a single pool by cfg's one recyclable window.
        Returns the pages freed."""
        sinks = cfg.attention_sinks
        if isinstance(pools, dict):
            return sum(a.trim_window(seq.seq_id, group_windows[k] + margin, sinks)
                       for k, a in pools.items() if group_windows[k] for seq in self.active)
        w = cfg.recyclable_window
        if not w:
            return 0
        return sum(pools.trim_window(seq.seq_id, w + margin, sinks) for seq in self.active)

    def run(self) -> Dict[int, List[int]]:
        """Drive until queue and active set drain; returns {req_id: tokens}."""
        while self.queue or self.active or self.prefilling:
            before = len(self.finished)
            self.step()
            if (not self.active and not self.prefilling and self.queue
                    and len(self.finished) == before):
                # Nothing fits an EMPTY cache: the head request needs more
                # pages than the whole pool. Fail IT and keep draining.
                rid, prompt, _ = self.queue.popleft()
                self._fail_request(
                    rid,
                    f"request {rid} (len {len(prompt)}) cannot fit in the "
                    "cache (total page-pool capacity)")
        return dict(self.finished)
