"""Paged INT8 KV cache (counterpart of quantizedmha_tpu/serving/kv_cache.py).

Physical pages of `page_size` tokens hold int8 payloads with one symmetric
max-abs scale per (kv_head, page); sequences map logical to physical pages
through block tables kept by the host-side PageAllocator
(MixedPageAllocator keeps the two pools of the mixed INT8 / INT4 cache,
serving/mixed_kv.py). Device state is
updated IN PLACE (index_put_): the JAX package had to thread the cache
through functional updates and fight XLA's copies; here a write touches
only the slots it writes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from quantizedmha_tpu_torch.device import resolve_device
from quantizedmha_tpu_torch.ops.quantize import true_div


@dataclasses.dataclass
class PagedKVCacheState:
    """Device tensors of one layer's cache, or of all layers with a leading
    num_layers dim (`layer(i)` returns views of one layer)."""

    k_pages: torch.Tensor  # [(L,) num_kv_heads, num_pages, page_size, head_dim] int8
    v_pages: torch.Tensor
    k_scales: torch.Tensor  # [(L,) num_kv_heads, num_pages] f32
    v_scales: torch.Tensor

    @staticmethod
    def create(num_kv_heads: int, num_pages: int, page_size: int, head_dim: int,
               num_layers: Optional[int] = None, device="cuda") -> "PagedKVCacheState":
        dev = resolve_device(device)
        lead = (num_layers,) if num_layers is not None else ()
        pages = lead + (num_kv_heads, num_pages, page_size, head_dim)
        scales = lead + (num_kv_heads, num_pages)
        return PagedKVCacheState(
            k_pages=torch.zeros(pages, dtype=torch.int8, device=dev),
            v_pages=torch.zeros(pages, dtype=torch.int8, device=dev),
            k_scales=torch.ones(scales, dtype=torch.float32, device=dev),
            v_scales=torch.ones(scales, dtype=torch.float32, device=dev),
        )

    def layer(self, i: int) -> "PagedKVCacheState":
        return PagedKVCacheState(self.k_pages[i], self.v_pages[i],
                                 self.k_scales[i], self.v_scales[i])


def quantize_page(x: torch.Tensor, scale_clamp: float = 1e-8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., num_kv_heads, page_size, head_dim] -> (int8 page, per-head
    scale [..., num_kv_heads])."""
    xf = x.float()
    scale = true_div(torch.clamp(xf.abs().amax(dim=(-2, -1)), min=scale_clamp), 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None, None]), -127, 127)
    return q.to(torch.int8), scale


def write_pages(
    state: PagedKVCacheState,
    k_new: torch.Tensor,  # [num_kv_heads, n_tokens, head_dim]
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [n_pages_written] physical page ids
    page_size: int,
) -> PagedKVCacheState:
    """Quantize `n_tokens` (a multiple of page_size) of fresh K/V page by
    page and write them into the given physical pages of one layer."""
    h, n_tokens, d = k_new.shape
    n_pages = n_tokens // page_size
    if n_pages * page_size != n_tokens:
        raise ValueError(f"{n_tokens} tokens is not a whole number of pages")
    ids = page_ids.long()
    for new, pages, scales in ((k_new, state.k_pages, state.k_scales),
                               (v_new, state.v_pages, state.v_scales)):
        q, s = quantize_page(new.reshape(h, n_pages, page_size, d).transpose(0, 1))
        pages[:, ids] = q.transpose(0, 1)
        scales[:, ids] = s.transpose(0, 1)
    return state


def append_tokens_batched(
    state: PagedKVCacheState,
    k_tok: torch.Tensor,  # [B, num_kv_heads, head_dim]
    v_tok: torch.Tensor,
    page_ids: torch.Tensor,  # [B] physical page holding each slot
    slots: torch.Tensor,  # [B] offset within each page
) -> PagedKVCacheState:
    """Append one decoded token per sequence into its page slot (one layer).

    Quantization policy (kv_cache.py:102-118 of the JAX package): a page's
    scale is fitted by its FIRST token (slot == 0); later tokens are
    quantized with the page's existing scale and clamped into its range
    (rewriting the page to grow the scale would cost a page of traffic per
    token)."""
    ids, slots = page_ids.long(), slots.long()
    first = (slots == 0)[None, :]
    for tok, pages, scales in ((k_tok, state.k_pages, state.k_scales),
                               (v_tok, state.v_pages, state.v_scales)):
        tf = tok.float().transpose(0, 1)  # [Hkv, B, hd]
        fit = true_div(torch.clamp(tf.abs().amax(dim=-1), min=1e-8), 127.0)  # [Hkv, B]
        sc = torch.where(first, fit, scales[:, ids])
        q = torch.clamp(torch.round(tf / sc[..., None]), -127, 127).to(torch.int8)
        pages[:, ids, slots] = q
        scales[:, ids] = sc
    return state


def append_token(
    state: PagedKVCacheState,
    k_tok: torch.Tensor,  # [num_kv_heads, head_dim]
    v_tok: torch.Tensor,
    page_id,  # the physical page holding the slot (int or 0-d tensor)
    slot,  # offset within the page
) -> PagedKVCacheState:
    """Single-token form of append_tokens_batched (B = 1), in place."""
    dev = state.k_pages.device
    return append_tokens_batched(
        state, k_tok[None], v_tok[None],
        torch.as_tensor(page_id, dtype=torch.int32, device=dev).reshape(1),
        torch.as_tensor(slot, dtype=torch.int32, device=dev).reshape(1))


class PageAllocator:
    """Host-side physical page free-list + per-sequence block tables, with
    a permanently reserved scrap page and per-page refcounts."""

    def __init__(self, num_pages: int, page_size: int,
                 scrap_page: Optional[int] = None):
        """scrap_page: a page never allocated nor freed — the harmless
        target of padded batch lanes and of window-trimmed table slots,
        which block_table_array maps to it."""
        self.num_pages = num_pages
        self.page_size = page_size
        self.scrap_page = scrap_page
        self._free: List[int] = [
            p for p in range(num_pages - 1, -1, -1) if p != scrap_page
        ]
        self.tables: Dict[int, List[Optional[int]]] = {}
        self.lengths: Dict[int, int] = {}
        # Pages referenced by more than one sequence (prefix sharing) carry
        # a refcount; a page returns to the free list when its LAST
        # reference drops, and on_free(page), if set, fires then (the
        # engine drops the page from its prefix-hash map before the id is
        # reused).
        self._ref: Dict[int, int] = {}
        self.on_free: Optional[Callable[[int], None]] = None

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def _release_page(self, page: int) -> None:
        r = self._ref.get(page, 1) - 1
        if r <= 0:
            self._ref.pop(page, None)
            if self.on_free is not None:
                self.on_free(page)
            self._free.append(page)
        else:
            self._ref[page] = r

    def share(self, pages: List[Optional[int]]) -> None:
        """Add a reference to already-allocated pages (None entries, scrap
        slots, are skipped)."""
        for p in pages:
            if p is not None:
                self._ref[p] = self._ref.get(p, 1) + 1

    def admit_with_prefix(self, seq_id: int, n_tokens: int,
                          shared_pages: List[Optional[int]]) -> List[int]:
        """Admit with the first len(shared_pages) table slots reused from
        another sequence (their refcounts go up here); only the remainder is
        freshly allocated. None entries are window-trimmed slots: they keep
        the table position-indexed, reference no page and map to the scrap
        page. Returns the fresh pages."""
        need = self.pages_needed(n_tokens) - len(shared_pages)
        if need < 0:
            raise ValueError("shared prefix longer than the prompt")
        if need > self.free_pages:
            raise RuntimeError(f"out of pages: need {need}, have {self.free_pages}")
        self.share(shared_pages)
        fresh = [self._free.pop() for _ in range(need)]
        self.tables[seq_id] = list(shared_pages) + fresh
        self.lengths[seq_id] = n_tokens
        return fresh

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.free_pages >= self.pages_needed(n_tokens)

    def admit(self, seq_id: int, n_tokens: int) -> List[int]:
        need = self.pages_needed(n_tokens)
        if need > self.free_pages:
            raise RuntimeError(f"out of pages: need {need}, have {self.free_pages}")
        pages = [self._free.pop() for _ in range(need)]
        self.tables[seq_id] = pages
        self.lengths[seq_id] = n_tokens
        return pages

    def extend(self, seq_id: int) -> Tuple[int, int, Optional[int]]:
        """Account one more token; returns (page_id, slot, newly_allocated)."""
        n = self.lengths[seq_id]
        table = self.tables[seq_id]
        slot = n % self.page_size
        new_page = None
        if slot == 0 and n // self.page_size == len(table):
            if not self._free:
                raise RuntimeError("out of pages during decode")
            new_page = self._free.pop()
            table.append(new_page)
        self.lengths[seq_id] = n + 1
        return table[n // self.page_size], slot, new_page

    def rollback(self, seq_id: int, new_len: int) -> None:
        """Rewind a sequence to `new_len` tokens and free its pages past the
        new end (a sequence keeps at least one page). Slots between new_len
        and the old length keep stale K/V, overwritten before they are read:
        slots are position-indexed (speculative decoding drops rejected
        drafts so). Raises RuntimeError on reaching a window-trimmed slot:
        trims must follow the speculative commits."""
        old = self.lengths[seq_id]
        if not 0 <= new_len <= old:
            raise ValueError(f"rollback to {new_len} outside [0, {old}]")
        table = self.tables[seq_id]
        keep = self.pages_needed(new_len)
        while len(table) > max(keep, 1):
            page = table.pop()
            if page is None:  # not an assert: the check must survive python -O
                raise RuntimeError("rollback reached a window-trimmed page: trim_window "
                                   "must only run after speculative commits")
            self._release_page(page)
        self.lengths[seq_id] = new_len

    def trim_window(self, seq_id: int, window: int, sinks: int = 0) -> int:
        """Free pages wholly behind the sliding window that hold no sink
        position; their table slots become None (the scrap page in block
        tables). Returns the number of pages freed."""
        n = self.lengths[seq_id]
        first_block = max(n - window, 0) // self.page_size
        sink_blocks = -(-sinks // self.page_size) if sinks else 0
        table = self.tables[seq_id]
        freed = 0
        for i in range(sink_blocks, min(first_block, len(table))):
            if table[i] is not None:
                self._release_page(table[i])
                table[i] = None
                freed += 1
        return freed

    def release(self, seq_id: int) -> None:
        for p in reversed(self.tables.pop(seq_id)):
            if p is not None:
                self._release_page(p)
        self.lengths.pop(seq_id)

    def block_table_array(self, seq_ids: List[int], max_pages: int) -> np.ndarray:
        scrap = self.scrap_page if self.scrap_page is not None else 0
        out = np.full((len(seq_ids), max_pages), scrap, np.int32)
        for row, sid in enumerate(seq_ids):
            t = self.tables[sid]
            out[row, : len(t)] = [scrap if p is None else p for p in t]
        return out

    def lengths_array(self, seq_ids: List[int]) -> np.ndarray:
        return np.asarray([self.lengths[s] for s in seq_ids], np.int32)


class MixedPageAllocator:
    """Host bookkeeping for the mixed (INT8-sink / INT4-bulk) cache: one
    PageAllocator per pool with a page-aligned position boundary. A
    sequence's logical page i lives in the int8 pool for i < boundary_pages
    and in the int4 pool at slot i - boundary_pages past it; both pools
    reserve page 0 as scrap. Per-sequence capacity is boundary_tokens +
    max_pages_per_seq * page_size (the int4 table is the growth frame; the
    int8 table is exactly boundary_pages wide)."""

    def __init__(self, pages8: int, pages4: int, page_size: int, boundary_tokens: int):
        if boundary_tokens % page_size:
            raise ValueError(f"boundary_tokens {boundary_tokens} not a multiple of "
                             f"page_size {page_size}")
        if boundary_tokens <= 0:
            raise ValueError("boundary_tokens must be positive (pure-int4 serving is "
                             "paged_decode_attention_int4; the mixed mode exists for the "
                             "int8 sink region)")
        self.page_size = page_size
        self.boundary = boundary_tokens
        self.bp = boundary_tokens // page_size
        self.a8 = PageAllocator(pages8, page_size, scrap_page=0)
        self.a4 = PageAllocator(pages4, page_size, scrap_page=0)
        self.lengths: Dict[int, int] = {}
        self.scrap_page = 0

    @property
    def free_pages(self) -> int:
        return self.a4.free_pages  # the growth pool

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def _split(self, n_tokens: int) -> Tuple[int, int]:
        return min(n_tokens, self.boundary), max(n_tokens - self.boundary, 0)

    def can_admit(self, n_tokens: int) -> bool:
        n8, n4 = self._split(n_tokens)
        return self.a8.can_admit(n8) and self.a4.can_admit(n4)

    def admit(self, seq_id: int, n_tokens: int) -> Tuple[List[int], List[int]]:
        """Returns the fresh (int8 pages, int4 pages)."""
        n8, n4 = self._split(n_tokens)
        if not self.can_admit(n_tokens):
            raise RuntimeError(f"out of pages admitting {n_tokens} tokens (int8 free "
                               f"{self.a8.free_pages}, int4 free {self.a4.free_pages})")
        p8 = self.a8.admit(seq_id, n8)
        p4 = self.a4.admit(seq_id, n4)  # n4 == 0: an empty table, kept
        self.lengths[seq_id] = n_tokens
        return p8, p4

    def extend(self, seq_id: int) -> Tuple[int, int, int, bool]:
        """Account one more token. Returns (pid8, pid4, slot, below): the
        owning pool's physical page and the OTHER pool's scrap page, what
        the batched mixed append consumes."""
        n = self.lengths[seq_id]
        below = n < self.boundary
        if below:
            pid, slot, _ = self.a8.extend(seq_id)
            out = (pid, self.a4.scrap_page, slot, True)
        else:
            pid, slot, _ = self.a4.extend(seq_id)
            out = (self.a8.scrap_page, pid, slot, False)
        self.lengths[seq_id] = n + 1
        return out

    def rollback(self, seq_id: int, new_len: int) -> None:
        """PageAllocator.rollback of each pool, at new_len's share of it."""
        n8, n4 = self._split(new_len)
        self.a8.rollback(seq_id, n8)
        self.a4.rollback(seq_id, n4)
        self.lengths[seq_id] = new_len

    def trim_window(self, seq_id: int, window: int, sinks: int = 0) -> int:
        """Windowed mixed serving has sinks == boundary (the int8 pool is
        the always-visible sink region; the engine checks), so only the int4
        bulk trims, in its own frame: its local length n - boundary less the
        window lands exactly at the absolute n - window cut."""
        return self.a4.trim_window(seq_id, window, 0)

    def release(self, seq_id: int) -> None:
        self.a8.release(seq_id)
        self.a4.release(seq_id)
        self.lengths.pop(seq_id)

    def block_tables(self, seq_ids: List[int], max_pages4: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """([B, boundary_pages] int8 table, [B, max_pages4] int4 table)."""
        return (self.a8.block_table_array(seq_ids, self.bp),
                self.a4.block_table_array(seq_ids, max_pages4))

    def lengths_array(self, seq_ids: List[int]) -> np.ndarray:
        return np.asarray([self.lengths[s] for s in seq_ids], np.int32)

    def check_extend_headroom(self, seq_ids: List[int], n_tokens: int,
                              max_pages_per_seq: int) -> None:
        """Per-pool headroom BEFORE mutating: the int4 table bound and both
        free lists."""
        ps = self.page_size
        need8 = need4 = 0
        for sid in seq_ids:
            n8, n4 = self._split(self.lengths[sid] + n_tokens)
            p4_after = -(-n4 // ps)
            if p4_after > max_pages_per_seq:
                raise RuntimeError(
                    f"seq {sid}: extending by {n_tokens} token(s) needs {p4_after} int4 "
                    f"pages > max_pages_per_seq ({max_pages_per_seq})")
            need8 += max(0, -(-n8 // ps) - len(self.a8.tables[sid]))
            need4 += max(0, p4_after - len(self.a4.tables[sid]))
        if need8 > self.a8.free_pages or need4 > self.a4.free_pages:
            raise RuntimeError(
                f"page pool exhausted: +{n_tokens} token(s) for {len(seq_ids)} sequences "
                f"needs int8 {need8} (free {self.a8.free_pages}) / int4 {need4} (free "
                f"{self.a4.free_pages}). Raise int8_pages/int4_pages or lower "
                "max_batch/max_new_tokens.")
