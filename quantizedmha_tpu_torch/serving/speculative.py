"""Speculative decoding: a small draft model proposes, the target model
verifies a block of tokens in one forward (counterpart of
quantizedmha_tpu/serving/speculative.py).

With greedy sampling the emitted stream is the target's greedy stream
(argmax-match verification). With temperature > 0, verification is
rejection sampling (sampling.rejection_sample): a draft x_j is accepted
with probability min(1, p_j(x) / q_j(x)) and replaced from the residual on
rejection, so the stream is distributed as sampling the target with the
same parameters. The gain is that the target reads its weights once per
accepted block instead of once per token.

A round, for every active sequence of the batch:
  1. the draft proposes k tokens with its own on-device decode loop over
     its own paged cache;
  2. the target runs verify_step: one batched forward over [pending,
     d_1..d_k] that appends K/V at all k + 1 positions and returns k + 1
     logits;
  3. the host accepts the longest prefix of drafts that match the target's
     argmax; on a mismatch it emits the accepted drafts and the target's
     correction, on full acceptance the k drafts (no bonus token: see
     _step_speculate);
  4. both caches roll back to the accepted length (allocators only: slots
     are position-indexed and stale K/V is overwritten later).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from quantizedmha_tpu_torch.models.llama import LlamaConfig
from quantizedmha_tpu_torch.serving import llama_adapter
from quantizedmha_tpu_torch.serving.engine import Engine, EngineConfig, build_pools
from quantizedmha_tpu_torch.serving.sampling import rejection_sample


@dataclasses.dataclass
class SpecConfig:
    num_draft_tokens: int = 4  # k
    # Adaptive k: move the draft length between rounds by an EMA of each
    # round's acceptance fraction: high acceptance earns longer drafts
    # (fewer target forwards a token), low acceptance shortens them.
    adaptive: bool = False
    min_k: int = 1
    max_k: int = 8
    ema_decay: float = 0.8
    grow_above: float = 0.8   # EMA acceptance fraction to lengthen drafts
    shrink_below: float = 0.4

    def validate(self) -> "SpecConfig":
        if self.num_draft_tokens < 1:
            raise ValueError(
                f"num_draft_tokens must be >= 1 (0 would emit no tokens and spin "
                f"forever), got {self.num_draft_tokens}")
        if self.adaptive:
            if not 1 <= self.min_k <= self.num_draft_tokens <= self.max_k:
                raise ValueError(
                    f"adaptive k needs min_k <= num_draft_tokens <= max_k, got "
                    f"{self.min_k}/{self.num_draft_tokens}/{self.max_k}")
            if not self.shrink_below < self.grow_above:
                raise ValueError("shrink_below must be < grow_above")
        return self


class SpecDecodeEngine(Engine):
    """Continuous-batching engine with draft-model speculation: greedy
    sampling verifies by argmax match, temperature > 0 by rejection
    sampling."""

    def __init__(self, cfg: LlamaConfig, params: Dict[str, Any], draft_cfg: LlamaConfig,
                 draft_params: Dict[str, Any], ecfg: EngineConfig,
                 scfg: Optional[SpecConfig] = None, device="cuda"):
        scfg = (scfg if scfg is not None else SpecConfig()).validate()
        if ecfg.decode_chunk != 1:
            raise ValueError("decode_chunk and speculation are exclusive")
        if ecfg.mixed_kv is not None:
            raise ValueError(
                "mixed_kv does not compose with speculation yet (the verify step would "
                "need the mixed q_len>1 kernel plumbed through verify_step, and rollback a "
                "boundary-aware form)")
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        super().__init__(cfg, params, ecfg, device=device)
        self.scfg = scfg
        self._k = scfg.num_draft_tokens
        self._accept_ema: Optional[float] = None
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        # The draft's own cache and allocators over the same page layout;
        # under hybrid_kv the draft's own window pattern decides whether its
        # pools are grouped.
        self.draft_acfg = self._local(draft_cfg)  # what the adapter runs
        (self.draft_cache, self.draft_allocs, self.draft_alloc,
         self.draft_hybrid) = build_pools(self.draft_acfg, ecfg, self.device)
        self.draft_group_windows = {llama_adapter.group_key(w): w
                                    for w in set(draft_cfg.layer_windows)}

    # -- admission: prefill both models ---------------------------------------
    #
    # _fits gates on both models' pools; _dispatch_admit runs the target's
    # admission (bucketed, chunked or prefix-cached), then the draft's for
    # the request it dispatched. The draft shares no prefix pages (its cache
    # is its own): under prefix_cache it prefills the whole prompt.

    def _draft_pools(self):
        """The draft's pools, as Engine's pool helpers take them."""
        return self.draft_allocs if self.draft_hybrid else self.draft_alloc

    def _fits(self, prompt: List[int]) -> bool:
        return super()._fits(prompt) and all(a.can_admit(len(prompt))
                                             for a in self._each_alloc(self._draft_pools()))

    def _dispatch_admit(self, rid: int, prompt: List[int], max_new: int) -> None:
        super()._dispatch_admit(rid, prompt, max_new)
        if any(t.rid == rid for t in self.prefilling):
            # Interleaved chunked prefill: reserve the draft's pages now (a
            # later admission cannot take them) and prefill the draft when
            # the target's last chunk lands (_on_prefill_complete).
            self._draft_reserve_chunked(rid, prompt)
            return
        if all(seq.seq_id != rid for seq in self.active):
            # Finished at activation (EOS on the prefill token, or max_new
            # 1): nothing would release draft pages admitted now.
            return
        n = len(prompt)
        if n > max(self.ecfg.prefill_buckets):
            self._draft_reserve_chunked(rid, prompt)
            self._draft_prefill_chunks(rid, prompt)
            self._trim_draft()
            return
        pages = self._admit_all(rid, n, self._draft_pools())
        toks = np.zeros((1, self._bucket(n)), np.int32)
        toks[0, :n] = prompt
        _, k_all, v_all = llama_adapter.prefill_at(self.draft_acfg, self.draft_params,
                                                   self._t(toks), n - 1, group=self.tp_group)
        self._write_prompt(self.draft_acfg, self.draft_cache, pages, k_all, v_all, n)
        self._trim_draft()

    def _on_prefill_complete(self, rid: int, prompt: List[int]) -> None:
        """The target's last interleaved chunk landed: prefill the draft
        over the pages reserved at dispatch (the draft is the small model,
        so decode waits for one chunk and a draft prefill), or release them
        when the sequence finished at activation."""
        if all(s.seq_id != rid for s in self.active):
            for a in self._each_alloc(self._draft_pools()):
                a.release(rid)
            return
        self._draft_prefill_chunks(rid, prompt)
        self._trim_draft()

    def _draft_reserve_chunked(self, rid: int, prompt: List[int]) -> None:
        """Admit the draft's pages for a chunked prefill (table fixed, K/V
        written by _draft_prefill_chunks)."""
        chunk = max(self.ecfg.prefill_buckets)
        if -(-len(prompt) // chunk) * chunk // self.ecfg.page_size > self.ecfg.max_pages_per_seq:
            raise ValueError(f"request {rid}: draft chunked prefill exceeds "
                             f"max_pages_per_seq ({self.ecfg.max_pages_per_seq})")
        self._admit_all(rid, len(prompt), self._draft_pools())

    def _draft_prefill_chunks(self, rid: int, prompt: List[int]) -> None:
        """The prompt into the draft's cache chunk by chunk (the logits go
        unused: only the cached K/V matter to later proposals)."""
        chunk = max(self.ecfg.prefill_buckets)
        table = self._table(rid, self._draft_pools())
        for start in range(0, len(prompt), chunk):
            part = prompt[start:start + chunk]
            toks = np.zeros((1, chunk), np.int32)
            toks[0, :len(part)] = part
            _, self.draft_cache = llama_adapter.prefill_chunk(
                self.draft_acfg, self.draft_params, self.draft_cache, self._t(toks), start,
                table, len(part) - 1, page_size=self.ecfg.page_size, group=self.tp_group)

    # -- one speculation round --------------------------------------------------

    def step(self) -> None:
        while self._try_admit():
            pass
        self._prefill_tick()
        if not self.active:
            return
        self._step_speculate(self._k)
        if self.scfg.adaptive:
            self._adapt_k()

    def _adapt_k(self) -> None:
        """Move k by one when the acceptance EMA leaves [shrink_below,
        grow_above]; the EMA restarts on a change, so that a new k is judged
        on its own rounds."""
        if self._accept_ema is None:
            return
        k = self._k
        if self._accept_ema > self.scfg.grow_above and k < self.scfg.max_k:
            self._k = k + 1
        elif self._accept_ema < self.scfg.shrink_below and k > self.scfg.min_k:
            self._k = k - 1
        if self._k != k:
            self.metrics.inc("spec_k_changes")
            self.metrics.set("spec_k", self._k)
            self._accept_ema = None

    @staticmethod
    def _reserve(allocs, seq_ids: List[int], count: int) -> None:
        for alloc in allocs:
            for sid in seq_ids:
                for _ in range(count):
                    alloc.extend(sid)

    def _trim_draft(self) -> None:
        """Engine._trim_windows for the draft's pools (not counted in
        pages_trimmed). Only after the rollbacks and prefills commit."""
        self._trim(self.draft_cfg, self._draft_pools(), self.draft_group_windows)

    def _step_speculate(self, k: int) -> None:
        B = self.ecfg.max_batch
        S = k + 1
        seq_ids = [s.seq_id for s in self.active]
        ps = self.ecfg.page_size
        tokens0 = np.zeros(B, np.int32)
        lengths0 = np.ones(B, np.int32)
        for i, seq in enumerate(self.active):
            tokens0[i] = seq.pending
            # Both models' allocators roll back to the same committed length
            # every round and were admitted with the same n: one lengths
            # array drives both.
            lengths0[i] = self.alloc.lengths[seq.seq_id]
        # Headroom in every pool and table BEFORE any allocator or cache
        # changes: a failure half-way through the reservations would leave
        # host lengths out of step with the caches.
        draft_pools = self._each_alloc(self._draft_pools())
        for a in draft_pools:
            self._check_extend_headroom(k, alloc=a)
        self._check_extend_headroom(S)

        # 1. The draft proposes k tokens (the on-device loop over its cache);
        # rejection sampling also needs its distribution at each of them.
        greedy = self.sampling.greedy
        self._reserve(draft_pools, seq_ids, k)
        with self.metrics.timed("draft"):
            drafted = llama_adapter.decode_loop(
                self.draft_acfg, self.draft_params, self.draft_cache, self._t(tokens0),
                self._t(lengths0), self._tables_for(seq_ids, B, self._draft_pools()),
                self._generator, n_steps=k, page_size=ps, sampling=self.sampling,
                return_logits=not greedy, group=self.tp_group)
            drafts = drafted[0].cpu().numpy()  # [k, B]

        # 2. The target verifies the pending token and the drafts in one
        # forward. The tables stay on the host until the upload below (the
        # schedules index them there).
        self._reserve(self._each_alloc(), seq_ids, S)
        t_tables = self._tables_for(seq_ids, B, host=True)
        fed = np.zeros((B, S), np.int32)
        fed[:, 0] = tokens0
        fed[:, 1:] = drafts.T
        pos = lengths0[:, None] + np.arange(S, dtype=np.int32)[None, :]

        def sched_from(tbl):
            return self._t(np.take_along_axis(tbl, pos // ps, axis=1).astype(np.int32))
        if self.hybrid:
            page_sched = {g: sched_from(t) for g, t in t_tables.items()}
            tables = {g: self._t(t) for g, t in t_tables.items()}
        else:
            page_sched, tables = sched_from(t_tables), self._t(t_tables)
        with self.metrics.timed("verify"):
            logits, self.cache = llama_adapter.verify_step(
                self.acfg, self.params, self.cache, self._t(fed), self._t(lengths0), page_sched,
                self._t((pos % ps).astype(np.int32)), tables, page_size=ps,
                group=self.tp_group)
            if greedy:
                target = torch.argmax(logits, dim=-1).cpu().numpy()  # [B, S]
            else:
                # logits[:, j] is the target's distribution for the token at
                # position L + j, draft position j's for j < k.
                n_acc, repl = rejection_sample(drafted[2].transpose(0, 1), logits[:, :k],
                                               self._t(np.ascontiguousarray(drafts.T)),
                                               self._generator, self.sampling)
                n_acc, repl = n_acc.cpu().numpy(), repl.cpu().numpy()

        # 3. Acceptance on the host, 4. rollbacks. The draft loop cached K/V
        # at positions L..L+k-1 (the pending token and the first k - 1
        # drafts), never d_k's: on full acceptance no bonus token is
        # emitted, d_k becomes the pending token and both caches roll back
        # to L + k, aligned every round (d_k's K/V is computed as the next
        # round's pending token, one token of recompute instead of a draft
        # catch-up pass).
        self.metrics.inc("spec_rounds")
        still_active = []
        for i, seq in enumerate(self.active):
            if greedy:
                accepted = 0
                while accepted < k and drafts[accepted, i] == target[i, accepted]:
                    accepted += 1
                correction = int(target[i, accepted]) if accepted < k else None
            else:
                accepted = int(n_acc[i])
                correction = int(repl[i]) if accepted < k else None
            if accepted < k:  # the accepted drafts and the correction
                emitted = [int(t) for t in drafts[:accepted, i]] + [correction]
                new_len = int(lengths0[i]) + accepted + 1
            else:  # all k accepted: d_k becomes the pending token
                emitted = [int(t) for t in drafts[:, i]]
                new_len = int(lengths0[i]) + k
            self.metrics.inc("draft_tokens_proposed", k)
            self.metrics.inc("draft_tokens_accepted", accepted)
            frac = accepted / k
            self._accept_ema = (frac if self._accept_ema is None else
                                self.scfg.ema_decay * self._accept_ema
                                + (1 - self.scfg.ema_decay) * frac)
            for a in self._each_alloc() + draft_pools:
                a.rollback(seq.seq_id, new_len)
            finished = False
            for tok in emitted:
                seq.out.append(tok)
                seq.pending = tok
                self.metrics.inc("tokens_generated")
                eos = self.ecfg.eos_id is not None and tok == self.ecfg.eos_id
                if seq.done_by_len or eos:
                    finished = True
                    break
            if finished:
                self._finish(seq)
                for a in draft_pools:
                    a.release(seq.seq_id)
            else:
                still_active.append(seq)
        self.active = still_active
        # Window recycling of both caches, after the rollbacks commit.
        self._trim_windows()
        self._trim_draft()
        self.metrics.set("free_pages", self.alloc.free_pages)

    @property
    def acceptance_rate(self) -> float:
        prop = self.metrics.counter("draft_tokens_proposed")
        return self.metrics.counter("draft_tokens_accepted") / prop if prop else 0.0
