"""Continuous-batching decode server over the paged KV cache —
counterpart of `shallowspeed_tpu/serving/engine.py`.

The scheduler is the reference's, step for step:

- **Fixed-capacity decode slots.** One decode tick advances every
  running request by one token. The tick always runs `max_slots` rows
  (empty slots write to the scratch block and their results are
  ignored) and its block-table width is bucketed geometrically, so the
  tick's shapes stay few as requests join and leave.
- **Chunked prefill.** A prompt prefills `prefill_chunk` tokens per
  engine step, interleaved with decode ticks.
- **Admission and preemption.** A request is admitted when a slot and
  its prompt's blocks are free; a decode append that finds the pool
  empty evicts the newest-admitted running request, which re-queues at
  the front and later re-prefills prompt + generated tokens, continuing
  its stream. Evicting the newest keeps the oldest progressing, and
  `submit` rejects requests that could never fit alone, so the
  allocator cannot deadlock.
- **Per-request records.** Each completion appends a record (ttft_ms,
  tpot_ms, e2e_ms, wait, preemptions, tokens) to `request_records` and,
  with a `metrics` sink, a `"request"` line; every `log_every` ticks a
  `"generate"` line carries tick throughput and the live-blocks byte
  model.

The tick is split in two: `decode_logits` (embedding, the blocks with
their in-place pool writes and paged attention, the head) and
`sample_rows`. With `attn_impl="flash"` (the default here) the tick's
attention is `ops.flash_attention.paged_flash_decode`, the CUDA kernel
on a card; `"gather"` reads through `gather_table` + `masked_attention`
instead, the path the kernel is held against.

Quantized decode: `kv_quant="int8"` keeps the pools in int8 with f32
scale planes (the tick's attention, `paged_flash_decode`, then launches
K4's int8 kernel); `weight_quant="int8"|"fp8"` quantizes the
dense weights once at construction (`T.quantize_weights`, before the
compute-dtype cast), and every dense of the tick and the prefill runs
`ops.matmul.dequant_matmul`.

Sampling (`models.generate.sample_rows`): temperature 0 is the argmax,
exactly as in the reference. A sampled token i of a request with seed s
draws from a `torch.Generator` seeded from (s, i), so an evicted and
re-admitted request continues the same stream, and a solo request draws
what the contiguous `generate()` draws. This is NOT the reference's
threefry `fold_in(PRNGKey(s), i)` stream: sampled tokens differ from
the JAX package's, greedy tokens do not.

Speculative decoding (`spec_k > 0`): the reference's n-gram
prompt-lookup proposer drafts up to `spec_k` tokens per decoding request
into the tick's free rows, at consecutive positions of the request's own
block table. `decode_logits` writes every row's K/V before any row
attends, so draft row j sees rows i < j of the same tick: one tick
verifies them all. A draft is accepted while it equals the token its
predecessor row sampled, and row j samples at token index
`len(generated) + j` through the (seed, index) generator, so spec-on
streams equal spec-off streams at every temperature.

Prefix caching (`prefix_cache=True`): `_admit` maps the longest indexed
block-aligned prefix of a request (`cache.PrefixIndex`) into its table
and starts its prefill after it; a fully aligned match re-prefills its
last token into a fresh copy of the tail block (copy-on-write in
`prefill_chunk`, before any write), so the shared block stays
unchanged. A finished request indexes its sealed prompt blocks; at
refcount zero they park on the allocator's cold list until pool
pressure reclaims them. At drain `n_live == 0` and
`n_free + n_cold == n_usable`.

Fault drills: every `step()` consults a fault plan (`chaos_plan=`, else
the process's `chaos.active()`), tick-indexed, under the profiler's
"data-load" phase tag: a stall sleeps, kill / nan / inf act as on a
training step (poisoning `self.params`). Lifecycle tracing, the
scheduler's other phase tags and the memory-owner hooks are absent
(ROADMAP.md).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from shallowspeed_tpu_torch import chaos, resolve_device
from shallowspeed_tpu_torch.models import generate as G
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.kv_cache import (masked_attention,
                                                    position_mask)
from shallowspeed_tpu_torch.ops.flash_attention import paged_flash_decode
from shallowspeed_tpu_torch.serving.cache import (SCRATCH_BLOCK,
                                                  BlockAllocator,
                                                  OutOfBlocks, PrefixIndex,
                                                  blocks_for, gather_table,
                                                  init_block_pool,
                                                  paged_read_bytes_per_tick,
                                                  param_read_bytes,
                                                  write_rows)
from shallowspeed_tpu_torch.telemetry import profiler
from shallowspeed_tpu_torch.weights import leaves


class EngineDraining(RuntimeError):
    """`submit()` after `drain()` began: the engine finishes what it
    accepted and admits nothing new."""

    def __init__(self, pending: int):
        super().__init__(
            f"engine is draining ({pending} accepted request(s) still "
            f"in flight); submit to another replica")
        self.pending = int(pending)


def table_width(n_blocks: int, base: int) -> int:
    """Geometric block-table width bucket (base, 2*base, 4*base, ...)."""
    w = max(1, int(base))
    n = max(1, int(n_blocks))
    while w < n:
        w *= 2
    return w


def _rope_rows(x, pos, theta: float):
    """`T.rope_rotate` with a per-row position: x (S, 1, H, D), pos (S,)."""
    return T.rope_rotate(x.transpose(0, 1), pos, theta).transpose(0, 1)


@torch.no_grad()
def decode_logits(params, pools, tok, pos, bt, *, cfg: T.TransformerConfig,
                  attn: str = "flash"):
    """The model half of one decode tick over the whole slot batch.

    tok/pos: (S,) per-slot last token and write position; bt: (S, W)
    int32 block tables. Each slot writes its token's K/V at
    (bt[pos // bs], pos % bs) — into the pools, in place; this stands in
    for the reference's donated pools — and then attends over its table
    up to `pos`. Inactive slots carry pos=0 / bt=scratch. Every row
    writes before any row reads, so draft rows (consecutive positions of
    one table) see the rows before them. Returns the next-token logits
    (S, vocab) in f32."""
    params = T.cast_params(params, cfg.compute_dtype)
    s_rows = tok.shape[0]
    bs = pools[0]["k"].shape[2]
    w = bt.shape[1]
    pos_l = pos.long()
    x = params["tok_emb"][tok.long()][:, None, :]              # (S, 1, d)
    if not cfg.rope:
        x = x + params["pos_emb"][pos_l][:, None, :]
    if cfg.compute_dtype is not None:
        x = x.to(cfg.compute_dtype)
    rows = torch.arange(s_rows, device=tok.device)
    blk = bt.long()[rows, pos_l // bs]
    off = pos_l % bs
    if attn != "flash":
        valid = position_mask(w * bs, pos_l[:, None], cfg.attn_window,
                              device=tok.device)[:, None, None, None, :]
    for p, pool in zip(params["blocks"], pools):
        h = T._norm(p["ln1"], x, cfg)
        q, k, v = T._qkv(p, h, cfg)
        if cfg.rope:
            q = _rope_rows(q, pos_l, cfg.rope_theta)
            k = _rope_rows(k, pos_l, cfg.rope_theta)
        write_rows(pool, k[:, 0], v[:, 0], blk, off)
        if attn == "flash":
            a = paged_flash_decode(q[:, 0].contiguous(), pool, bt, pos,
                                   window=cfg.attn_window)
        else:
            a = masked_attention(q, gather_table(pool, bt), valid)
        x = x + T._dense(p["proj"], a.reshape(s_rows, 1, cfg.d_model))
        x = T._ffn(p, x, cfg, T._norm(p["ln2"], x, cfg))[0]
    x = T._norm(params["ln_f"], x, cfg)
    return T.head_logits(params, x[:, 0], cfg).float()


@torch.no_grad()
def prefill_chunk(params, pools, tokens, pos0: int, bt, *,
                  cfg: T.TransformerConfig, cow=None, chunk: int = 0):
    """One chunk of a request's prefill: tokens (C,) at positions
    pos0..pos0+C-1 write their K/V through the block table bt (1, W)
    (in place) and attend causally over the table, earlier chunks
    included. Returns the f32 logits (vocab,) at the chunk's last token.

    `cow` = (src, dst) is a prefix hit's copy-on-write pair: before any
    write, every leaf of every layer's pool (scale planes included)
    copies block src into block dst, so the chunk writes its own copy
    and the shared block stays bit-unchanged.

    The reference pads every chunk to the engine's fixed `chunk` length
    (token 0 at the following positions) and steers the padding's K/V
    writes to the scratch block. For a dense FFN the true rows do not
    see the padding, so eager torch runs the true tokens only. An MoE
    FFN routes the chunk as one group, whose expert capacity and slot
    order count the padding rows; so when a block has `moe` the chunk
    is padded to `chunk` as the reference pads it. The reference also
    copies scratch onto itself when there is no pair; here nothing is
    copied then."""
    if cow is not None:
        src, dst = cow
        for pool in pools:
            for leaf in pool.values():
                leaf[dst] = leaf[src]
    params = T.cast_params(params, cfg.compute_dtype)
    n_tok = tokens.shape[0]
    if chunk > n_tok and any("moe" in p for p in params["blocks"]):
        tokens = torch.cat([tokens, tokens.new_zeros(chunk - n_tok)])
    c = tokens.shape[0]
    bs = pools[0]["k"].shape[2]
    w = bt.shape[1]
    pos = pos0 + torch.arange(c, device=tokens.device)
    x = G._embed(params, tokens[None].long(), pos0, cfg)        # (1, C, d)
    blk = bt.long()[0, torch.clamp(pos // bs, max=w - 1)]
    off = pos % bs
    if c > n_tok:        # the padding writes to scratch, offset 0
        keep = torch.arange(c, device=tokens.device) < n_tok
        blk = torch.where(keep, blk, SCRATCH_BLOCK)
        off = torch.where(keep, off, 0)
    valid = position_mask(w * bs, pos[:, None], cfg.attn_window,
                          device=tokens.device)[None, None, None]
    for p, pool in zip(params["blocks"], pools):
        h = T._norm(p["ln1"], x, cfg)
        q, k, v = T._qkv(p, h, cfg)
        if cfg.rope:
            q = T.rope_rotate(q, pos, cfg.rope_theta)
            k = T.rope_rotate(k, pos, cfg.rope_theta)
        write_rows(pool, k[0], v[0], blk, off)
        a = masked_attention(q, gather_table(pool, bt), valid)
        x = x + T._dense(p["proj"], a.reshape(1, c, cfg.d_model))
        x = T._ffn(p, x, cfg, T._norm(p["ln2"], x, cfg))[0]
    x = T._norm(params["ln_f"], x, cfg)
    return T.head_logits(params, x[0, n_tok - 1], cfg).float()


class _Req:
    """Host-side request state."""

    __slots__ = ("rid", "prompt", "max_new", "temp", "seed", "arrival",
                 "generated", "n_preempt", "phase", "slot", "ctx", "table",
                 "written", "admit_seq", "queued_at", "wait_s",
                 "first_tok_t", "last_tok", "n_drafted", "n_accepted",
                 "ctx_ids", "spec_idx", "hit_blocks", "skipped_tok", "cow")

    def __init__(self, rid, prompt, max_new, temp, seed, arrival):
        self.rid = rid
        self.prompt = prompt
        self.max_new = int(max_new)
        self.temp = float(temp)
        self.seed = int(seed)
        self.arrival = arrival
        self.generated: list[int] = []
        self.n_preempt = 0
        self.phase = "queued"           # queued -> prefill -> decode
        self.slot = None
        self.ctx = prompt               # prompt (+ generated on requeue)
        self.table: list[int] = []
        self.written = 0                # cache positions filled
        self.admit_seq = -1
        self.queued_at = arrival        # start of the current queue stint
        self.wait_s = 0.0               # queue time over every stint
        self.first_tok_t = None
        self.last_tok = 0
        # speculative decoding: tallies, and the n-gram index built at
        # first use (`_spec_state`)
        self.n_drafted = 0
        self.n_accepted = 0
        self.ctx_ids = None
        self.spec_idx = None
        # prefix caching: blocks mapped from the index and prefill tokens
        # skipped, over every admission; the pending (src, dst) pair of
        # a fully aligned hit until its first chunk copies it
        self.hit_blocks = 0
        self.skipped_tok = 0
        self.cow = None


class ServingEngine:
    """Paged-cache continuous-batching decode server (module docstring).
    `submit`/`poll`/`step`/`run`/`drain` are the programmatic API the
    `serve` driver uses. Runs on `device` (default cuda; see
    `resolve_device`); `params` must already live there."""

    def __init__(self, params, cfg: T.TransformerConfig, *,
                 n_blocks: int = 64, block_size: int = 16,
                 max_slots: int = 4, prefill_chunk: int = 32,
                 table_bucket: int = 4, kv_quant: str = "",
                 weight_quant: str = "", attn_impl: str = "flash",
                 spec_k: int = 0, spec_ngram: int = 3, top_k: int = 0,
                 top_p: float = 0.0, metrics=None, log_every: int = 0,
                 clock=time.time, prefix_cache: bool = False, device=None,
                 chaos_plan=None):
        if attn_impl not in ("gather", "flash"):
            raise ValueError(
                f"unsupported attn_impl={attn_impl!r}; expected 'gather' "
                f"(gather_table + masked_attention) or 'flash' (the "
                f"paged decode kernel)")
        self.device = resolve_device(device)
        stray = {str(t.device) for t in leaves(params)
                 if t.device != self.device}
        if stray:
            raise ValueError(f"params live on {sorted(stray)}, the engine "
                             f"runs on {self.device}")
        # quantize once (from the master weights), then cast once:
        # every tick reads the stored copy
        self.params = T.cast_params(T.quantize_weights(params, weight_quant),
                                    cfg.compute_dtype)
        self.weight_quant = weight_quant
        self.kv_quant = kv_quant
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.table_bucket = int(table_bucket)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.metrics = metrics
        self.log_every = int(log_every)
        self.clock = clock
        # the fault plan consulted at every step (None: the process's,
        # `chaos.active()`; a test passes one to fault one engine of N)
        self.chaos_plan = chaos_plan
        self.pools = init_block_pool(cfg, n_blocks, block_size, kv_quant,
                                     device=self.device)
        self.prefix = PrefixIndex(block_size) if prefix_cache else None
        self.alloc = BlockAllocator(n_blocks, index=self.prefix)
        self._p_bytes = param_read_bytes(self.params)
        self.slots: list[_Req | None] = [None] * self.max_slots
        self.queue: deque[_Req] = deque()
        self.results: dict[str, np.ndarray] = {}
        self.request_records: list[dict] = []
        self.counters = {"submitted": 0, "finished": 0, "preempted": 0,
                         "ticks": 0, "prefill_chunks": 0, "spec_drafted": 0,
                         "spec_accepted": 0, "prefix_lookups": 0,
                         "prefix_hits": 0, "prefix_skipped_tokens": 0,
                         "oom_events": 0}
        self.draining = False
        self._oom_tick = -1
        self._admit_counter = 0
        self._win_tokens = 0            # tokens since the last log line
        self._win_t = clock()
        self._last_touched = 0
        self._win_drafted = 0           # spec-decode window tallies
        self._win_accepted = 0
        self._win_prefix_lookups = 0    # prefix-cache window tallies
        self._win_prefix_hits = 0

    # ------------------------------------------------------ public API

    def submit(self, prompt, max_new: int, temperature: float = 0.0,
               seed: int = 0, rid: str | None = None) -> str:
        """Queue one request. Raises ValueError for requests that could
        never run (prompt + max_new past cfg.max_seq, or more blocks
        than the whole pool) and `EngineDraining` after `drain()`."""
        if self.draining:
            raise EngineDraining(self.pending())
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        tp = prompt.shape[0]
        if tp < 1 or max_new < 1:
            raise ValueError(f"empty request: prompt {tp} tokens, "
                             f"max_new={max_new}")
        if tp + max_new > self.cfg.max_seq:
            raise ValueError(f"prompt {tp} + max_new {max_new} exceeds "
                             f"max_seq={self.cfg.max_seq}")
        # the last sampled token is never written, so the peak
        # footprint is tp + max_new - 1 cache positions
        need = blocks_for(tp + max_new - 1, self.block_size)
        if need > self.alloc.n_usable:
            raise ValueError(
                f"request needs {need} blocks but the pool holds "
                f"{self.alloc.n_usable} usable — it could never be "
                f"scheduled (raise n_blocks or shrink the request)")
        rid = rid if rid is not None else f"r{self.counters['submitted']}"
        if rid in self.results or any(r.rid == rid
                                      for r in self._all_live()):
            raise ValueError(f"duplicate request id {rid!r}")
        self.queue.append(_Req(rid, prompt, max_new, temperature, seed,
                               self.clock()))
        self.counters["submitted"] += 1
        return rid

    def poll(self, rid: str) -> dict:
        """{"status": queued|running|done, "tokens": generated so far}."""
        if rid in self.results:
            return {"status": "done", "tokens": self.results[rid]}
        for r in self._all_live():
            if r.rid == rid:
                status = "queued" if r.phase == "queued" else "running"
                return {"status": status,
                        "tokens": np.asarray(r.generated, np.int32)}
        raise KeyError(rid)

    def pending(self) -> int:
        return len(self.queue) + sum(1 for s in self.slots if s is not None)

    def step(self) -> bool:
        """One scheduler step: admissions, one prefill chunk (FIFO
        across prefilling requests), one decode tick over every
        decoding slot. Returns whether any work ran."""
        plan = (self.chaos_plan if self.chaos_plan is not None
                else chaos.active())
        if plan is not None:
            # tick-indexed faults through the training hooks: a stall
            # sleeps here (the profiler's "data-load" bucket), kill and
            # nan / inf act as on a training step
            with profiler.tag("data-load"):
                plan.on_data_load(self.counters["ticks"])
                plan.on_step(self.counters["ticks"], engine=self)
        did = self._admit()
        did = self._prefill_step() or did
        return self._decode_step() or did

    def run(self, max_steps: int | None = None) -> dict:
        """Step until every submitted request finished (or `max_steps`).
        Returns {rid: tokens}."""
        steps = 0
        while self.pending():
            if max_steps is not None and steps >= max_steps:
                break
            if not self.step():
                raise RuntimeError(
                    "scheduler made no progress with requests pending "
                    f"(queue={len(self.queue)}, "
                    f"free_blocks={self.alloc.n_free})")
            steps += 1
        return dict(self.results)

    def drain(self) -> bool:
        """Stop admitting new submissions; returns True once everything
        already accepted has finished."""
        self.draining = True
        return self.pending() == 0

    # ------------------------------------------------------- scheduler

    def _all_live(self):
        yield from (s for s in self.slots if s is not None)
        yield from self.queue

    def _note_oom(self, e: OutOfBlocks) -> None:
        """Count one recovered block exhaustion, at most once per tick."""
        tick = self.counters["ticks"]
        if tick == self._oom_tick:
            return
        self._oom_tick = tick
        self.counters["oom_events"] += 1
        if self.metrics is not None:
            extra = {"id": str(e.rid)} if e.rid is not None else {}
            self.metrics.log(event="ledger", kind="oom", tick=tick,
                             requested=e.requested, free=e.n_free,
                             cold=e.n_cold, live=e.n_live, **extra)

    def _admit(self) -> bool:
        did = False
        while self.queue and None in self.slots:
            req = self.queue[0]
            need = blocks_for(len(req.ctx), self.block_size)
            # prefix-cache probe: the longest indexed aligned prefix maps
            # straight into the table and prefill starts after it. A
            # fully aligned match still re-prefills its last token, into
            # a fresh copy of the tail block (copy-on-write), so decode
            # never appends to a shared block.
            matched: list[int] = []
            if self.prefix is not None:
                matched = self.prefix.match(req.ctx)
                self.counters["prefix_lookups"] += 1
                self._win_prefix_lookups += 1
            m = len(matched)
            full = m > 0 and m * self.block_size == len(req.ctx)
            try:
                if matched:
                    self.alloc.acquire(matched)
                try:
                    fresh = self.alloc.alloc(need - m + (1 if full else 0),
                                             rid=req.rid)
                except OutOfBlocks:
                    if matched:          # all-or-nothing admission
                        self.alloc.release(matched)
                    raise
            except OutOfBlocks as e:
                self._note_oom(e)
                break                    # wait for blocks to free
            self.queue.popleft()
            slot = self.slots.index(None)
            req.slot = slot
            if full:
                # the acquire above holds the tail block (the copy's
                # source) until the first chunk copies it; the table
                # takes the fresh copy
                req.cow = (matched[-1], fresh[0])
                req.table = matched[:-1] + fresh
                req.written = len(req.ctx) - 1
            else:
                req.cow = None
                req.table = matched + fresh
                req.written = m * self.block_size
            req.phase = "prefill"
            req.admit_seq = self._admit_counter
            self._admit_counter += 1
            req.wait_s += self.clock() - req.queued_at
            self.slots[slot] = req
            if m > 0:
                req.hit_blocks += m
                req.skipped_tok += req.written
                self.counters["prefix_hits"] += 1
                self.counters["prefix_skipped_tokens"] += req.written
                self._win_prefix_hits += 1
            did = True
        return did

    def _tensor(self, a):
        return torch.from_numpy(a).to(self.device)

    def _prefill_step(self) -> bool:
        pre = [r for r in self.slots
               if r is not None and r.phase == "prefill"]
        if not pre:
            return False
        req = min(pre, key=lambda r: r.admit_seq)     # FIFO
        n_tok = min(self.prefill_chunk, len(req.ctx) - req.written)
        tokens = np.ascontiguousarray(
            req.ctx[req.written:req.written + n_tok], np.int32)
        w = table_width(len(req.table), self.table_bucket)
        bt = np.full((1, w), SCRATCH_BLOCK, np.int32)
        bt[0, :len(req.table)] = req.table
        logits = prefill_chunk(self.params, self.pools, self._tensor(tokens),
                               req.written, self._tensor(bt), cfg=self.cfg,
                               cow=req.cow, chunk=self.prefill_chunk)
        if req.cow is not None:
            # the copy landed: drop the reference that kept its source
            self.alloc.release([req.cow[0]])
            req.cow = None
        req.written += n_tok
        self.counters["prefill_chunks"] += 1
        if req.written == len(req.ctx):
            # prompt complete: sample token index len(generated) — 0 for
            # a fresh request, the continuation index after an eviction
            tok = G.sample_rows(logits[None], [req.temp], [req.seed],
                              [len(req.generated)], self.top_k, self.top_p)
            req.phase = "decode"
            self._append_token(req, int(tok[0]))
        return True

    def _decode_step(self) -> bool:
        for req in [r for r in self.slots
                    if r is not None and r.phase == "decode"]:
            if req.slot is not None:          # not evicted meanwhile
                self._ensure_block(req)
        actives = [r for r in self.slots
                   if r is not None and r.phase == "decode"]
        if not actives:
            return False
        s = self.max_slots
        # speculative drafts claim the tick's free rows (empty slots and
        # prefilling requests' idle rows), oldest request first
        drafts: dict[str, tuple] = {}
        if self.spec_k > 0:
            busy = {r.slot for r in actives}
            free = [i for i in range(s) if i not in busy]
            for r in sorted(actives, key=lambda r: r.admit_seq):
                if not free:
                    break
                cap = min(self.spec_k, len(free),
                          r.max_new - len(r.generated) - 1)
                if cap <= 0:
                    continue
                d = self._grow_for_drafts(r, self._propose(r, cap))
                if d:
                    drafts[r.rid] = (r, [(free.pop(0), t) for t in d])
        tok = np.zeros(s, np.int32)
        pos = np.zeros(s, np.int32)
        temp = [0.0] * s
        seeds = [0] * s
        idx = [0] * s
        w = table_width(max(len(r.table) for r in actives),
                        self.table_bucket)
        bt = np.full((s, w), SCRATCH_BLOCK, np.int32)
        for r in actives:
            tok[r.slot] = r.last_tok
            pos[r.slot] = r.written
            temp[r.slot] = r.temp
            seeds[r.slot] = r.seed
            idx[r.slot] = len(r.generated)
            bt[r.slot, :len(r.table)] = r.table
        for r, assigned in drafts.values():
            # draft row j: the j-th draft at position written + j,
            # sampling at token index len(generated) + j
            for j, (row, dtok) in enumerate(assigned, start=1):
                tok[row] = dtok
                pos[row] = r.written + j
                temp[row] = r.temp
                seeds[row] = r.seed
                idx[row] = len(r.generated) + j
                bt[row, :len(r.table)] = r.table
        logits = decode_logits(self.params, self.pools, self._tensor(tok),
                               self._tensor(pos), self._tensor(bt),
                               cfg=self.cfg, attn=self.attn_impl)
        nxt = G.sample_rows(logits, temp, seeds, idx, self.top_k,
                            self.top_p)
        self.counters["ticks"] += 1
        self._last_touched = sum(
            blocks_for(r.written + 1
                       + len(drafts.get(r.rid, (None, ()))[1]),
                       self.block_size)
            for r in actives)
        emitted = 0
        for r in actives:
            # tallies before the appends: an accepted last draft can
            # finish the request, and its record must carry this tick
            assigned = drafts.get(r.rid, (None, ()))[1]
            if assigned:
                r.n_drafted += len(assigned)
                self.counters["spec_drafted"] += len(assigned)
                self._win_drafted += len(assigned)
            tok_next = int(nxt[r.slot])
            r.written += 1
            self._append_token(r, tok_next)
            emitted += 1
            for row, dtok in assigned:
                # accept while the draft is the token its predecessor
                # sampled: this row's logits are then the true ones at
                # the advanced context, and its sample is the stream's
                if r.rid in self.results or dtok != tok_next:
                    break
                tok_next = int(nxt[row])
                r.n_accepted += 1
                self.counters["spec_accepted"] += 1
                self._win_accepted += 1
                r.written += 1
                self._append_token(r, tok_next)
                emitted += 1
        self._win_tokens += emitted
        self._maybe_log()
        return True

    # -------------------------------------------------- spec decoding

    def _propose(self, req, k: int) -> list:
        """The reference's n-gram prompt-lookup proposer: find the most
        recent earlier occurrence of the context's trailing n-gram
        (longest n first, n <= spec_ngram) and draft the k tokens that
        followed it. Host-side dict lookups only."""
        ctx, idx = self._spec_state(req)
        n_ctx = len(ctx)
        for n in range(min(self.spec_ngram, n_ctx - 1), 0, -1):
            ent = idx.get(tuple(ctx[n_ctx - n:]))
            if ent is None:
                continue
            # the latest entry is the tail itself; the source is the
            # most recent occurrence before it
            start = ent[0] if ent[0] != n_ctx - n else ent[1]
            if start is not None:
                return ctx[start + n:start + n + k]
        return []

    def _spec_state(self, req) -> tuple:
        """(ctx_ids, spec_idx), built at first use: the prompt +
        generated tokens as a list (appended in `_append_token`) and a
        map from each n-gram (n <= spec_ngram) to its (latest, previous)
        start positions. Survives eviction: the stream is the same."""
        if req.spec_idx is None:
            req.ctx_ids = req.prompt.tolist() + list(req.generated)
            req.spec_idx = {}
            for j in range(len(req.ctx_ids)):
                self._spec_note(req, j)
        return req.ctx_ids, req.spec_idx

    def _spec_note(self, req, j: int) -> None:
        """Index every n-gram ending at context position j."""
        ctx = req.ctx_ids
        for n in range(1, self.spec_ngram + 1):
            start = j - n + 1
            if start < 0:
                break
            gram = tuple(ctx[start:j + 1])
            ent = req.spec_idx.get(gram)
            req.spec_idx[gram] = (start, None if ent is None else ent[0])

    def _grow_for_drafts(self, req, d: list) -> list:
        """Grow `req`'s table to cover its draft positions without
        evicting anyone: on pool pressure the drafts trim to the blocks
        already held (contrast `_ensure_block`)."""
        if not d:
            return d
        grow = blocks_for(req.written + len(d) + 1,
                          self.block_size) - len(req.table)
        if grow > 0:
            try:
                req.table.extend(self.alloc.alloc(grow, rid=req.rid))
            except OutOfBlocks as e:
                self._note_oom(e)
                cap = len(req.table) * self.block_size - 1 - req.written
                d = d[:max(0, cap)]
        return d

    def _ensure_block(self, req) -> bool:
        """Grow `req`'s table to cover its next write position, evicting
        the newest-admitted running request on OOM (possibly `req`
        itself). Returns whether `req` is still running."""
        while req.written // self.block_size >= len(req.table):
            try:
                req.table.extend(self.alloc.alloc(1, rid=req.rid))
            except OutOfBlocks as e:
                self._note_oom(e)
                live = [r for r in self.slots if r is not None]
                victim = max(live, key=lambda r: r.admit_seq)
                if victim is req and len(live) == 1:
                    # submit() guarantees a lone request fits
                    raise RuntimeError(
                        "allocator invariant violated: a lone request "
                        "cannot grow its table") from None
                self._evict(victim)
                if victim is req:
                    return False
        return True

    def _evict(self, req) -> None:
        """Preempt: release the block references now and re-queue at the
        front. The request keeps its generated tokens and re-prefills
        prompt + generated on re-admission (probing the prefix index
        again), continuing its stream."""
        if req.cow is not None:          # pending copy-on-write source
            self.alloc.release([req.cow[0]])
            req.cow = None
        self.alloc.release(req.table)
        req.table = []
        req.written = 0
        req.ctx = (np.concatenate([req.prompt,
                                   np.asarray(req.generated, np.int32)])
                   if req.generated else req.prompt)
        self.slots[req.slot] = None
        req.slot = None
        req.phase = "queued"
        req.queued_at = self.clock()
        req.n_preempt += 1
        self.counters["preempted"] += 1
        self.queue.appendleft(req)

    def _append_token(self, req, tok: int) -> None:
        req.generated.append(tok)
        if req.spec_idx is not None:    # keep the draft index current
            req.ctx_ids.append(tok)
            self._spec_note(req, len(req.ctx_ids) - 1)
        req.last_tok = tok
        if req.first_tok_t is None:
            req.first_tok_t = self.clock()
        if len(req.generated) >= req.max_new:
            self._finish(req)

    def _finish(self, req) -> None:
        # index the sealed prefix before the release, so its blocks park
        # cold instead of freeing: only blocks wholly written by prefill
        # (positions below len(ctx)) are sealed
        if self.prefix is not None and req.table:
            sealed = min(req.written, len(req.ctx)) // self.block_size
            if sealed > 0:
                self.prefix.insert(req.ctx, req.table[:sealed])
        if req.cow is not None:
            self.alloc.release([req.cow[0]])
            req.cow = None
        self.alloc.release(req.table)
        req.table = []
        self.slots[req.slot] = None
        self.results[req.rid] = np.asarray(req.generated, np.int32)
        self.counters["finished"] += 1
        now = self.clock()
        rec = {
            "id": req.rid,
            "ttft_ms": round((req.first_tok_t - req.arrival) * 1e3, 3),
            "tokens_in": int(req.prompt.shape[0]),
            "tokens_out": len(req.generated),
            "e2e_ms": round((now - req.arrival) * 1e3, 3),
            "wait_ms": round(req.wait_s * 1e3, 3),
            "queue_depth": len(self.queue),
            "preempted": req.n_preempt,
        }
        if len(req.generated) > 1:
            rec["tpot_ms"] = round(
                (now - req.first_tok_t) * 1e3 / (len(req.generated) - 1), 3)
        if self.spec_k > 0:
            rec["spec_drafted"] = req.n_drafted
            rec["spec_accepted"] = req.n_accepted
        if self.prefix is not None:
            rec["prefix_hit_blocks"] = req.hit_blocks
            rec["prefill_skipped_tokens"] = req.skipped_tok
        self.request_records.append(rec)
        if self.metrics is not None:
            self.metrics.log(event="request", **rec)

    def _maybe_log(self) -> None:
        if (self.metrics is None or self.log_every <= 0
                or self.counters["ticks"] % self.log_every):
            return
        now = self.clock()
        dt = max(now - self._win_t, 1e-9)
        bpt = paged_read_bytes_per_tick(self.cfg, self._p_bytes,
                                        self._last_touched, self.block_size,
                                        self.max_slots, self.kv_quant)
        extra = {}
        if self.spec_k > 0:
            extra = {"spec_drafted": self._win_drafted,
                     "spec_accepted": self._win_accepted,
                     "spec_accept_rate": round(
                         self._win_accepted / self._win_drafted, 4)
                     if self._win_drafted else 0.0}
        if self.prefix is not None:
            extra.update(
                prefix_hit_rate=round(
                    self._win_prefix_hits / self._win_prefix_lookups, 4)
                if self._win_prefix_lookups else 0.0,
                cold_blocks=self.alloc.n_cold,
                prefix_blocks=len(self.prefix))
        self.metrics.log(
            event="generate",
            tokens_per_sec=round(self._win_tokens / dt, 2),
            queue_depth=len(self.queue),
            active_slots=sum(1 for r in self.slots if r is not None),
            free_blocks=self.alloc.n_free,
            blocks_touched=self._last_touched,
            bytes_per_tick=int(bpt),
            hbm_gbps=round(self.log_every / dt * bpt / 1e9, 4), **extra)
        self._win_tokens = 0
        self._win_drafted = 0
        self._win_accepted = 0
        self._win_prefix_lookups = 0
        self._win_prefix_hits = 0
        self._win_t = now

