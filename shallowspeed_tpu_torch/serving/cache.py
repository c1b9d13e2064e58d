"""Paged KV cache: block pools, a host-side free-list allocator, and the
gathered-table read path — counterpart of
`shallowspeed_tpu/serving/cache.py`.

Each layer's cache is a pair of (n_blocks, Hkv, block_size, hd) pools;
a request owns an ordered list of block ids (its block table), and
attention reads through the table. Block 0 is reserved as a scratch
sink: inactive decode rows write there and their tables point there,
so a tick runs at a fixed row count without corrupting a live block.

The pools are updated IN PLACE (`write_rows`). The reference donates
its pools through every compiled tick to the same effect; eager torch
simply writes into the buffers it owns.

int8 pools (`kv_quant="int8"`) add (n_blocks, Hkv, block_size, 1) f32
scale planes "k_s"/"v_s", one scale per (block, head, position), and
`write_rows` quantizes per (row, head) as `kv_cache.cache_write` does.
The presence of "k_s" in a layer's pool is the dispatch (the reference
passes a `quant` flag beside the pools; here the pools carry it).

Prefix caching: `chunk_hashes` (byte-identical to the reference's),
`PrefixIndex`, and the allocator's refcounts and cold LRU list, copied
from the reference so that the port imports nothing of it.
"""

from __future__ import annotations

import hashlib

import numpy as np

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.kv_cache import (KV_QUANT_MODES,
                                                    kv_bytes_per_position,
                                                    quantized_rows,
                                                    zero_layer)
from shallowspeed_tpu_torch.weights import leaves

SCRATCH_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The free and cold lists cannot cover a request. The engine's
    preemption policy (evict the newest running request and re-queue
    it) catches this; it never escapes a `ServingEngine.step`. The
    payload mirrors the reference's typed fields."""

    def __init__(self, requested: int, n_free: int = 0, n_cold: int = 0,
                 n_live: int = 0, rid=None):
        self.requested = int(requested)
        self.n_free = int(n_free)
        self.n_cold = int(n_cold)
        self.n_live = int(n_live)
        self.rid = rid
        msg = (f"need {self.requested} blocks, {self.n_free} free + "
               f"{self.n_cold} cold")
        if rid is not None:
            msg += f" (request {rid!r})"
        super().__init__(msg)


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold `n_tokens` cache positions."""
    return max(0, -(-int(n_tokens) // int(block_size)))


def init_block_pool(cfg: T.TransformerConfig, n_blocks: int,
                    block_size: int, kv_quant: str = "", device=None):
    """Per-layer zero-filled K/V pools (n_blocks, Hkv, block_size, hd)
    in the activation dtype, on `device`; int8 pools add the
    (n_blocks, Hkv, block_size, 1) f32 scale planes."""
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"unsupported kv_quant={kv_quant!r}; expected one of "
            f"{KV_QUANT_MODES} ('' = pool in the compute dtype)")
    if n_blocks < 2:
        raise ValueError(f"n_blocks={n_blocks} leaves no usable blocks "
                         f"past the reserved scratch block")
    shape = (n_blocks, cfg.kv_heads, block_size, cfg.head_dim)
    return [zero_layer(shape, cfg.act_dtype, kv_quant, device)
            for _ in range(cfg.n_layers)]


class BlockAllocator:
    """Host-side refcounted free list over one pool's block ids.

    `alloc` mints blocks at refcount 1 (all or nothing), `acquire` adds
    a reference to a block that is live or cold (a prefix-cache hit),
    `release` (or `free`) drops one reference per listed id. A block at
    refcount zero returns to the free list, unless the `index` still
    maps its content: then it parks on the cold list (LRU, oldest
    first), still matchable, and `alloc` reclaims cold blocks (dropping
    their index entries) before it raises `OutOfBlocks`. Invariants:
    `n_free + n_live + n_cold == n_usable`; at drain `n_live == 0`;
    `release` rejects ids listed more times than they are held; block 0
    (scratch) is never handed out."""

    def __init__(self, n_blocks: int, index: "PrefixIndex | None" = None):
        if n_blocks < 2:
            raise ValueError(f"n_blocks={n_blocks} leaves no usable "
                             f"blocks past the reserved scratch block")
        self.n_blocks = int(n_blocks)
        # LIFO: recently freed blocks are reused first; ids 1..n-1
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}
        # insertion order is the LRU order: front = oldest parked
        self._cold: dict[int, None] = {}
        self.index = index
        self.cold_reclaims = 0
        self.peak_live = 0              # high-water of n_live

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._ref)

    @property
    def n_cold(self) -> int:
        return len(self._cold)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def alloc(self, n: int, rid=None) -> list[int]:
        """`n` fresh blocks at refcount 1, reclaiming cold blocks
        LRU-first when the free list is short, or OutOfBlocks without
        any partial allocation."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free) + len(self._cold):
            raise OutOfBlocks(n, n_free=len(self._free),
                              n_cold=len(self._cold),
                              n_live=len(self._ref), rid=rid)
        while len(self._free) < n:
            self._reclaim_one()
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        self.peak_live = max(self.peak_live, len(self._ref))
        return ids

    def _reclaim_one(self) -> None:
        bid = next(iter(self._cold))          # the oldest parked
        del self._cold[bid]
        if self.index is not None:
            self.index.drop_block(bid)
        self._free.append(bid)
        self.cold_reclaims += 1

    def acquire(self, ids) -> None:
        """One more reference per listed id on blocks that are live or
        cold (cold ones leave the LRU list); validates every id before
        changing anything."""
        ids = list(ids)
        bad = [i for i in ids if i not in self._ref and i not in self._cold]
        if bad:
            raise ValueError(f"acquire() of unknown block(s) {bad}")
        for i in ids:
            self._cold.pop(i, None)
            self._ref[i] = self._ref.get(i, 0) + 1
        self.peak_live = max(self.peak_live, len(self._ref))

    def release(self, ids) -> None:
        """Drop one reference per listed id; at zero a block parks cold
        if the index maps it, else it is free. Validates every id before
        changing anything."""
        ids = list(ids)
        counts: dict[int, int] = {}
        for i in ids:
            counts[i] = counts.get(i, 0) + 1
        bad = [i for i, c in counts.items() if self._ref.get(i, 0) < c]
        if bad:
            raise ValueError(
                f"release() of unallocated/over-released block(s) "
                f"{sorted(bad)}")
        for i in ids:
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                if self.index is not None and self.index.has_block(i):
                    self._cold[i] = None      # most recent at the back
                else:
                    self._free.append(i)

    free = release

    def snapshot(self) -> dict:
        """Occupancy, with `consistent` restating the invariant."""
        return {"n_blocks": self.n_blocks, "n_usable": self.n_usable,
                "n_free": self.n_free, "n_live": self.n_live,
                "n_cold": self.n_cold, "peak_live": self.peak_live,
                "cold_reclaims": self.cold_reclaims,
                "consistent": (self.n_free + self.n_live + self.n_cold
                               == self.n_usable)}


def chunk_hashes(tokens, block_size: int) -> list[bytes]:
    """Chained content hashes of the full block-aligned chunks of
    `tokens`: hash k = blake2b-128(hash k-1 || the chunk's int64 bytes),
    so hash k pins the whole prefix through chunk k. A partial tail is
    never hashed. Byte-identical to the reference's."""
    toks = np.asarray(tokens, dtype=np.int64)
    bs = int(block_size)
    out: list[bytes] = []
    h = b""
    for k in range(len(toks) // bs):
        h = hashlib.blake2b(h + toks[k * bs:(k + 1) * bs].tobytes(),
                            digest_size=16).digest()
        out.append(h)
    return out


class PrefixIndex:
    """Content-addressed map from chained chunk hashes to block ids.

    `match(tokens)` returns the block ids of the longest indexed aligned
    prefix (it stops at the first miss). `insert` maps a finished
    request's sealed prefix blocks first-writer-wins: a hash already
    mapped keeps its block, so one content never aliases two blocks.
    `drop_block` is the allocator's reclaim hook; a dropped parent makes
    its descendants unreachable, since `match` walks parent first."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self._blocks: dict[bytes, int] = {}    # chain hash -> block id
        self._hash_of: dict[int, bytes] = {}   # block id -> chain hash

    def __len__(self) -> int:
        return len(self._blocks)

    def has_block(self, bid: int) -> bool:
        return bid in self._hash_of

    def match(self, tokens) -> list[int]:
        ids: list[int] = []
        for h in chunk_hashes(tokens, self.block_size):
            bid = self._blocks.get(h)
            if bid is None:
                break
            ids.append(bid)
        return ids

    def insert(self, tokens, table) -> int:
        """Map the leading `len(table)` full chunks of `tokens` to the
        given block ids; returns how many new entries landed."""
        new = 0
        for k, h in enumerate(chunk_hashes(tokens, self.block_size)):
            if k >= len(table):
                break
            bid = int(table[k])
            if h in self._blocks or bid in self._hash_of:
                continue
            self._blocks[h] = bid
            self._hash_of[bid] = h
            new += 1
        return new

    def drop_block(self, bid: int) -> None:
        h = self._hash_of.pop(bid, None)
        if h is not None:
            self._blocks.pop(h, None)


def gather_table(pool_blk, bt):
    """One layer's cache read through block tables bt (rows, W): the
    contiguous view {"k"/"v": (rows, Hkv, W*bs, hd)[, "k_s"/"v_s":
    (rows, Hkv, W*bs, 1)]} that `kv_cache.masked_attention` consumes
    (every leaf of the pool is gathered, scale planes included).
    Gathered position j is absolute position j because tables are
    ordered; padding columns point at scratch and the caller's mask
    never admits them."""
    rows, w = bt.shape
    idx = bt.long()
    out = {}
    for name, leaf in pool_blk.items():
        _, hkv, bs, tail = leaf.shape
        g = leaf[idx]                          # (rows, W, Hkv, bs, tail)
        out[name] = g.transpose(1, 2).reshape(rows, hkv, w * bs, tail)
    return out


def write_rows(pool_blk, k_rows, v_rows, blk_ids, offs) -> None:
    """Write per-row single-token K/V (rows, Hkv, hd) at (block id,
    in-block offset) into one layer's pools, in place; int8 pools take
    the rows quantized per (row, head) with their scales, value for
    value as `kv_cache.cache_write` quantizes. Rows steered to the
    scratch block may collide; nothing reads scratch, so which write
    wins does not matter."""
    if "k_s" in pool_blk:
        upd = quantized_rows(k_rows, v_rows)
    else:
        upd = {"k": k_rows, "v": v_rows}
    b, o = blk_ids.long(), offs.long()
    for name, val in upd.items():
        pool_blk[name][b, :, o, :] = val.to(pool_blk[name].dtype)


# ------------------------------------------------ per-tick HBM model


def param_read_bytes(params) -> int:
    """Bytes one decode pass reads for the parameters: every leaf of
    the (already cast) tree at its own dtype — quantized weights as
    their int8/fp8 values plus f32 scales. The reference traces its
    cast with `jax.eval_shape`; here the served tensors exist, so their
    sizes are read directly."""
    return sum(t.numel() * t.element_size() for t in leaves(params))


def paged_read_bytes_per_tick(cfg: T.TransformerConfig, p_bytes: int,
                              blocks_touched: int, block_size: int,
                              n_rows: int, kv_quant: str = "") -> int:
    """HBM read bytes one decode tick usefully moves: the parameters
    (`param_read_bytes`), the K/V bytes (+ int8 scale planes) of the
    live blocks the active rows attend over (`blocks_touched` = sum over
    rows of blocks_for(context length)), and the token ids."""
    per_block = block_size * kv_bytes_per_position(cfg, kv_quant)
    return (int(p_bytes) + cfg.n_layers * int(blocks_touched) * per_block
            + n_rows * 4)
