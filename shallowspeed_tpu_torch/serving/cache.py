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

Not ported yet (ROADMAP): the prefix-cache index (the allocator here is
the reference's with `index=None`).
"""

from __future__ import annotations

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.kv_cache import (KV_QUANT_MODES,
                                                    kv_bytes_per_position,
                                                    quantized_rows,
                                                    zero_layer)
from shallowspeed_tpu_torch.weights import leaves

SCRATCH_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The free list is empty. The engine's preemption policy (evict
    the newest running request and re-queue it) catches this; it never
    escapes a `ServingEngine.step`. The payload mirrors the
    reference's typed fields."""

    def __init__(self, requested: int, n_free: int = 0, n_live: int = 0,
                 rid=None):
        self.requested = int(requested)
        self.n_free = int(n_free)
        self.n_live = int(n_live)
        self.rid = rid
        msg = f"need {self.requested} blocks, {self.n_free} free"
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

    `alloc` mints blocks at refcount 1 (all or nothing), `release`
    drops one reference per listed id and returns a block to the free
    list at zero. Invariants: `n_free + n_live == n_usable`; at drain
    `n_live == 0`; `release` rejects ids listed more times than they
    are held; block 0 (scratch) is never handed out."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(f"n_blocks={n_blocks} leaves no usable "
                             f"blocks past the reserved scratch block")
        self.n_blocks = int(n_blocks)
        # LIFO: recently freed blocks are reused first; ids 1..n-1
        self._free = list(range(self.n_blocks - 1, 0, -1))
        self._ref: dict[int, int] = {}

    @property
    def n_usable(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._ref)

    def alloc(self, n: int, rid=None) -> list[int]:
        """`n` fresh blocks at refcount 1, or OutOfBlocks without any
        partial allocation."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise OutOfBlocks(n, n_free=len(self._free),
                              n_live=len(self._ref), rid=rid)
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        return ids

    def release(self, ids) -> None:
        """Drop one reference per listed id; validates every id before
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
                self._free.append(i)


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
