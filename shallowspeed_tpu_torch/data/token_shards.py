"""Streaming tokenized-shard corpus — the transformer family's L0.
A copy of `shallowspeed_tpu/data/token_shards.py` (the port imports
nothing of the JAX package): the same files, the same `index.json`,
the same batches, so either package trains from shards the other
built.

- **Shards on disk, memmapped**: `shard_0000.bin ...` raw
  little-endian token ids (uint16 when vocab fits, else uint32) plus
  `index.json` (dtype, per-shard token counts, vocab, `build_shards`'
  settings). Nothing is loaded eagerly; a batch touches only the
  windows it reads.
- **Deterministic, checkpoint-resumable order**: `batch(step)` is a
  PURE function of (seed, step), held without materializing an index,
  so a resumed run replays the exact stream. Two orders:
  - "perm" (default): step-major walk of an affine permutation
    `w = (a*j + c) mod N` over all N windows (a coprime to N; a, c
    drawn per epoch from (seed, epoch)) — every window exactly once
    per epoch, reshuffled each epoch, O(1) state.
  - "random": i.i.d. (shard, start) per row — the `--text` sampler's
    semantics for corpora where window alignment shouldn't matter.
- **Held-out split protocol**: `build_shards` carves the LAST
  `val_fraction` of tokens into `val.bin` BEFORE sharding, so train
  windows can never leak into validation; `val_batch` draws from it
  with the same pure-seeded addressing.

Windows are non-overlapping seq_len+1 slices WITHIN a shard (the +1
feeds the shifted target); the at-most-seq_len tail of each shard is
dropped.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

_INDEX = "index.json"
_VAL = "val.bin"


def _token_dtype(vocab: int):
    return np.uint16 if vocab <= (1 << 16) else np.uint32


def build_shards(tokens: np.ndarray, out_dir, vocab: int,
                 shard_tokens: int = 1 << 24,
                 val_fraction: float = 0.0, meta: dict | None = None,
                 val: np.ndarray | None = None) -> Path:
    """Write `tokens` (1-D int array) as a shard directory. The val
    split (if any) is the corpus TAIL, written to its own file before
    sharding — train/val windows are disjoint by construction. Pass
    `val` explicitly when the caller already split the corpus (e.g. the
    BPE shard script splits BYTES before encoding so the tokenizer never
    sees held-out text); otherwise `val_fraction` carves the token
    tail here."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    tokens = np.asarray(tokens)
    assert tokens.ndim == 1 and len(tokens) > 0, tokens.shape
    assert int(tokens.min()) >= 0 and int(tokens.max()) < vocab, (
        tokens.min(), tokens.max(), vocab)
    dt = _token_dtype(vocab)
    assert val is None or not val_fraction, (
        "pass EITHER an explicit val array or val_fraction")
    if val is not None:
        val = np.asarray(val)
        n_val = len(val)
        assert n_val > 0, "explicit val split is empty"
        # same range check train tokens get above: out-of-range ids
        # would silently WRAP in the narrowing astype below and only
        # surface as corrupt val batches much later
        assert int(val.min()) >= 0 and int(val.max()) < vocab, (
            f"explicit val ids outside [0, {vocab}): "
            f"min={int(val.min())}, max={int(val.max())}")
        val.astype(dt).tofile(out / _VAL)
    else:
        n_val = int(len(tokens) * val_fraction)
        if val_fraction:
            assert 0 < n_val < len(tokens), (
                f"val_fraction={val_fraction} of {len(tokens)} tokens "
                f"leaves no usable split")
            tokens, tail = tokens[:-n_val], tokens[-n_val:]
            tail.astype(dt).tofile(out / _VAL)
    counts = []
    for i, start in enumerate(range(0, len(tokens), shard_tokens)):
        chunk = tokens[start:start + shard_tokens]
        chunk.astype(dt).tofile(out / f"shard_{i:04d}.bin")
        counts.append(len(chunk))
    (out / _INDEX).write_text(json.dumps({
        "dtype": np.dtype(dt).name, "vocab": int(vocab),
        "shard_tokens": counts, "val_tokens": n_val,
        **(meta or {})}))
    return out


class TokenShards:
    """Memmapped random-access view of a shard directory (see module
    docstring for the order/split contracts)."""

    def __init__(self, data_dir, seq_len: int):
        self.dir = Path(data_dir)
        idx = json.loads((self.dir / _INDEX).read_text())
        self.vocab = int(idx["vocab"])
        self.seq_len = int(seq_len)
        dt = np.dtype(idx["dtype"])
        self._mms = []
        for i, n in enumerate(idx["shard_tokens"]):
            mm = np.memmap(self.dir / f"shard_{i:04d}.bin", dtype=dt,
                           mode="r")
            assert len(mm) == n, (i, len(mm), n)
            self._mms.append(mm)
        self._val = (np.memmap(self.dir / _VAL, dtype=dt, mode="r")
                     if idx.get("val_tokens") else None)
        # non-overlapping (seq_len+1)-windows per shard; cumulative
        # counts give O(log S) window -> (shard, offset) addressing
        w = self.seq_len + 1
        self._wins = np.array([len(m) // w for m in self._mms])
        assert self._wins.sum() > 0, (
            f"no shard holds a full seq_len+1={w} window")
        self._cum = np.concatenate([[0], np.cumsum(self._wins)])
        self.n_windows = int(self._wins.sum())

    # ------------------------------------------------------- addressing

    def _window(self, w: int) -> np.ndarray:
        s = int(np.searchsorted(self._cum, w, side="right")) - 1
        off = (w - int(self._cum[s])) * (self.seq_len + 1)
        return np.asarray(
            self._mms[s][off:off + self.seq_len + 1], np.int32)

    @staticmethod
    @functools.lru_cache(maxsize=64)
    def _perm_params(n: int, seed: int, epoch: int):
        """Affine permutation of range(n): j -> (a*j + c) % n with
        gcd(a, n) == 1 — a full-cycle reshuffle in O(1) state. Cached:
        every row of a batch (and every batch of an epoch) reuses one
        (a, c) pair."""
        if n == 1:  # single-window corpus: the only permutation
            return 1, 0
        rng = np.random.default_rng([seed, 0x5eed, epoch])
        while True:
            a = int(rng.integers(1, n)) | 1  # odd helps; still verify
            if np.gcd(a, n) == 1:
                break
        c = int(rng.integers(0, n))
        return a, c

    # ---------------------------------------------------------- batches

    def batch(self, step: int, batch_size: int, seed: int = 0,
              order: str = "perm"):
        """(tokens, targets) (B, T) int32 for `step` — pure in
        (seed, step), so a resumed run replays the exact stream."""
        t = self.seq_len
        if order == "perm":
            n = self.n_windows
            rows = []
            for i in range(batch_size):
                j = step * batch_size + i
                epoch, k = divmod(j, n)
                a, c = self._perm_params(n, seed, epoch)
                rows.append(self._window((a * k + c) % n))
            win = np.stack(rows)
        else:
            assert order == "random", order
            rng = np.random.default_rng([seed, step])
            ws = rng.integers(0, self.n_windows, batch_size)
            win = np.stack([self._window(int(w)) for w in ws])
        return win[:, :t].copy(), win[:, 1:t + 1].copy()

    def val_batch(self, step: int, batch_size: int, seed: int = 0):
        """Held-out batch from val.bin (random starts — the val tail is
        one stream, matching the --text val sampler's semantics)."""
        assert self._val is not None, (
            f"{self.dir} was built without a val split "
            f"(build_shards(val_fraction=...))")
        t = self.seq_len
        assert len(self._val) > t + 1, "val split shorter than seq_len"
        rng = np.random.default_rng([seed, step])
        starts = rng.integers(0, len(self._val) - t - 1, batch_size)
        tok = np.stack([np.asarray(self._val[s:s + t], np.int32)
                        for s in starts])
        tgt = np.stack([np.asarray(self._val[s + 1:s + t + 1], np.int32)
                        for s in starts])
        return tok, tgt

    @property
    def has_val(self) -> bool:
        return self._val is not None

    @property
    def val_tokens(self) -> int:
        """Held-out split length (0 when absent) — public so drivers
        can fail fast on undersized splits without reaching into the
        memmap."""
        return 0 if self._val is None else len(self._val)


class ValSplit:
    """Duck-typed like `TokenShards.batch` so the driver's one batch
    path serves both streams (`train_lm.make_batch` dispatches on the
    `.batch` attribute)."""

    def __init__(self, shards: TokenShards):
        self._s = shards

    def batch(self, step: int, batch_size: int, seed: int = 0,
              order: str = "perm"):
        return self._s.val_batch(step, batch_size, seed)
