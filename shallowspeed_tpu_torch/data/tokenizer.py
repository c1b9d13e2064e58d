"""Byte-level BPE tokenizer — trained, saved, and loaded by the framework.
A copy of `shallowspeed_tpu/data/tokenizer.py` (the port imports
nothing of the JAX package); the code and the `tokenizer.json` format
are the reference's, so either package reads the other's file and
trains the same merges from the same text.

Byte-pair encoding over UTF-8 bytes (GPT-2's scheme, minus the regex
pre-tokenizer — chunks split on whitespace with the space glued to the
following word, so merges never cross word boundaries).

Design points:
- Base alphabet is all 256 bytes, so ANY input encodes losslessly and
  decode is exact byte reconstruction — no <unk>, no normalization.
- `train` counts pair frequencies over unique chunks (frequency-weighted),
  merging the most frequent pair until `vocab_size`; pure NumPy/Python,
  fine for the corpus sizes a single-host text file reaches.
- `encode` caches per-chunk tokenizations, so repeated words cost one
  merge pass; returns int32 ids ready for the LM engines.
- Persistence is one JSON file (the merge list) — saved next to
  checkpoints so `--sample-only` restores text fidelity with the model.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

_CHUNK = re.compile(rb"\s*\S+|\s+")


def _chunks(data: bytes) -> list[bytes]:
    return _CHUNK.findall(data)


class ByteBPE:
    """Byte-level BPE: ids 0..255 are raw bytes, id 256+i is merge i."""

    def __init__(self, merges: list[tuple[int, int]]):
        self.merges = [tuple(m) for m in merges]
        self._rank = {pair: i for i, pair in enumerate(self.merges)}
        # id -> bytes it expands to (built up in merge order)
        self._bytes = [bytes([i]) for i in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self._cache: dict[bytes, list[int]] = {}

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges)

    # ------------------------------------------------------------ encode

    def _merge_chunk(self, chunk: bytes) -> list[int]:
        ids = list(chunk)
        while len(ids) > 1:
            best, best_rank = None, None
            for pair in zip(ids, ids[1:]):
                r = self._rank.get(pair)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = pair, r
            if best is None:
                break
            new_id = 256 + best_rank
            out, i = [], 0
            while i < len(ids):
                if (i + 1 < len(ids)
                        and (ids[i], ids[i + 1]) == best):
                    out.append(new_id)
                    i += 2
                else:
                    out.append(ids[i])
                    i += 1
            ids = out
        return ids

    def encode(self, text) -> np.ndarray:
        data = text.encode() if isinstance(text, str) else bytes(text)
        out: list[int] = []
        for chunk in _chunks(data):
            got = self._cache.get(chunk)
            if got is None:
                got = self._merge_chunk(chunk)
                self._cache[chunk] = got
            out.extend(got)
        return np.asarray(out, np.int32)

    def decode(self, ids) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_bytes(self, ids) -> bytes:
        return b"".join(self._bytes[int(i)] for i in np.asarray(ids).ravel())

    # ------------------------------------------------------- persistence

    def save(self, path) -> None:
        Path(path).write_text(json.dumps(
            {"kind": "byte_bpe", "merges": self.merges}))

    @classmethod
    def load(cls, path) -> "ByteBPE":
        head = json.loads(Path(path).read_text())
        assert head.get("kind") == "byte_bpe", head.get("kind")
        return cls([tuple(m) for m in head["merges"]])


def train_bpe(text, vocab_size: int) -> ByteBPE:
    """Train a ByteBPE to `vocab_size` (>= 256) on `text` (str or bytes).

    Frequency-weighted over unique whitespace chunks, INCREMENTAL:
    a naive trainer recounted every pair over every
    word per merge — O(vocab_size x corpus vocabulary), ~6 hours for a
    32k vocab on a 10 MB corpus, which blocked the flagship config's
    tokenizer. This form keeps global pair counts, a pair -> words
    index, and a lazy max-heap: each merge touches only the words that
    CONTAIN the merged pair and pushes refreshed heap entries for the
    pairs whose counts changed (stale entries are discarded on pop —
    the standard BPE trainer structure). 32k merges on the same corpus
    now take ~2 minutes. Deterministic: ties on count break toward the
    smaller (a, b) pair id tuple. Stops early if no pair repeats."""
    import heapq

    assert vocab_size >= 256, vocab_size
    data = text.encode() if isinstance(text, str) else bytes(text)
    counts: dict[bytes, int] = {}
    for c in _chunks(data):
        counts[c] = counts.get(c, 0) + 1
    words, wfreq = [], []
    for c, n in counts.items():
        words.append(list(c))
        wfreq.append(n)

    pair_counts: dict[tuple[int, int], int] = {}
    pair_words: dict[tuple[int, int], set[int]] = {}
    for w, (ids, n) in enumerate(zip(words, wfreq)):
        for pair in zip(ids, ids[1:]):
            pair_counts[pair] = pair_counts.get(pair, 0) + n
            pair_words.setdefault(pair, set()).add(w)

    # lazy heap: entries are (-count, pair); an entry is valid only if
    # its count still matches pair_counts (stale ones pop and drop)
    heap = [(-n, p) for p, n in pair_counts.items()]
    heapq.heapify(heap)

    def bump(pair, delta, w):
        n = pair_counts.get(pair, 0) + delta
        if n <= 0:
            pair_counts.pop(pair, None)
            return
        pair_counts[pair] = n
        if delta > 0:
            pair_words.setdefault(pair, set()).add(w)
            heapq.heappush(heap, (-n, pair))

    merges: list[tuple[int, int]] = []
    while 256 + len(merges) < vocab_size and heap:
        # pop to the highest CURRENT count; among equal counts the heap
        # yields the smallest pair tuple (deterministic tie-break)
        neg, best = heapq.heappop(heap)
        cur = pair_counts.get(best, 0)
        if -neg != cur:
            if cur > 0:  # stale entry; re-push at the true count
                heapq.heappush(heap, (-cur, best))
            continue
        if cur < 2:
            break  # nothing repeats; further merges are memorization
        new_id = 256 + len(merges)
        merges.append(best)
        touched = pair_words.pop(best, set())
        pair_counts.pop(best, None)
        for w in touched:
            ids, n = words[w], wfreq[w]
            i = 0
            while i < len(ids) - 1:
                if (ids[i], ids[i + 1]) != best:
                    i += 1
                    continue
                # neighbors lose their old pairing, gain the merged id
                if i > 0:
                    bump((ids[i - 1], ids[i]), -n, w)
                    bump((ids[i - 1], new_id), n, w)
                if i + 2 < len(ids):
                    bump((ids[i + 1], ids[i + 2]), -n, w)
                    bump((new_id, ids[i + 2]), n, w)
                ids[i:i + 2] = [new_id]
    return ByteBPE(merges)
