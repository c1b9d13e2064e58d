"""Tokenize a text corpus into a memmappable shard directory — the
port's counterpart of `scripts/build_token_shards.py`, with the same
flags and the same output: shards built by either package are
byte-identical.

    python -m shallowspeed_tpu_torch.build_token_shards --text corpus.txt
        --out shards/ [--tokenizer bpe --vocab-size 8192]
        [--val-fraction 0.1] [--shard-mb 32]

Runs the tokenizer once and writes `shard_*.bin` + `index.json`
(+ the `val.bin` held-out tail, + `tokenizer.json` in BPE mode);
training then streams windows off disk (`train_lm --data-dir`). Prints
one JSON line describing what was written.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from shallowspeed_tpu_torch.data.token_shards import build_shards
from shallowspeed_tpu_torch.data.tokenizer import train_bpe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--text", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tokenizer", choices=["bytes", "bpe"],
                    default="bytes")
    ap.add_argument("--vocab-size", type=int, default=8192,
                    help="BPE target vocab (ignored for bytes)")
    ap.add_argument("--val-fraction", type=float, default=0.1)
    ap.add_argument("--shard-mb", type=int, default=32,
                    help="approximate shard size in MB of token ids")
    args = ap.parse_args(argv)

    raw = Path(args.text).read_bytes()
    if not 0.0 <= args.val_fraction < 1.0:
        raise SystemExit(f"--val-fraction must be in [0, 1), got "
                         f"{args.val_fraction}")
    meta = {"source": args.text, "tokenizer": args.tokenizer}
    if args.tokenizer == "bpe":
        # split the BYTES once, then train the merges and encode each
        # side separately: the val tail never influences the vocabulary
        n_val_bytes = int(len(raw) * args.val_fraction)
        head = raw[:len(raw) - n_val_bytes] if n_val_bytes else raw
        if not head:
            raise SystemExit("--val-fraction leaves no training bytes")
        tok = train_bpe(head, args.vocab_size)
        ids = tok.encode(head)
        val_ids = tok.encode(raw[len(head):]) if n_val_bytes else None
        vocab = tok.vocab_size
        Path(args.out).mkdir(parents=True, exist_ok=True)
        tok.save(Path(args.out) / "tokenizer.json")
        itemsize = 2 if vocab <= (1 << 16) else 4
        out = build_shards(
            np.asarray(ids), args.out, vocab,
            shard_tokens=max(args.shard_mb * (1 << 20) // itemsize, 1024),
            val=val_ids, meta=meta)
    else:
        ids = np.frombuffer(raw, np.uint8).astype(np.int32)
        vocab = 256
        out = build_shards(
            ids, args.out, vocab,
            shard_tokens=max(args.shard_mb * (1 << 20) // 2, 1024),
            val_fraction=args.val_fraction, meta=meta)
    idx = json.loads((out / "index.json").read_text())
    print(json.dumps({
        "out": str(out), "vocab": vocab,
        "shards": len(idx["shard_tokens"]),
        "train_tokens": int(sum(idx["shard_tokens"])),
        "val_tokens": idx["val_tokens"],
        "tokenizer": args.tokenizer}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
