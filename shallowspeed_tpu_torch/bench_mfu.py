"""MFU benchmark — the port's counterpart of `scripts/bench_mfu.py`:
transformer-LM training at a saturating config (d_model >= 1024,
seq >= 2048, bf16 compute, the flash attention kernels K1-K3), timed
over steady-state steps, reported as tokens/s, TFLOP/s and MFU against
the card's bf16 peak (`flops.mfu`: 989 TFLOP/s on an H100).

    python -m shallowspeed_tpu_torch.bench_mfu [--d-model 1024
        --n-layers 8 --seq-len 2048 --batch-size 8 --steps 20 ...]
        [--device cpu]

Flags and defaults are the reference's. The engine is
`parallel.context.ContextParallelEngine` on one device, AdamW (or
Adafactor) at 3e-4, weights `init(cfg, seed=0)`, one batch of random
ids (numpy seed 0) repeated for every step. A run is `train_run` over
`--steps` steps staged on the device once; one warm-up run is
excluded, then the best of 3 timed runs, each closed by
`torch.cuda.synchronize()` where the reference fetches the losses.
Prints one JSON line with the reference's keys. On the CPU the same
runs time the plain attention's host rate and `mfu` is null.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.flops import mfu, transformer_flops_per_token
from shallowspeed_tpu_torch.models.transformer import TransformerConfig
from shallowspeed_tpu_torch.optim import Adafactor, AdamW
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.weights import leaves


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """The benchmark at `args` (the parsed flags): one JSON-able dict."""
    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.seq_len,
        compute_dtype=torch.bfloat16, rope=True, norm="rmsnorm",
        ffn=args.ffn, remat=args.remat, remat_policy=args.remat_policy,
        xent_chunk=args.xent_chunk)
    opt = (Adafactor(3e-4) if args.optimizer == "adafactor"
           else AdamW(3e-4))
    eng = ContextParallelEngine(cfg, opt, seed=0, attn=args.attn,
                                device=device, accum=args.accum)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, args.vocab,
                        (args.batch_size, args.seq_len)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    stack_t = np.broadcast_to(toks, (args.steps, *toks.shape)).copy()
    stack_g = np.broadcast_to(tgts, (args.steps, *tgts.shape)).copy()
    eng.train_run(stack_t, stack_g)          # warm-up (excluded)
    _sync(device)
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        eng.train_run(stack_t, stack_g)
        _sync(device)
        dt = time.perf_counter() - t0
        best = max(best, args.steps * args.batch_size * args.seq_len / dt)
    stats = mfu(best, cfg, args.seq_len, dtype="bf16", device=device)
    return {
        "metric": "transformer_train_mfu",
        "config": {
            "d_model": args.d_model, "n_layers": args.n_layers,
            "n_heads": args.n_heads, "seq_len": args.seq_len,
            "batch": args.batch_size, "vocab": args.vocab,
            "ffn": args.ffn, "attn": args.attn, "remat": args.remat,
            "remat_policy": args.remat_policy,
            "xent_chunk": args.xent_chunk, "accum": args.accum,
            "optimizer": args.optimizer,
            "params_m": round(sum(x.numel() for x in leaves(eng.params))
                              / 1e6, 1),
        },
        "tokens_per_sec": round(best, 0),
        "flops_per_token": round(
            transformer_flops_per_token(cfg, args.seq_len)),
        "tflops": round(stats["tflops"], 1),
        "peak_tflops": stats["peak_tflops"],
        "mfu": None if stats["mfu"] is None else round(stats["mfu"], 4),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d-model", type=int, default=1024)
    ap.add_argument("--n-heads", type=int, default=16)
    ap.add_argument("--n-layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--ffn", default="swiglu", choices=["gelu", "swiglu"])
    ap.add_argument("--attn", default="flash",
                    choices=["flash", "ring", "ring-flash", "ulysses",
                             "ulysses-flash"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "attn", "dots"])
    ap.add_argument("--xent-chunk", type=int, default=0)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    out = run(parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
