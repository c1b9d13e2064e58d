"""GPipe vs 1F1B (vs zero-bubble, vs interleaved) pipeline step rates —
the port's counterpart of `scripts/bench_pipeline.py`, on
`parallel.pipeline_lm.PipelineLMEngine` with every cell of the (dp 1,
pp[, sp]) grid on the one device.

    python -m shallowspeed_tpu_torch.bench_pipeline [--pp 2 --n-mu 4
        --steps 5 --virtual-pp 2 --sp 0 ...] [--device cpu]

One device runs every stage in turn, so tok/s is not a multi-card
pipeline's; the ratios between schedules on the same device are the
comparison (1F1B reruns each microbatch's chunk forward in its
backward, zero-bubble splits the backward into B and W). Each schedule:
the bf16 LM (RoPE, RMSNorm, SwiGLU, vocab 256, `init(cfg, seed=0)`),
AdamW 3e-4, the flash kernels K1-K3 ("ring" over an sp axis, as the
reference), one batch of random ids (numpy seed 0); a warm-up
`train_batch` excluded, then the best of 3 runs of `--steps`
`train_batch_async` calls, each run closed by reading the last loss,
as the reference's, and a device synchronise. Prints one JSON line
with the reference's keys. `--n-heads` defaults to 4, not the
reference's 8: K1-K3 take head_dim 64 or 128, and 256 / 8 is 32.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device


def bench_engine(schedule, args, virtual_pp=1, sp=1) -> float:
    """The best tokens/s of one schedule's engine."""
    from shallowspeed_tpu_torch.models.transformer import TransformerConfig
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    device = resolve_device(args.device)
    cfg = TransformerConfig(
        vocab=256, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.seq_len,
        compute_dtype=torch.bfloat16, rope=True, norm="rmsnorm",
        ffn="swiglu")
    eng = PipelineLMEngine(cfg, AdamW(3e-4),
                           make_pipeline_mesh(1, args.pp, 1, device, sp=sp),
                           n_mubatches=args.n_mu, seed=0, schedule=schedule,
                           attn="ring" if sp > 1 else "flash",
                           virtual_pp=virtual_pp)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab,
                        (args.batch_size, args.seq_len)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    eng.train_batch(toks, tgts)             # warm-up (excluded)
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        loss = None
        for _ in range(args.steps):
            loss = eng.train_batch_async(toks, tgts)
        float(loss)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        best = max(best, args.steps * args.batch_size * args.seq_len / dt)
    return best


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--n-mu", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--sp", type=int, default=0,
                    help="also time gpipe against 1f1b on a (dp, pp, sp) "
                         "grid (ring attention; 0 = skip)")
    ap.add_argument("--virtual-pp", type=int, default=2,
                    help="also time interleaved virtual stages at this "
                         "chunk count (0/1 = skip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    gpipe = bench_engine("gpipe", args)
    f1b1 = bench_engine("1f1b", args)
    zb = bench_engine("zb", args)
    out = {
        "metric": "pipeline_schedule_throughput",
        "substrate": f"{device.type}-{args.pp}cells-one-device",
        "config": {"pp": args.pp, "n_mubatches": args.n_mu,
                   "d_model": args.d_model, "n_layers": args.n_layers,
                   "seq_len": args.seq_len, "batch": args.batch_size},
        "gpipe_tokens_per_sec": round(gpipe, 0),
        "1f1b_tokens_per_sec": round(f1b1, 0),
        "1f1b_over_gpipe": round(f1b1 / gpipe, 3),
        "zb_tokens_per_sec": round(zb, 0),
        "zb_over_1f1b": round(zb / f1b1, 3),
        "zb_over_gpipe": round(zb / gpipe, 3),
    }
    if args.virtual_pp > 1 and args.n_layers % (args.pp * args.virtual_pp) == 0:
        inter = bench_engine("gpipe", args, virtual_pp=args.virtual_pp)
        out["interleaved_tokens_per_sec"] = round(inter, 0)
        out["interleaved_over_gpipe"] = round(inter / gpipe, 3)
        interf = bench_engine("1f1b", args, virtual_pp=args.virtual_pp)
        out["interleaved_1f1b_tokens_per_sec"] = round(interf, 0)
        out["interleaved_1f1b_over_gpipe"] = round(interf / gpipe, 3)
    if args.sp > 1:
        gp_sp = bench_engine("gpipe", args, sp=args.sp)
        f1_sp = bench_engine("1f1b", args, sp=args.sp)
        out["sp"] = args.sp
        out["sp_gpipe_tokens_per_sec"] = round(gp_sp, 0)
        out["sp_1f1b_tokens_per_sec"] = round(f1_sp, 0)
        out["sp_1f1b_over_gpipe"] = round(f1_sp / gp_sp, 3)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
