"""Decode benchmark — the port's counterpart of `scripts/bench_decode.py`:
prefill tok/s and steady-state decode tok/s of the contiguous-cache
`models.generate.generate` loop, and the pipelined decode of
`parallel.pipeline_lm.PipelineLMEngine.generate`.

    python -m shallowspeed_tpu_torch.bench_decode [--long-context]
        [--pp P] [--device cpu]

Method, as the reference's: time `generate(max_new=N1)` and
`generate(max_new=N2)` (one warm-up call excluded, best of 3 each;
`generate` returns host tokens, so each call ends synchronised); the
steady decode rate is (N2 - N1) B / (t2 - t1), the difference cancelling
the prefill and the fixed costs, and the prefill rate B Tp /
t(max_new=1). A prompt bucket at or past `generate`'s
`flash_prefill_at` prefills through K1 (`csrc/flash_fwd.cu`). The GQA
rows show the smaller cache of fewer kv heads; `--long-context` runs
the cache-dominated regime (batch 8, ~8k context), bf16 against int8
KV caches. `--pp P` times the pipelined decode at pp in {1, 2, P},
every pipeline cell on the one device (so tok/s there is the cost of
the per-token stage chain on one card, not of a multi-card pipeline).
Prints one JSON line a config with the reference's keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import generate


def time_generate(params, prompt, cfg, max_new, reps=3, kv_quant=""):
    """Best seconds of `reps` greedy `generate` calls after a warm-up."""
    generate(params, prompt, cfg, max_new, temperature=0.0,
             kv_quant=kv_quant)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        generate(params, prompt, cfg, max_new, temperature=0.0,
                 kv_quant=kv_quant)
        best = min(best, time.perf_counter() - t0)
    return best


def run_config(batch, prompt_len, max_seq, kv_heads=0, d_model=1024,
               n_layers=8, n_heads=16, kv_quant="", device=None) -> dict:
    """One contiguous-decode config: the bf16 LM (RoPE, RMSNorm, SwiGLU,
    vocab 256) from `init(cfg, seed=0)`, a random prompt (numpy seed
    0)."""
    dev = resolve_device(device)
    cfg = T.TransformerConfig(
        vocab=256, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        max_seq=max_seq, compute_dtype=torch.bfloat16, rope=True,
        norm="rmsnorm", ffn="swiglu", n_kv_heads=kv_heads)
    params = T.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)

    n1 = 32
    n2 = min(256, max_seq - prompt_len)
    t_pre = time_generate(params, prompt, cfg, 1, kv_quant=kv_quant)
    t1 = time_generate(params, prompt, cfg, n1, kv_quant=kv_quant)
    t2 = time_generate(params, prompt, cfg, n2, kv_quant=kv_quant)
    decode_tps = (n2 - n1) * batch / max(t2 - t1, 1e-9)
    return {
        "metric": "decode_throughput",
        "config": {"batch": batch, "prompt_len": prompt_len,
                   "max_seq": max_seq, "d_model": d_model,
                   "n_layers": n_layers, "n_heads": n_heads,
                   "kv_heads": kv_heads or n_heads,
                   "kv_quant": kv_quant or "bf16"},
        "prefill_tokens_per_sec": round(batch * prompt_len / t_pre, 0),
        "decode_tokens_per_sec": round(decode_tps, 1),
        "decode_ms_per_token": round(1000.0 / (decode_tps / batch), 3),
    }


def run_pp_config(pp, batch=4, prompt_len=64, max_seq=256, d_model=128,
                  n_layers=4, n_heads=4, device=None) -> dict:
    """The pipelined decode at dp 1 x `pp` (f32, SGD, one microbatch),
    every cell on `device`."""
    from shallowspeed_tpu_torch.optim import SGD
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    dev = resolve_device(device)
    cfg = T.TransformerConfig(
        vocab=256, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        max_seq=max_seq, rope=True, norm="rmsnorm", ffn="swiglu")
    eng = PipelineLMEngine(cfg, SGD(0.1), make_pipeline_mesh(1, pp, 1, dev),
                           n_mubatches=1, seed=0)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)

    def timed(max_new, reps=3):
        eng.generate(prompt, max_new, temperature=0.0)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.generate(prompt, max_new, temperature=0.0)
            best = min(best, time.perf_counter() - t0)
        return best

    n1, n2 = 16, min(128, max_seq - prompt_len)
    t1, t2 = timed(n1), timed(n2)
    tps = (n2 - n1) * batch / max(t2 - t1, 1e-9)
    return {
        "metric": "pp_decode_throughput",
        "config": {"pp": pp, "batch": batch, "prompt_len": prompt_len,
                   "d_model": d_model, "n_layers": n_layers},
        "decode_tokens_per_sec": round(tps, 1),
        "decode_ms_per_token": round(1000.0 / (tps / batch), 3),
    }


# the reference's default rows
CONFIGS = (
    {"batch": 1, "prompt_len": 512, "max_seq": 2048},
    {"batch": 8, "prompt_len": 512, "max_seq": 2048},
    {"batch": 32, "prompt_len": 128, "max_seq": 1024},
    # GQA, 4x fewer kv heads: a 4x smaller cache to read a token
    {"batch": 8, "prompt_len": 512, "max_seq": 2048, "kv_heads": 4},
    {"batch": 1, "prompt_len": 512, "max_seq": 2048, "kv_heads": 4},
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pp", type=int, default=0,
                    help="time the pipelined decode at pp in {1, 2, PP}, "
                         "every cell on the one device, instead of the "
                         "contiguous-cache decode")
    ap.add_argument("--long-context", action="store_true",
                    help="the cache-dominated regime (batch 8, ~8k "
                         "context): bf16 against int8 KV caches")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    if args.long_context:
        runs = [dict(batch=8, prompt_len=7936, max_seq=8192, kv_heads=kv,
                     kv_quant=q) for q in ("", "int8") for kv in (0, 4)]
        rows = (run_config(**kw, device=args.device) for kw in runs)
    elif args.pp:
        rows = (run_pp_config(pp, device=args.device)
                for pp in sorted({1, 2, args.pp}))
    else:
        rows = (run_config(**kw, device=args.device) for kw in CONFIGS)
    out = []
    for row in rows:
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
