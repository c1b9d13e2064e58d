"""Attention microbenchmark — the port's counterpart of
`scripts/bench_attention.py`: the hand-written flash attention (K1
forward; K1, then K2 and K3 backward, through `ops.flash_attention.
flash_attention`) against the plain attention (`ops.attention.
attention`, the reference's "xla" column) and, as a yardstick only,
PyTorch's `scaled_dot_product_attention` ("sdpa"), by sequence length.

    python -m shallowspeed_tpu_torch.bench_attention [--seqs 2048 8192]
        [--batch 2] [--heads 8] [--head-dim 64] [--dtype bf16|f32]
        [--reps 5] [--device cpu]

Inputs are the reference's: causal, (B, T, H, D) normals drawn from one
`np.random.default_rng(0)` in the order of the sequence lengths, q, k
and v each. "fwd" times the forward; "fwd+bwd" the gradients of
sum(o^2) (f32) with respect to q, k and v. Each time is the best of
`--reps` runs of 20 back-to-back calls after one warm-up call, between
CUDA events on the card (the host clock on the CPU), per call. Prints
the reference's line for each (T, pass), with the SDPA time appended.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.ops.attention import attention
from shallowspeed_tpu_torch.ops.flash_attention import flash_attention

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ITERS = 20


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seqs", type=int, nargs="+", default=[2048, 8192])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p.parse_args(argv)


def plain(q, k, v):
    return attention(q, k, v, causal=True)


def flash(q, k, v):
    return flash_attention(q, k, v, causal=True)


def sdpa(q, k, v):
    """The library's attention on the same (B, T, H, D) tensors."""
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=True)
    return o.transpose(1, 2)


def forward(fn):
    """fn's forward alone, recording no autograd graph."""
    def run(q, k, v):
        with torch.no_grad():
            return fn(q, k, v)

    return run


def grads(fn):
    """fn's fwd+bwd: the gradients of sum(o^2) in f32."""
    def run(q, k, v):
        loss = (fn(q, k, v).float() ** 2).sum()
        return torch.autograd.grad(loss, (q, k, v))

    return run


def timed(fn, xs, reps: int, iters: int = ITERS) -> float:
    """Seconds a call: the best of `reps` runs of `iters` calls after a
    warm-up call."""
    fn(*xs)
    dev = xs[0].device
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(iters):
                fn(*xs)
            b.record()
            b.synchronize()
            secs = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*xs)
            secs = time.perf_counter() - t0
        best = min(best, secs / iters)
    return best


def inputs(rng, t, args, device) -> tuple:
    """q, k, v of sequence length t from `rng`, on `device`, requiring
    grad."""
    shape = (args.batch, t, args.heads, args.head_dim)
    return tuple(torch.from_numpy(rng.normal(size=shape)).to(
        device, DTYPES[args.dtype]).requires_grad_(True) for _ in range(3))


def main(argv=None) -> list:
    """Print the lines; return one dict a (T, pass) with the three
    times in ms."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    rows = []
    for t in args.seqs:
        xs = inputs(rng, t, args, device)
        for name, wrap in (("fwd", forward), ("fwd+bwd", grads)):
            tx, tf, ts = (timed(wrap(fn), xs, args.reps)
                          for fn in (plain, flash, sdpa))
            print(f"T={t:6d} {name:8s} xla {tx * 1e3:8.2f} ms   "
                  f"flash {tf * 1e3:8.2f} ms   speedup {tx / tf:5.2f}x   "
                  f"sdpa {ts * 1e3:8.2f} ms", flush=True)
            rows.append({"seq": t, "pass": name, "xla_ms": tx * 1e3,
                         "flash_ms": tf * 1e3, "sdpa_ms": ts * 1e3,
                         "speedup": tx / tf})
    return rows


if __name__ == "__main__":
    main()
