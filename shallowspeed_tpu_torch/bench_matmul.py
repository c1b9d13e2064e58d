"""Narrow-matmul probe — counterpart of `scripts/bench_matmul.py`: the
rate of `torch.matmul` and of the blocked matmul K5 (`ops.matmul.
blocked_matmul`, `csrc/blocked_matmul.cu`) over the reference's six
(K, N) shapes at M rows.

    python -m shallowspeed_tpu_torch.bench_matmul [--m 16384] [--iters 100]
        [--device cpu]

Inputs are the reference's: for each shape, x (M, K) and y (K, N) drawn
as normals from `np.random.default_rng(0)`, in bf16. The "torch" variant
(`torch.matmul`) stands where the reference's "xla" variant (`x @ y`)
stands; "blocked" runs K5 with the reference's blocks (bm 512,
bk min(1024, K), bn 1024): its tensor-core build on the card, since
the probe's shapes are bf16 with K and N multiples of 8. Each (shape, variant) prints one JSON line
with the reference's keys (`metric="matmul_tflops", m, k, n, variant,
tflops, ms, error`) and the device it ran on.

Timing: one warm-up chain, then 3 timed chains of `iters` back-to-back
calls between CUDA events; the best chain's ms per call is reported.
The reference wraps its chain in a `lax.scan` that perturbs the weight
each step and sums every product into the carry, to stop XLA from
eliminating or hoisting the matmuls and to fetch one scalar through a
slow host link. Eager torch launches every call it is given and the
events are read after one synchronise, so none of that is needed here.
The reference catches a variant's exception into `error`; here a
failing launch ends the run with the exception, and `error` stays null.

On the CPU (`--device cpu`) the same chains run on the host clock, with
the plain version of K5; its numbers are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.ops.matmul import blocked_matmul

SHAPES = [(1024, 4096), (1024, 8192), (2048, 8192), (512, 2048),
          (1024, 1024), (4096, 1024)]


def _blocked(x, y):
    return blocked_matmul(x, y, bm=512, bk=min(1024, x.shape[1]), bn=1024)


VARIANTS = (("torch", torch.matmul), ("blocked", _blocked))


def _chain_ms(mm, x, y, iters: int) -> float:
    """ms per call of one chain of `iters` calls of mm(x, y)."""
    if x.is_cuda:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            mm(x, y)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        mm(x, y)
    return 1e3 * (time.perf_counter() - t0) / iters


def bench_ms(mm, x, y, iters: int = 100, reps: int = 3) -> float:
    """The best of `reps` timed chains after one warm-up chain."""
    _chain_ms(mm, x, y, iters)
    return min(_chain_ms(mm, x, y, iters) for _ in range(reps))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--m", type=int, default=16384)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "version of the kernel)")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the probe; prints and returns one record per (shape,
    variant)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    m = args.m
    records = []
    for k, n in SHAPES:
        rng = np.random.default_rng(0)
        x, y = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                .to(device).to(torch.bfloat16)
                for shape in ((m, k), (k, n)))
        for name, mm in VARIANTS:
            ms = bench_ms(mm, x, y, iters=args.iters)
            rec = {"metric": "matmul_tflops", "m": m, "k": k, "n": n,
                   "variant": name,
                   "tflops": round(2.0 * m * n * k / (ms * 1e-3) / 1e12, 1),
                   "ms": round(ms, 3), "error": None, "device": where}
            print(json.dumps(rec), flush=True)
            records.append(rec)
        del x, y
    return records


if __name__ == "__main__":
    main()
