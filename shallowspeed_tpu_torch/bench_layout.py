"""Attention data-layout experiment, token-major vs head-major — the
port's counterpart of `scripts/bench_layout.py`, around the port's
flash core (`ops.flash_attention.flash_attention`: K1 forward, K2 and
K3 backward).

    python -m shallowspeed_tpu_torch.bench_layout [--batch 8
        --seq-len 2048 --n-heads 16 --head-dim 128 --steps 30
        --rounds 5] [--device cpu]

One attention sub-block, x + out_proj(attention(qkv_proj(x))), forward
and backward with respect to both projection weights, at the same
shapes and from the same weight bits in every variant; only where the
layout permutation sits differs:

- token_major: qkv = x @ Wqkv viewed (B, T, H, 3, hd); q, k and v are
  strided views the kernels read as they are; o (B, T, H, hd) viewed
  (B, T, D) into the out projection (the model's path).
- head_major: qkv = einsum('btd,dhxc->xbhtc', x, Wqkv as (D, H, 3, hd))
  (the weights carry the head split), the kernels read q, k and v as
  (B, T, H, hd) views of head-major memory; o enters
  einsum('bhtc,hcd->btd', o as (B, H, T, hd), Wo as (H, hd, D)).
- hm_qkv_only and hm_out_only: head-major on one side only.
- no_permute_lower_bound: deliberately wrong math, the qkv columns read
  as (3, H, hd) instead of (H, 3, hd): the same shapes and FLOPs with
  no permutation anywhere, the floor of what a layout can save.

The port's kernels read (B, T, H, hd) operands through their strides,
so no variant copies q, k or v for the kernel; what differs is where
the permutation lands among the projections and their gradients. A
variant's run is `--steps` steps, each the gradients and a 1e-6 step
on both weights (a dependency chain, as the reference's scan), then a
device synchronise; the variants interleave over `--rounds` rounds and
each keeps its best ms a step. Prints one JSON line a variant and the
verdict, with the reference's keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.ops.flash_attention import flash_attention


def build(args, device) -> dict:
    """{variant name: a function running `args.steps` steps, returning
    each step's probe (one element of the Wqkv gradient)}."""
    B, T, H, hd = args.batch, args.seq_len, args.n_heads, args.head_dim
    D = H * hd
    cdt = torch.bfloat16

    def core(q, k, v):
        return flash_attention(q, k, v, causal=True)

    def qkv_token(x, Wqkv):
        qkv = (x @ Wqkv.to(cdt)).view(B, T, H, 3, hd)
        return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

    def qkv_head(x, Wqkv):
        qkv = torch.einsum("btd,dhxc->xbhtc", x,
                           Wqkv.to(cdt).view(D, H, 3, hd))
        return tuple(qkv[i].transpose(1, 2) for i in range(3))

    def out_token(x, o, Wo):
        return x + o.reshape(B, T, D) @ Wo.to(cdt)

    def out_head(x, o, Wo):
        return x + torch.einsum("bhtc,hcd->btd", o.transpose(1, 2),
                                Wo.to(cdt).view(H, hd, D))

    def variant(qkv_of, out_of):
        return lambda x, Wqkv, Wo: out_of(x, core(*qkv_of(x, Wqkv)), Wo)

    def no_permute(x, Wqkv, Wo):
        qkv = (x @ Wqkv.to(cdt)).view(B, T, 3, H, hd)
        return out_token(x, core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
                         Wo)

    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((B, T, D))).to(device, cdt) \
        * 0.02
    Wqkv0 = torch.from_numpy(rng.standard_normal((D, 3 * D))).to(
        device, torch.float32) * 0.02
    Wo0 = torch.from_numpy(rng.standard_normal((D, D))).to(
        device, torch.float32) * 0.02

    def stepper(block):
        def run():
            Wqkv, Wo = Wqkv0, Wo0
            probes = []
            for _ in range(args.steps):
                Wqkv = Wqkv.detach().requires_grad_(True)
                Wo = Wo.detach().requires_grad_(True)
                loss = block(x0, Wqkv, Wo).float().sum()
                gq, go = torch.autograd.grad(loss, (Wqkv, Wo))
                with torch.no_grad():
                    Wqkv, Wo = Wqkv + 1e-6 * gq, Wo + 1e-6 * go
                probes.append(gq[0, 0])
            return torch.stack(probes)

        return run

    return {"token_major": stepper(variant(qkv_token, out_token)),
            "head_major": stepper(variant(qkv_head, out_head)),
            "hm_qkv_only": stepper(variant(qkv_head, out_token)),
            "hm_out_only": stepper(variant(qkv_token, out_head)),
            "no_permute_lower_bound": stepper(no_permute)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--n-heads", type=int, default=16)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Print the variants' lines and the verdict; return {variant: ms a
    step, "verdict": the verdict's dict}."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    runners = build(args, device)
    out = {}
    for name, run in runners.items():
        probes = run()           # warm-up and a finiteness probe
        if not bool(torch.isfinite(probes).all()):
            raise AssertionError(f"{name}: non-finite gradients {probes}")
        out[name] = float("inf")
    # the variants interleave over the rounds, so slow drift of the host
    # or the card hits each alike; each keeps its best round
    for _ in range(args.rounds):
        for name, run in runners.items():
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            out[name] = min(out[name],
                            (time.perf_counter() - t0) / args.steps)
    for name in out:
        out[name] = round(out[name] * 1e3, 3)
        print(json.dumps({"variant": name, "ms_per_step": out[name]}))
    best = min(out, key=out.get)
    ratio = out["token_major"] / out[best]
    verdict = {
        "metric": "attn_layout_speedup_best_vs_token_major",
        "best_variant": best,
        "value": round(ratio, 4),
        "verdict": (f"{best} wins" if best != "token_major"
                    and ratio > 1.01 else
                    "token_major holds (refutation measured)")}
    print(json.dumps(verdict))
    return {**out, "verdict": verdict}


if __name__ == "__main__":
    main()
