"""LM training driver of the PyTorch port: one device, synthetic data.
Counterpart of the root `train_lm.py`.

    python -m shallowspeed_tpu_torch.train_lm --steps 100 --bf16 --rope
    python -m shallowspeed_tpu_torch.train_lm --device cpu --steps 5

Trains `models.transformer` with `parallel.context.ContextParallelEngine`
on the reference's synthetic stream (a random 16-token motif repeated
per row, seeded per step), printing the reference's step lines
(`step N  loss L  tok/s R [T TF/s (M% MFU)]`) and, with `--log-file`,
its `"step"` JSONL events. `--attn flash` (the default) runs the
hand-written K1/K2/K3 kernels; `--attn ring` the plain attention under
torch autograd. Runs on the GPU unless `--device cpu` is given.

`--generate N` samples N tokens after training through the contiguous
`models.generate.generate` (int8 KV cache with `--kv-int8`; sampler
flags `--temperature --top-k --top-p`; a byte-level `--prompt` or a
16-token prefix of the synthetic stream) and prints the root driver's
`decode:`, `prompt:` and `sample:` lines, plus a `"generate"` event with
`--log-file`.

The root driver's other flags (multi-device meshes, text data,
checkpoints and `--sample-only`, remat, dropout, the telemetry and
health planes) are recognised and refused with `NotPorted`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted, resolve_device
from shallowspeed_tpu_torch.flops import mfu
from shallowspeed_tpu_torch.metrics import MetricsLogger, StepRates, step_event
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import (decode_report, generate,
                                                    prompt_bucket_len)
from shallowspeed_tpu_torch.optim import OPTIMIZERS, SCHEDULES
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

_MESH = "Queue 1, multi-device LM engines"
_TRAIN = "Queue 1, training features after slice 2"
_DATA = "Queue 1, data and checkpoint"
_PLANES = "Queue 1, planes"

# the root driver's flags this driver does not have yet, and where each
# comes from
UNPORTED = {
    **dict.fromkeys(
        ["--dp", "--pp", "--pp-schedule", "--virtual-pp", "--n-mubatches",
         "--sp", "--tp", "--ep", "--experts", "--moe-top-k",
         "--moe-capacity-factor", "--moe-routing", "--moe-z-weight",
         "--fsdp", "--zero1", "--zero2", "--overlap", "--bucket-mb",
         "--accum", "--platform", "--host-devices"], _MESH),
    **dict.fromkeys(
        ["--dropout", "--attn-dropout", "--remat", "--remat-policy",
         "--xent-chunk", "--ema-decay"], _TRAIN),
    **dict.fromkeys(
        ["--data-dir", "--text", "--tokenizer", "--vocab-size",
         "--save-dir", "--resume", "--auto-resume", "--save-every",
         "--keep-checkpoints", "--keep-last", "--async-save",
         "--prefetch", "--val-every", "--sample-only"], _DATA),
    **dict.fromkeys(
        ["--heartbeat-file", "--profile-dir", "--telemetry", "--health",
         "--trace-dir", "--monitor-port", "--replica", "--slo",
         "--flight-recorder", "--profile", "--profile-hz", "--chaos",
         "--chaos-state", "--chaos-seed"], _PLANES),
}


class _Refuse(argparse.Action):
    """Any use of an unported flag raises `NotPorted`."""

    def __call__(self, parser, namespace, values, option_string=None):
        raise NotPorted(f"train_lm {option_string}", UNPORTED[option_string])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="grouped-query attention: K/V head count (0 = MHA)")
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-ff", type=int, default=0,
                   help="FFN hidden width (0 = 4*d_model)")
    p.add_argument("--vocab", type=int, default=256,
                   help="vocabulary of the synthetic stream (the root "
                        "driver's byte-level default)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adam", choices=list(OPTIMIZERS))
    p.add_argument("--weight-decay", type=float, default=0.01,
                   help="decoupled weight decay (adamw)")
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--lr-schedule", default="constant",
                   choices=list(SCHEDULES))
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-end", type=float, default=0.0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, float32 master weights and "
                        "optimizer state")
    p.add_argument("--rope", action="store_true")
    p.add_argument("--norm", default="layernorm",
                   choices=["layernorm", "rmsnorm"])
    p.add_argument("--ffn", default="gelu", choices=["gelu", "swiglu"])
    p.add_argument("--attn", default="flash",
                   choices=["flash", "ring", "ring-flash", "ulysses",
                            "ulysses-flash"],
                   help="flash = the K1/K2/K3 kernels; ring = plain "
                        "attention (what the root driver's ring is at "
                        "sp=1); the sequence-parallel substrates raise "
                        "NotPorted")
    p.add_argument("--attn-window", type=int, default=0)
    p.add_argument("--tie-embeddings", action="store_true")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--logit-softcap", type=float, default=0.0)
    p.add_argument("--generate", type=int, default=0,
                   help="after training, sample this many tokens from the "
                        "model (KV-cache decode) and print them")
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling: keep the smallest probability "
                        "mass >= p (0 = off; composes with --top-k)")
    p.add_argument("--kv-int8", action="store_true",
                   help="decode with an int8 KV cache (f32 per-position "
                        "scales); streams are deterministic but not "
                        "bit-equal to the compute-dtype cache")
    p.add_argument("--prompt", type=str, default="",
                   help="UTF-8 prompt for --generate (byte-level; default: "
                        "a 16-token prefix of the synthetic stream)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--log-file", type=str, default="")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", action=_Refuse,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.prompt and not args.generate:
        args.generate = 128          # --prompt implies sampling
    prompt_len = len(args.prompt.encode()) if args.prompt else 16
    if args.prompt and args.vocab < 256:
        raise SystemExit(f"--prompt is byte-level and needs --vocab >= 256, "
                         f"got {args.vocab}")
    if args.generate and args.generate + prompt_len > args.seq_len:
        raise SystemExit(f"--generate {args.generate} + the {prompt_len}-"
                         f"token prompt exceeds --seq-len {args.seq_len} "
                         f"(= max_seq)")
    return args


def make_batch(args, vocab: int, step: int):
    """(tokens, targets) (B, T) int32 batch for `step`: the root
    driver's synthetic stream, seeded per (seed, step) — a random
    16-token motif repeated along each row, targets the next token."""
    b, t = args.batch_size, args.seq_len
    rng = np.random.default_rng([args.seed, step])
    motif = rng.integers(0, vocab, (b, 16))
    tok = np.tile(motif, (1, t // 16 + 1))[:, :t].astype(np.int32)
    tgt = np.roll(tok, -1, axis=1).astype(np.int32)
    return tok, tgt


def build(args):
    """(config, optimizer) from the parsed flags, as the root driver
    builds them."""
    cfg = T.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.seq_len,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        d_ff=args.d_ff, rope=args.rope, norm=args.norm, ffn=args.ffn,
        n_kv_heads=args.kv_heads, tie_embeddings=args.tie_embeddings,
        label_smoothing=args.label_smoothing,
        logit_softcap=args.logit_softcap, attn_window=args.attn_window)
    if args.lr_schedule == "constant":
        lr = args.lr    # a static float keeps SGD stateless
    else:
        lr = SCHEDULES[args.lr_schedule](
            peak=args.lr, warmup=args.warmup_steps, total=args.steps,
            end=args.lr_end)
    kw = {"grad_clip": args.grad_clip or None}
    if args.optimizer == "adamw":
        kw["weight_decay"] = args.weight_decay
    return cfg, OPTIMIZERS[args.optimizer](lr=lr, **kw)


def train(args) -> float:
    """Run the configured training; returns the last logged loss."""
    device = resolve_device(args.device)
    cfg, opt = build(args)
    engine = ContextParallelEngine(cfg, opt, seed=args.seed, attn=args.attn,
                                   device=device)
    metrics = MetricsLogger(args.log_file, kind="train_lm",
                            d_model=cfg.d_model, n_layers=cfg.n_layers,
                            attn=args.attn, device=str(device))
    rates = StepRates(args.batch_size * args.seq_len)
    dtype = "bf16" if args.bf16 else "f32"
    loss, last = float("nan"), -1
    try:
        for step in range(args.steps):
            tok, tgt = make_batch(args, cfg.vocab, step)
            loss = engine.train_batch(tok, tgt)   # syncs with the device
            if not np.isfinite(loss):
                raise SystemExit(f"loss became non-finite ({loss}) at step "
                                 f"{step}; try --grad-clip, a lower --lr, "
                                 f"or --lr-schedule with --warmup-steps")
            if step % args.log_every == 0 or step == args.steps - 1:
                r = rates.log_point(step - last)
                last = step
                perf = mfu(r["tokens_per_sec"], cfg, args.seq_len, dtype,
                           device=device)
                cum = mfu(r["tokens_per_sec_cum"], cfg, args.seq_len, dtype,
                          device=device)
                mfu_txt = ("" if perf["mfu"] is None else
                           f"  {perf['tflops']:.1f} TF/s "
                           f"({perf['mfu'] * 100:.1f}% MFU)")
                print(f"step {step:5d}  loss {loss:.4f}  "
                      f"tok/s {r['tokens_per_sec']:,.0f}{mfu_txt}",
                      flush=True)
                metrics.log(**step_event(step, loss, r, perf, cum))
        if args.generate > 0:
            sample_and_print(args, engine, cfg, metrics)
    finally:
        metrics.close()
    return loss


def sample_and_print(args, engine, cfg, metrics=None):
    """Decode `args.generate` tokens from the trained parameters through
    the contiguous `generate`, after a byte-level `--prompt` or a
    16-token prefix of the synthetic stream, and print the root
    driver's decode, prompt and sample lines (the rate includes the
    prefill and, on the card, the kernels' first-use build)."""
    if args.prompt:
        prompt = np.frombuffer(args.prompt.encode(), np.uint8).astype(
            np.int32)[None, :]
    else:
        prompt = make_batch(args, cfg.vocab, 0)[0][:1, :16]
    params = engine.get_canonical_params()
    kvq = "int8" if args.kv_int8 else ""
    t0 = time.time()
    out = generate(params, prompt, cfg, args.generate,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, seed=args.seed, kv_quant=kvq)
    dt = time.time() - t0
    cache_len = prompt_bucket_len(prompt.shape[1], args.generate,
                                  cfg.max_seq) + args.generate
    rep = decode_report(params, cfg, prompt.shape[0], cache_len,
                        args.generate, dt, kv_quant=kvq)
    util = ("" if rep["hbm_util"] is None else
            f"  ({rep['hbm_util']:.0%} of the "
            f"{rep['hbm_peak_gbps']:,.0f} GB/s HBM roofline)")
    print(f"decode: {rep['tokens_per_sec']:,.0f} tok/s  "
          f"~{rep['bytes_per_token'] / 2**20:.1f} MiB/token sweep "
          f"-> {rep['hbm_gbps']:.1f} GB/s{util} [includes prefill]",
          flush=True)
    if metrics is not None:
        metrics.log(event="generate", **rep)
    print(f"prompt: {_show(prompt[0])}")
    print(f"sample: {_show(out[0])}", flush=True)
    return out


def _show(ids) -> str:
    """Token ids as the bytes they stand for (byte-level vocab), or as
    the id list where an id lies past 255."""
    ids = [int(x) for x in ids]
    return repr(bytes(ids)) if max(ids) < 256 else str(ids)


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
