"""LM training driver of the PyTorch port. Counterpart of the root
`train_lm.py`.

    python -m shallowspeed_tpu_torch.train_lm --steps 100 --bf16 --rope
    python -m shallowspeed_tpu_torch.train_lm --device cpu --steps 5
    python -m shallowspeed_tpu_torch.train_lm --data-dir shards/ \
        --save-dir ck --save-every 100 --val-every 50 [--resume]

Trains `models.transformer` with `parallel.context.ContextParallelEngine`
on the reference's synthetic stream (a random 16-token motif repeated
per row, seeded per step), on a text file (`--text`, byte-level or
`--tokenizer bpe`), or on a token-shard corpus (`--data-dir`, built by
`build_token_shards`), printing the reference's step lines
(`step N  loss L  tok/s R [T TF/s (M% MFU)]`) and, with `--log-file`,
its `"step"` JSONL events. Every batch is a pure function of (seed,
step), built `--prefetch` steps ahead on a background thread. `--attn
flash` (the default at --sp 1) runs the hand-written K1/K2/K3 kernels;
`--attn ring` the plain attention under torch autograd. Runs on the
GPU unless `--device cpu` is given.

`--dp D --sp S` train over a (dp, sp) grid of that one device
(`parallel.mesh.make_context_mesh`): D replicas, each its B/D rows,
each sequence cut into S tiles for the attention substrate: `--attn
ring` (plain ring attention), `ring-flash` (the default at --sp > 1:
K1/K2/K3 on every hop), `ulysses` / `ulysses-flash` (the all-to-all;
heads divisible by S). `--zero1` / `--zero2` shard the optimizer state
(and with --zero2 the gradient) over the dp cells; `--accum` divides
each replica's rows. The root driver's checks hold (--zero2 subsumes
--zero1, batch % dp, seq_len % sp, --attn flash only at sp 1,
--attn-dropout only at sp 1 with ring).

The GSPMD engine family takes the root driver's flags and its engine
choice: `--tp T` Megatron tensor parallelism over a (dp, tp) grid
(`parallel.tensor.TensorParallelEngine`), `--fsdp` ZeRO-3 over a (dp,)
grid (`parallel.fsdp.FSDPEngine`), `--sp S --tp T` or `--fsdp` with
--sp/--tp the (dp, sp, tp) composite (`parallel.composite.
Composite3DEngine`, ZeRO-3 over tp with --fsdp), and `--experts E
[--ep P]` at any --dp/--sp (`parallel.expert.ExpertParallelEngine` over
(dp, ep) or (dp, sp, ep)). These engines run the plain attention (the
root's "XLA attention": --attn ring, the default with them), with the
root driver's checks and messages.

`--val-every N` prints `step N  val_loss L  ppl P` on held-out data.
`--save-dir` checkpoints every `--save-every` steps and at the end
(`checkpoint.save`, or `AsyncSaver` with `--async-save`; rotation with
`--keep-last`); `--resume` restores the newest verified checkpoint
(quarantining corrupt ones), `--auto-resume` does so when one exists,
and `--sample-only` restores and samples without training.
`--ema-decay` keeps an average of the weights that validation and
sampling use and checkpoints carry (`ema.npz`).

`--generate N` samples N tokens after training through the contiguous
`models.generate.generate` (int8 KV cache with `--kv-int8`; sampler
flags `--temperature --top-k --top-p`; a `--prompt`, byte-level or
through the BPE tokenizer, or a 16-token prefix of the training stream)
and prints the root driver's `decode:`, `prompt:` and `sample:` lines,
plus a `"generate"` event with `--log-file`.

The one-device training features take the root driver's flags:
`--accum`, `--remat --remat-policy`, `--xent-chunk`, `--dropout`,
`--attn-dropout`, `--optimizer adafactor` (with `--weight-decay`), and
`--experts` with `--moe-top-k --moe-capacity-factor --moe-routing
--moe-z-weight` (`parallel.expert.ExpertParallelEngine`, which prints the root driver's `moe drop ... load ...` line and logs
its `"moe_router"` event at log points). `--experts` and
`--attn-dropout` run the plain attention, as the root driver does at
sp 1: without `--attn` they take it, and `--attn flash` with either
exits as the root driver does. The 1.21B LM's recipe on the card:

    python -m shallowspeed_tpu_torch.train_lm --vocab 32768 \
        --d-model 2048 --n-heads 16 --n-layers 16 --d-ff 8192 \
        --seq-len 2048 --batch-size 4 --rope --norm rmsnorm \
        --ffn swiglu --bf16 --optimizer adafactor --lr 3e-4 \
        --remat --remat-policy dots --xent-chunk 1024

`--health monitor|guard` computes the health pack on the device every
step; each log point fetches it, runs the anomaly detector, prints its
verdicts and carries the `health_*` fields on the step line; an
`abort` verdict exits (after a forensic save under `--save-dir`), and
a checkpoint of an unhealthy state is skipped. Under guard an update
with non-finite gradients is skipped bit for bit.

`--pp P [--tp T | --sp S | --ep E] [--dp D] --pp-schedule gpipe|1f1b|zb
--n-mubatches M --virtual-pp V` trains over a (dp, pp) or (dp, pp, X)
grid with `parallel.pipeline_lm.PipelineLMEngine` (`--attn ring`, the
default with --pp, is the plain attention; `--attn flash` the
K1/K2/K3 kernels; under --sp `--attn ring`, `ring-flash` or
`ulysses-flash` cuts each stage's attention over the sp cells),
interleaved virtual stages with V > 1, MoE with --experts (its experts
cut over --ep), with --zero1/--zero2/--fsdp at dp > 1 and the root
driver's checks; `--generate` then decodes through the pipelined decode
(also at V > 1; except under --tp, --sp, --ep, --fsdp or --kv-int8, as
the root driver routes it).

`--overlap on [--bucket-mb MB]` moves the dp gradient reduction into
the backward, bucket by bucket (`parallel.overlap`), in the context
engine (any --zero level, --accum) and pure --fsdp (which also gathers
each block one block ahead); the other layouts refuse it with the root
driver's message. On the CPU the hooks add in hook order, on a GPU on a
side stream; either way the step equals overlap off bit for bit.

Launched once per process with the reference's variables
(`JAX_COORDINATOR_ADDRESS` host:port, `JAX_NUM_PROCESSES`,
`JAX_PROCESS_ID`), `distributed.initialize` runs first and the grids
are cut from the processes' cells (`parallel.mesh`: the leftmost axis
spans the processes first), e.g. two processes of

    JAX_COORDINATOR_ADDRESS=localhost:29500 JAX_NUM_PROCESSES=2 \
    JAX_PROCESS_ID=<0|1> python -m shallowspeed_tpu_torch.train_lm \
        --device cpu --dp 2 --pp 2 --steps 20

The layouts that run as processes, one cell a process unless stated:
`--dp N` (dp across the processes), `--sp 2 --attn
ring|ring-flash|ulysses|ulysses-flash` as two processes (each sp cell
runs the model on its own tile; the substrate's K/V hops or all-to-alls
cross between them), `--dp 2 --sp 2 [--zero1|--zero2] [--accum 2]` as
four processes, or as two (dp across them, sp inside each), `--pp 2
[--dp 2]` and `--pp 2 --sp 2 --attn ring-flash|ulysses-flash` as four
processes (or two: a stage and its sp cells on each); the GSPMD layouts
`--tp 2` (one tp cell a process: Megatron's all-reduces cross between
them), `--dp 2 --fsdp` (each dp piece gathered from its process),
`--dp D --sp S --tp T` and `--experts E --ep 2`, and `--pp 2` with
`--tp`, `--ep` or `--fsdp`; clipping and Adafactor compose with ZeRO
there too, and so do `--health monitor|guard` (one pack, one guard
decision and so one save gate in every process), `--overlap on` (the
context engine's and FSDP's buckets sent between the processes while
the backward runs) and `--pp 2 --generate N` (the pipelined decode
across the processes; process 0 prints the sample). Every process
builds the same seeded batch; an engine trains on the rows of the
replicas its cells belong to (`local_batch`: the process's
`local_rows` where dp spans the processes, the whole batch
where sp, tp or ep does), the pipeline on the whole batch (each process
runs its own stages and lanes). Process 0 alone prints and writes the
JSONL log; the loss is the one-process run's bit for bit. Checkpoints are written by
process 0 after a collective fetch, and a failed synchronous save
raises instead of being skipped.

`--telemetry steps|spans` traces the engine's spans (`telemetry.trace`:
"step", and "grads" / "update" where the reference splits the step;
`spans` fences each on the device) and puts the telemetry fields on
every step line (allocated device memory and its peak, the per-owner
bytes of "train.params" and "train.opt_state", host RSS, the step's
counted collective bytes per axis; `telemetry.report.RunTelemetry`);
`--trace-dir D` (implies `steps`) writes `spans.jsonl`, `trace.json`
and `telemetry.json` there (under several processes each process into
`D/p<index>`). `--profile-dir D` captures the loop's CPU and CUDA
activity with `torch.profiler` into a Chrome trace per process;
`--profile host [--profile-hz N]` runs the host sampling profiler,
whose "profile" snapshots go to `--log-file` (`host+device` also
captures a device trace in each triggered window). At `spans` the step
lines carry the `attrib_*` waterfall (`telemetry.attribution`: the
first step counted under a dispatch mode, priced at the card's peaks),
and a pipeline's first log point with two fenced steps behind it
calibrates the measured bubble (`telemetry.bubble.calibrate_compiled`:
a `"bubble"` event and the `bubble measured ... vs static ...` line;
the static bubble rides every step line from the start).

The goodput ledger (`telemetry.goodput`) stamps init, restore, val,
ckpt_save, data stalls, the calibration, failed and skipped saves and
guarded skipped steps into `--log-file` as `"ledger"` lines; `python
-m shallowspeed_tpu_torch.telemetry --goodput m.jsonl` reduces them.
`--monitor-port P --slo SPEC --flight-recorder N` run the live monitor
(`telemetry.monitor`): every logged line feeds its sketches and SLO
burn-rate alerts (`"alert"` events, periodic `"monitor"` snapshots),
the endpoint serves /status.json (with the health monitor's heartbeat
status under --health) and /metrics, and an anomaly verdict, a
divergence or an alert dumps the flight recorder's ring next to the
log.

Supervision (`elastic`, `chaos`): SIGTERM exits through the finally
blocks (the supervisor's grace window); `--chaos PLAN` (or the plan a
supervisor exports; `--chaos-state`, default `<save-dir>/.chaos`;
`--chaos-seed`) fires its faults at the reference's points: a stall in
the batch producer (with `--prefetch > 0` the prefetcher may absorb
it), kill / poison / freeze at the top of a step, the save faults in
`checkpoint`; each stamps a `"fault"` line into `--log-file`, feeds the
live monitor and arms the profiler's capture, and faults that never
fired are named at a clean exit. `--heartbeat-file` is written at every
log point with the health monitor's status (a `freeze` fault stops
it); `--replica` labels the log's run_start line. Under the supervisor:

    python -m shallowspeed_tpu_torch.elastic --max-restarts 4 \
        --chaos 'kill@9,corrupt@2,stall@5:0.3' --chaos-state ck/.chaos \
        -- python -m shallowspeed_tpu_torch.train_lm --device cpu \
        --steps 14 --save-dir ck --save-every 4 --auto-resume \
        --log-file m.jsonl

`--platform` and `--host-devices` give way to `--device` (`NotPorted`).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted, chaos, checkpoint
from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.data import (ByteBPE, TokenShards, ValSplit,
                                         place_on, prefetch_to_device,
                                         sync_every, train_bpe)
from shallowspeed_tpu_torch.flops import mfu
from shallowspeed_tpu_torch.metrics import MetricsLogger, StepRates, step_event
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import (decode_report, generate,
                                                    prompt_bucket_len)
from shallowspeed_tpu_torch.optim import (OPTIMIZERS, SCHEDULES, ema_init,
                                          ema_update)
from shallowspeed_tpu_torch.parallel.composite import Composite3DEngine
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine
from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine
from shallowspeed_tpu_torch.parallel.mesh import (make_3d_mesh,
                                                  make_context_mesh,
                                                  make_ep_mesh,
                                                  make_fsdp_mesh,
                                                  make_pipeline_mesh,
                                                  make_tp_mesh)
from shallowspeed_tpu_torch.parallel.overlap import from_flags
from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine
from shallowspeed_tpu_torch.parallel.tensor import TensorParallelEngine
from shallowspeed_tpu_torch.telemetry.anomaly import GuardPolicy
from shallowspeed_tpu_torch.telemetry.bubble import (calibrate_compiled,
                                                     static_bubble)
from shallowspeed_tpu_torch.elastic import install_sigterm_exit, terminating
from shallowspeed_tpu_torch.telemetry.driver import (add_chaos_flags,
                                                     add_telemetry_flags,
                                                     beat, owners_of,
                                                     report_unfired,
                                                     setup_chaos,
                                                     start_monitor,
                                                     start_telemetry,
                                                     stop_monitor,
                                                     stop_telemetry,
                                                     telemetry_line)
from shallowspeed_tpu_torch.telemetry.goodput import GoodputLedger
from shallowspeed_tpu_torch.telemetry.health import HealthMonitor
from shallowspeed_tpu_torch.telemetry.profiler import device_trace_ctx
from shallowspeed_tpu_torch.telemetry.trace import tracer
from shallowspeed_tpu_torch.utils import rprint
from shallowspeed_tpu_torch.weights import map_tree

_DEVICE = "--device replaces it: every cell of the grid runs there"

# the root driver's flags this driver does not have yet, and where each
# comes from
UNPORTED = dict.fromkeys(["--platform", "--host-devices"], _DEVICE)


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
                        "driver's byte-level default); --text and "
                        "--data-dir take theirs from the data")
    p.add_argument("--data-dir", type=str, default="",
                   help="token-shard corpus directory (build_token_shards):"
                        " streams windows off disk in a resumable order, "
                        "with the held-out val.bin split")
    p.add_argument("--text", type=str, default="",
                   help="train on this UTF-8 text file (byte-level vocab, "
                        "or subword with --tokenizer bpe)")
    p.add_argument("--tokenizer", default="byte", choices=["byte", "bpe"],
                   help="text tokenization: raw bytes (vocab 256) or "
                        "byte-level BPE trained on --text to --vocab-size "
                        "(saved/restored with --save-dir)")
    p.add_argument("--vocab-size", type=int, default=512,
                   help="BPE target vocabulary (--tokenizer bpe)")
    p.add_argument("--health", default="off",
                   choices=["off", "monitor", "guard"],
                   help="monitor: the health pack (grad/param norms, "
                        "update ratio, non-finite sentinel) every step, "
                        "the anomaly detector over the step lines; "
                        "guard: monitor + skip any update with "
                        "non-finite gradients bit for bit")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adam", choices=list(OPTIMIZERS))
    p.add_argument("--weight-decay", type=float, default=0.01,
                   help="decoupled weight decay (adamw/adafactor)")
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
    p.add_argument("--dp", type=int, default=1, help="data-parallel degree")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel degree over the transformer "
                        "blocks (needs n_layers %% pp == 0)")
    p.add_argument("--pp-schedule", choices=["gpipe", "1f1b", "zb"],
                   default="gpipe",
                   help="pipeline schedule: gpipe (all forwards, then "
                        "the backward in reverse), 1f1b (PipeDream-Flush:"
                        " a min(pp, n_mu) stage-input stash, each "
                        "backward recomputes its stage), or zb (ZB-H1: "
                        "split B/W backward on stashed residuals)")
    p.add_argument("--virtual-pp", type=int, default=1,
                   help="interleaved virtual stages per device (only 1 "
                        "is ported)")
    p.add_argument("--n-mubatches", type=int, default=4,
                   help="microbatches per batch in the pipeline (--pp > 1)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence/context-parallel degree (the attention "
                        "substrate's tiles)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the optimizer state over the dp "
                        "cells (1/dp of the moments each)")
    p.add_argument("--zero2", action="store_true",
                   help="ZeRO-2: ZeRO-1 plus dp-sharded gradients (a "
                        "reduce-scatter; 1/dp of the gradient each)")
    p.add_argument("--overlap", default="off", choices=["off", "on"],
                   help="comm/compute interleaving (parallel.overlap): "
                        "the dp gradient reduction moves into the "
                        "backward, one size-targeted bucket at a time "
                        "(with --accum the last microbatch's backward "
                        "folds the earlier ones in); --fsdp also gathers "
                        "each block one block ahead. Context engine (any "
                        "--zero level) and pure --fsdp; bit for bit the "
                        "bulk reduction's step")
    p.add_argument("--bucket-mb", type=float, default=4.0,
                   help="with --overlap on: target bytes per reduction "
                        "bucket (MiB)")
    p.add_argument("--attn", default=None,
                   choices=["flash", "ring", "ring-flash", "ulysses",
                            "ulysses-flash"],
                   help="flash (the default at --sp 1) = the K1/K2/K3 "
                        "kernels; ring = plain attention (ring attention "
                        "at --sp > 1; the default with --experts or "
                        "--attn-dropout); ring-flash (the default at --sp "
                        "> 1) = the ring with K1/K2/K3 on every hop; "
                        "ulysses / ulysses-flash = the all-to-all, needs "
                        "heads divisible by --sp")
    p.add_argument("--accum", type=int, default=1,
                   help="gradient accumulation: split each batch into N "
                        "sequential microbatches (activation memory of "
                        "one microbatch, same gradient)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize each block's activations in the "
                        "backward instead of storing them")
    p.add_argument("--remat-policy", default="full",
                   choices=["full", "attn", "dots"],
                   help="what --remat SAVES per block: full = nothing "
                        "(the backward reruns the block, K1 included), "
                        "attn = the attention output (K1 never reruns), "
                        "dots = every dense product's output too "
                        "(elementwise-only recompute)")
    p.add_argument("--xent-chunk", type=int, default=0,
                   help="chunked cross-entropy: the loss over this many "
                        "positions at a time, never the whole (B*T, "
                        "vocab) logits; 0 = whole-batch log-softmax")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="dropout rate on embeddings and attention/FFN "
                        "outputs; training steps only")
    p.add_argument("--attn-dropout", type=float, default=0.0,
                   help="attention-probability dropout; the plain "
                        "attention only (--attn ring)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (Megatron placement); "
                        "composes with --sp on a (dp, sp, tp) grid")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3/FSDP: shard params, grads and optimizer "
                        "state over the dp cells; stacks onto --sp/--tp "
                        "via the 3-D composite engine")
    p.add_argument("--ep", type=int, default=1,
                   help="expert-parallel degree (requires --experts > 0); "
                        "composes with --dp, and with --sp on a (dp, sp, "
                        "ep) grid")
    p.add_argument("--experts", type=int, default=0,
                   help="number of MoE experts per block (0 = dense FFN)")
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-capacity-factor", type=float, default=2.0,
                   help="expert buffer slots = cf * top_k * tokens / E")
    p.add_argument("--moe-routing", default="sequence",
                   choices=["sequence", "priority"],
                   help="expert slot assignment: sequence order (GShard) "
                        "or batch priority (V-MoE)")
    p.add_argument("--moe-z-weight", type=float, default=0.0,
                   help="router z-loss weight (0 = off)")
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
                   help="UTF-8 prompt for --generate (byte-level, or "
                        "through the BPE tokenizer; default: a 16-token "
                        "prefix of the training stream)")
    p.add_argument("--sample-only", action="store_true",
                   help="skip training: restore --save-dir's latest "
                        "checkpoint and just --generate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--log-file", type=str, default="")
    p.add_argument("--ema-decay", type=float, default=0.0,
                   help="keep an exponential moving average of the "
                        "weights (e.g. 0.999); validation and sampling "
                        "use the averaged weights, checkpoints carry "
                        "them (0 = off)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="input-pipeline depth: batches built and placed on "
                        "the device this many steps ahead on a background "
                        "thread (0 = synchronous)")
    p.add_argument("--async-save", action="store_true",
                   help="write checkpoints on a background thread: the "
                        "device->host snapshot is synchronous (pins the "
                        "state), the file IO never blocks training")
    p.add_argument("--keep-checkpoints", "--keep-last", type=int,
                   default=0, dest="keep_checkpoints",
                   help="checkpoint rotation: keep only the N newest "
                        "ckpt_* dirs (0 = keep all); the newest verified "
                        "one is never deleted")
    p.add_argument("--save-every", type=int, default=100,
                   help="checkpoint every N steps when --save-dir is set")
    p.add_argument("--save-dir", type=str, default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the latest checkpoint if one exists, "
                        "start fresh otherwise")
    p.add_argument("--val-every", type=int, default=0,
                   help="every N steps evaluate held-out loss/perplexity "
                        "(--text: last 10%% of the file; --data-dir: its "
                        "val.bin; synthetic: a disjoint seed stream)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    add_telemetry_flags(p)
    add_chaos_flags(p)
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", action=_Refuse,
                       help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    _check_features(args)
    _check_pipeline(args)
    _check_mesh(args)
    if (args.prompt or args.sample_only) and not args.generate:
        args.generate = 128          # --prompt/--sample-only imply sampling
    prompt_len = len(args.prompt.encode()) if args.prompt else 16
    if (args.prompt and args.vocab < 256 and not args.text
            and not args.data_dir):
        raise SystemExit(f"--prompt is byte-level and needs --vocab >= 256, "
                         f"got {args.vocab}")
    if args.generate and args.generate + prompt_len > args.seq_len:
        raise SystemExit(f"--generate {args.generate} + the {prompt_len}-"
                         f"token prompt exceeds --seq-len {args.seq_len} "
                         f"(= max_seq)")
    if (args.resume or args.sample_only or args.auto_resume) \
            and not args.save_dir:
        raise SystemExit(
            "--resume/--auto-resume/--sample-only require --save-dir")
    if args.keep_checkpoints < 0:
        raise SystemExit("--keep-checkpoints takes 0 (keep all) or a "
                         "positive count")
    if args.save_every < 1 or args.log_every < 1:
        raise SystemExit("--save-every and --log-every take a positive "
                         "count")
    if not 0.0 <= args.ema_decay < 1.0:
        raise SystemExit(f"--ema-decay must be in [0, 1), got "
                         f"{args.ema_decay} (1.0 would freeze the average "
                         f"at the initial weights)")
    return args


def _check_features(args) -> None:
    """The root driver's guards on the one-device training features,
    and the attention substrate they take: the plain one ("ring") with
    --experts or --attn-dropout, the K1/K2/K3 kernels otherwise."""
    if args.accum < 1:
        raise SystemExit(f"--accum must be >= 1, got {args.accum}")
    if args.accum > 1 and (args.tp > 1 or args.ep > 1 or args.experts
                           or args.fsdp or args.pp > 1):
        raise SystemExit("--accum composes with --dp/--sp (the context "
                         "engine) for now; the pipeline engine already "
                         "microbatches via --n-mubatches")
    if args.experts and args.moe_top_k > args.experts:
        raise SystemExit(f"--moe-top-k {args.moe_top_k} cannot exceed "
                         f"--experts {args.experts}")
    plain = (args.experts or args.attn_dropout > 0.0 or args.tp > 1
             or args.fsdp or args.pp > 1)
    if args.attn is None:
        args.attn = ("ring" if plain else "ring-flash" if args.sp > 1
                     else "flash")
    if args.attn_dropout > 0.0 and (args.pp > 1 or args.sp > 1
                                    or args.attn != "ring"):
        raise SystemExit("--attn-dropout needs the plain attention "
                         "substrate (no --pp/--sp>1, --attn ring)")
    if args.experts and args.pp <= 1 and args.attn != "ring":
        raise SystemExit(f"--attn {args.attn} is not available with "
                         "--experts (the MoE engine uses the plain "
                         "attention)")


def _check_pipeline(args) -> None:
    """The root driver's checks on --pp, with its messages."""
    if args.pp < 1 or args.n_mubatches < 1 or args.virtual_pp < 1:
        raise SystemExit(f"--pp, --n-mubatches and --virtual-pp take a "
                         f"positive count, got {args.pp}, "
                         f"{args.n_mubatches} and {args.virtual_pp}")
    if args.pp <= 1:
        return
    if (args.zero1 or args.zero2 or args.fsdp) and args.dp < 2:
        raise SystemExit("--pp with --zero1/--zero2/--fsdp shards over "
                         "dp; need --dp >= 2")
    if (args.zero2 or args.fsdp) and args.ep > 1:
        raise SystemExit("--pp with --zero2/--fsdp takes a "
                         "('dp','pp'[,'tp'|'sp']) mesh (no --ep: "
                         "expert-leaf grads are ep-sharded, outside "
                         "the per-leaf ZeRO scatter rule)")
    if sum(a > 1 for a in (args.tp, args.sp, args.ep)) > 1:
        raise SystemExit("--pp takes ONE extra model axis: --tp, --sp, "
                         "or --ep")
    if args.virtual_pp > 1 and args.ep > 1:
        raise SystemExit("--virtual-pp needs collective-free chunk "
                         "bodies (no --ep all-to-all inside a "
                         "cond-gated chunk)")
    if args.experts and args.tp > 1:
        raise SystemExit("--experts with --pp composes with --dp/--sp/"
                         "--ep (not --tp)")
    if args.sp > 1 and args.attn not in ("ring", "ring-flash",
                                         "ulysses-flash"):
        raise SystemExit(f"--pp with --sp needs a sequence-parallel "
                         f"attention substrate (--attn ring, ring-flash "
                         f"or ulysses-flash), got {args.attn}")
    if args.sp == 1 and args.attn not in ("ring", "flash"):
        raise SystemExit(f"--attn {args.attn} is not available with --pp "
                         "(XLA attention by default, or the fused Pallas "
                         "kernel via --attn flash)")
    if args.pp_schedule == "zb":
        if any(a > 1 for a in (args.tp, args.sp, args.ep)):
            raise SystemExit("--pp-schedule zb runs on a ('dp','pp') "
                             "mesh (no --tp/--sp/--ep: collectives "
                             "inside the per-round switch de-sync)")
        if args.virtual_pp > 1:
            raise SystemExit("--pp-schedule zb needs --virtual-pp 1 "
                             "(per-chunk B/W tables are not built)")
        if args.experts:
            raise SystemExit("--pp-schedule zb needs the dense block "
                             "family (no --experts)")
        if args.dropout > 0.0 or args.attn_dropout > 0.0:
            raise SystemExit("--pp-schedule zb trains without dropout "
                             "(the hand-split backward does not thread "
                             "mask keys F->B)")
        if args.remat:
            raise SystemExit("--pp-schedule zb IS the no-recompute "
                             "schedule (it stashes residuals F->B); "
                             "drop --remat")


def _check_mesh(args) -> None:
    """The root driver's checks on the grid, with its messages where it
    gives one."""
    if min(args.dp, args.sp, args.tp, args.ep, args.pp) < 1:
        raise SystemExit(f"--dp, --sp, --tp and --ep take a positive "
                         f"degree, got {args.dp}, {args.sp}, {args.tp} and "
                         f"{args.ep}")
    if args.ep > 1 and args.tp > 1:
        raise SystemExit("--ep composes with --dp/--sp (not --tp)")
    if args.fsdp and (args.ep > 1 or args.experts or args.zero1
                      or args.zero2):
        raise SystemExit("--fsdp composes with --dp/--sp/--tp/--pp (and "
                         "already subsumes --zero1/--zero2; MoE uses --ep)")
    if args.zero1 and args.zero2:
        raise SystemExit("--zero2 subsumes --zero1; pick one")
    if args.overlap != "off" and (
            args.pp > 1 or args.tp > 1 or args.ep > 1 or args.experts
            or (args.fsdp and (args.sp > 1 or args.tp > 1))):
        raise SystemExit(
            "--overlap on supports the context engine (--dp/--sp, any "
            "--zero level, --accum) and pure --fsdp; the GSPMD tp/ep/"
            "composite engines schedule compiler-inserted collectives "
            "and the LM pipeline keeps its own hop schedule")
    if ((args.fsdp or args.tp > 1) and args.pp <= 1
            and args.attn != "ring"):
        raise SystemExit(f"--attn {args.attn} is not available with "
                         "--tp/--fsdp (the GSPMD engines use XLA attention; "
                         "under --sp the composite engine's context "
                         "parallelism is the K/V all-gather formulation)")
    if args.ep > 1 and args.experts == 0:
        raise SystemExit("--ep requires --experts > 0")
    if args.experts and args.tp > 1:
        raise SystemExit("--experts composes with --dp/--sp/--ep (not "
                         "--tp) for now")
    if args.attn == "flash" and args.sp > 1:
        raise SystemExit("--attn flash requires sp=1 (use ring)")
    if args.batch_size % args.dp:
        raise SystemExit(f"--batch-size {args.batch_size} does not split "
                         f"over --dp {args.dp}")
    if args.seq_len % args.sp:
        raise SystemExit(f"--seq-len {args.seq_len} does not split over "
                         f"--sp {args.sp}")


def prepare_text(args):
    """(vocab, tokenizer, train data, val data) of the configured
    stream, as the root driver prepares them. Shards: vocab and
    tokenizer come from the shard directory, the data is the
    `TokenShards` view and its `ValSplit`. Text: byte ids (vocab 256),
    or a ByteBPE trained on the training split (or the one saved under
    --save-dir, on --resume/--sample-only), with the last 10% held out
    when --val-every is set. Synthetic: (args.vocab, None, None, None).
    Runs before the model config is built: the data fixes the vocab."""
    if args.data_dir:
        if args.text:
            raise SystemExit("--data-dir replaces --text (the shard "
                             "index already fixes the token stream)")
        shards = TokenShards(args.data_dir, args.seq_len)
        tokenizer = None
        tok_path = Path(args.data_dir) / "tokenizer.json"
        if tok_path.exists():
            tokenizer = ByteBPE.load(tok_path)
            if tokenizer.vocab_size != shards.vocab:
                raise SystemExit(
                    f"{tok_path} has vocab {tokenizer.vocab_size} but the "
                    f"shard index says {shards.vocab}")
        elif args.tokenizer == "bpe":
            raise SystemExit(
                f"--tokenizer bpe but {args.data_dir} has no "
                f"tokenizer.json (it was built byte-level) — rebuild "
                f"with build_token_shards --tokenizer bpe")
        if args.val_every and not shards.has_val:
            raise SystemExit(
                f"--val-every needs a held-out split but {args.data_dir}"
                f" has no val.bin — rebuild with --val-fraction")
        if args.val_every and shards.val_tokens <= args.seq_len + 1:
            raise SystemExit(
                f"val.bin holds {shards.val_tokens} tokens — shorter "
                f"than seq_len+2; rebuild with a larger --val-fraction")
        return (shards.vocab, tokenizer, shards,
                ValSplit(shards) if shards.has_val else None)
    train_bytes = val_bytes = None
    if args.text:
        raw = Path(args.text).read_bytes()
        if len(raw) <= args.seq_len + 1:
            raise SystemExit("--text is too short for --seq-len")
        if args.val_every:
            split = max(int(len(raw) * 0.9), args.seq_len + 2)
            train_bytes, val_bytes = raw[:split], raw[split:]
            if len(val_bytes) <= args.seq_len + 1:
                raise SystemExit("--text is too short to hold out a 10% "
                                 "validation tail")
        else:
            train_bytes = raw
    if args.tokenizer == "bpe":
        tok_path = (Path(args.save_dir) / "tokenizer.json"
                    if args.save_dir else None)
        if ((args.resume or args.sample_only)
                and tok_path is not None and tok_path.exists()):
            # the checkpointed weights are bound to the saved merges; a
            # fresh run always retrains (and overwrites)
            tokenizer = ByteBPE.load(tok_path)
        elif train_bytes is not None:
            tokenizer = train_bpe(train_bytes, args.vocab_size)
            if tok_path is not None:
                tok_path.parent.mkdir(parents=True, exist_ok=True)
                tokenizer.save(tok_path)
        else:
            raise SystemExit("--tokenizer bpe needs --text to train on "
                             "(or a tokenizer.json under --save-dir)")
        encode, vocab = tokenizer.encode, tokenizer.vocab_size
    elif args.text:
        tokenizer, vocab = None, 256

        def encode(b):
            return np.frombuffer(b, np.uint8).astype(np.int32)
    else:
        return args.vocab, None, None, None
    text_data = val_data = None
    if train_bytes is not None:
        text_data = encode(train_bytes)
        if len(text_data) <= args.seq_len + 1:
            raise SystemExit("tokenized text too short for --seq-len")
    if val_bytes is not None:
        val_data = encode(val_bytes)
        if len(val_data) <= args.seq_len + 1:
            raise SystemExit("tokenized validation tail too short for "
                             "--seq-len")
    return vocab, tokenizer, text_data, val_data


def make_batch(args, vocab: int, step: int, text_data=None):
    """(tokens, targets) (B, T) int32 batch for `step`, a pure function
    of (seed, step) as in the root driver, so a resumed run continues
    the exact stream: the shard corpus's (or its val split's) own
    order, random windows of a text's ids, or the synthetic stream (a
    random 16-token motif repeated along each row)."""
    b, t = args.batch_size, args.seq_len
    if hasattr(text_data, "batch"):
        return text_data.batch(step, b, seed=args.seed)
    rng = np.random.default_rng([args.seed, step])
    if text_data is not None:
        starts = rng.integers(0, len(text_data) - t - 1, b)
        tok = np.stack([text_data[s:s + t] for s in starts])
        tgt = np.stack([text_data[s + 1:s + t + 1] for s in starts])
        return tok, tgt
    motif = rng.integers(0, vocab, (b, 16))
    tok = np.tile(motif, (1, t // 16 + 1))[:, :t].astype(np.int32)
    tgt = np.roll(tok, -1, axis=1).astype(np.int32)
    return tok, tgt


def build(args, vocab: int | None = None):
    """(config, optimizer) from the parsed flags, as the root driver
    builds them; `vocab` is the data's (default: --vocab)."""
    cfg = T.TransformerConfig(
        vocab=args.vocab if vocab is None else vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.seq_len,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        d_ff=args.d_ff, rope=args.rope, norm=args.norm, ffn=args.ffn,
        n_kv_heads=args.kv_heads, tie_embeddings=args.tie_embeddings,
        label_smoothing=args.label_smoothing,
        logit_softcap=args.logit_softcap, attn_window=args.attn_window,
        remat=args.remat, remat_policy=args.remat_policy,
        xent_chunk=args.xent_chunk, dropout=args.dropout,
        attn_dropout=args.attn_dropout, n_experts=args.experts,
        moe_top_k=args.moe_top_k,
        moe_capacity_factor=args.moe_capacity_factor,
        moe_routing=args.moe_routing, moe_z_weight=args.moe_z_weight)
    if args.lr_schedule == "constant":
        lr = args.lr    # a static float keeps SGD stateless
    else:
        lr = SCHEDULES[args.lr_schedule](
            peak=args.lr, warmup=args.warmup_steps, total=args.steps,
            end=args.lr_end)
    kw = {"grad_clip": args.grad_clip or None}
    if args.optimizer in ("adamw", "adafactor"):
        kw["weight_decay"] = args.weight_decay
    return cfg, OPTIMIZERS[args.optimizer](lr=lr, **kw)


def _restore(args, engine):
    """(start step, restored dir, the restore's stats, quarantined dirs)
    for --resume / --sample-only (--auto-resume set --resume when a
    checkpoint exists), as the root driver decides: a strict --resume
    with every checkpoint corrupt exits with EXIT_CORRUPT_CKPT,
    --auto-resume starts fresh instead."""
    if not (args.resume or args.sample_only):
        return 0, None, {}, []
    stats = {}
    start, restored, quarantined = checkpoint.restore_latest(
        engine, args.save_dir, stats)
    if restored is None:
        if args.auto_resume and not args.sample_only:
            rprint(f"--auto-resume: no restorable checkpoint under "
                  f"{args.save_dir!r}"
                  + (f" ({len(quarantined)} quarantined)"
                     if quarantined else "") + "; starting fresh",
                  flush=True)
            args.resume = False
            return 0, None, {}, quarantined
        if quarantined:
            print(f"--resume: every checkpoint under {args.save_dir!r} "
                  f"failed verification ({len(quarantined)} quarantined)",
                  file=sys.stderr)
            raise SystemExit(checkpoint.EXIT_CORRUPT_CKPT)
        raise SystemExit(f"--resume: no checkpoint under {args.save_dir!r}")
    if quarantined:
        rprint(f"quarantined {len(quarantined)} corrupt checkpoint(s); fell "
              f"back to {restored}", flush=True)
    rprint(f"resumed from {restored} at step {start}", flush=True)
    return start, restored, stats, quarantined


def _load_ema(args, engine, restored):
    """The weight average to keep (None when off): the checkpoint's
    `ema.npz` when it has one and matches the model, else a copy of the
    current weights. --sample-only with no --ema-decay samples a saved
    average (decay -1: loaded and used, never updated)."""
    path = Path(restored) / "ema.npz" if restored is not None else None
    saved = path is not None and path.exists()
    if args.ema_decay == 0.0 and saved:
        if args.sample_only:
            rprint("checkpoint has EMA weights; sampling the average "
                  "(delete ema.npz to sample the raw iterate)", flush=True)
            args.ema_decay = -1.0
        else:
            rprint("warning: checkpoint has ema.npz but --ema-decay is "
                  "unset; the running average will NOT be continued",
                  flush=True)
    if args.ema_decay == 0.0:
        return None
    if saved:
        host = checkpoint.load_pytree(path)
        mismatch = checkpoint._structure_mismatch(host, engine.params)
        if mismatch is None:
            return map_tree(
                lambda _, x: torch.from_numpy(np.ascontiguousarray(x)).to(
                    engine.device, copy=True), engine.params, host)
        rprint(f"warning: ema.npz does not match this model ({mismatch}); "
              f"restarting the average from the restored weights",
              flush=True)
    return ema_init(engine.params)


def train(args) -> float:
    """Run the configured training (or, with --sample-only, restore and
    sample); returns the last logged loss (nan with --sample-only)."""
    t_proc0 = time.time()   # the goodput ledger's init: entry -> the loop
    D.initialize()      # a no-op without a coordinator
    # a supervisor's kill is SIGTERM first: exit through the finally
    # blocks, so the log's tail (the goodput ledger) is flushed
    install_sigterm_exit()
    setup_chaos(args, args.save_dir, args.log_file)
    device = resolve_device(args.device)
    vocab, tokenizer, text_data, val_data = prepare_text(args)
    cfg, opt = build(args, vocab)
    if args.auto_resume and not args.resume \
            and checkpoint.has_checkpoint(args.save_dir):
        # a cheap probe: restore_latest does the one verification pass
        args.resume = True
    # an engine about to restore starts from zeros, not from the seeded
    # draw the checkpoint replaces (the draw takes ~30 s at 1.21B)
    restoring = args.resume or args.sample_only
    zeros = (map_tree(lambda m: np.zeros(m.shape, cfg.dtype),
                      T.param_shapes(cfg)) if restoring else None)
    composite = (args.sp > 1 and args.tp > 1) or (
        args.fsdp and (args.sp > 1 or args.tp > 1))
    gspmd = dict(zero1=args.zero1, zero2=args.zero2, health=args.health,
                 params=zeros)
    if args.pp > 1:
        # the root driver's grids: one extra axis, the stage substrate
        # the sp one (ring, ring-flash, ulysses-flash) over sp
        engine = PipelineLMEngine(
            cfg, opt, make_pipeline_mesh(args.dp, args.pp, args.tp, device,
                                         sp=args.sp, ep=args.ep),
            n_mubatches=args.n_mubatches, seed=args.seed,
            schedule=args.pp_schedule, virtual_pp=args.virtual_pp,
            attn=(args.attn if args.sp > 1 else
                  "flash" if args.attn == "flash" else "xla"),
            fsdp=args.fsdp, **gspmd)
    elif composite:
        engine = Composite3DEngine(
            cfg, opt, args.seed, mesh=make_3d_mesh(args.dp, args.sp, args.tp,
                                                   device),
            fsdp=args.fsdp, **gspmd)
    elif args.fsdp:
        engine = FSDPEngine(cfg, opt, args.seed,
                            mesh=make_fsdp_mesh(args.dp, device),
                            overlap=from_flags(args.overlap, args.bucket_mb),
                            **gspmd)
    elif args.ep > 1 or args.experts:
        engine = ExpertParallelEngine(
            cfg, opt, args.seed, mesh=make_ep_mesh(args.dp, args.ep, args.sp,
                                                   device), **gspmd)
    elif args.tp > 1:
        engine = TensorParallelEngine(
            cfg, opt, args.seed, mesh=make_tp_mesh(args.dp, args.tp, device),
            **gspmd)
    else:
        engine = ContextParallelEngine(
            cfg, opt, seed=args.seed, attn=args.attn,
            mesh=make_context_mesh(args.dp, args.sp, device),
            accum=args.accum, zero1=args.zero1, zero2=args.zero2,
            health=args.health, params=zeros,
            overlap=from_flags(args.overlap, args.bucket_mb))
    if D.process_count() > 1:
        rprint(D.describe())
    t_restore = time.time()
    start_step, restored, restore_stats, quarantined = _restore(args,
                                                                engine)
    restore_secs = time.time() - t_restore if restored is not None else 0.0
    if restoring and restored is None:       # --auto-resume, fresh start
        engine.set_canonical_params(T.init_numpy(cfg, args.seed))
    if not args.sample_only and start_step >= args.steps:
        raise SystemExit(f"checkpoint is already at step {start_step} >= "
                         f"--steps {args.steps}; nothing to do")
    metrics = MetricsLogger(args.log_file if D.process_zero() else None,
                            kind="train_lm",
                            d_model=cfg.d_model, n_layers=cfg.n_layers,
                            attn=args.attn, device=str(device),
                            start_step=start_step,
                            **({"replica": args.replica}
                               if args.replica else {}))
    owners = owners_of(engine)
    telem = plane = live_mon = live_srv = None
    # every non-step second stamped into the log the step lines live in
    ledger = GoodputLedger(metrics)
    if restore_secs:
        ledger.note("restore", seconds=restore_secs)
    t_loop_done = None
    try:
        telem, plane = start_telemetry(args, engine, metrics, owners,
                                       "bf16" if args.bf16 else "f32",
                                       ledger)
        live_mon, live_srv = start_monitor(args, metrics, plane)
        if telem is not None and isinstance(engine, PipelineLMEngine):
            # the verified schedule's static bubble rides every step
            # line; the measured one joins at the first calibration
            si = engine.schedule_info()
            telem.set_bubble(bubble_static=static_bubble(
                si["schedule"], si["n_mu"], si["pp"],
                si["vpp"])["bubble_fraction"])
        if restored is not None:
            metrics.log(event="restore", path=str(restored),
                        step=start_step,
                        quarantined=[str(q) for q in quarantined],
                        **restore_stats)
        ema = _load_ema(args, engine, restored)

        @contextlib.contextmanager
        def ema_weights():
            """Temporarily swap the averaged weights into the engine."""
            if ema is None:
                yield
                return
            live, engine.params = engine.params, ema
            try:
                yield
            finally:
                engine.params = live

        if args.sample_only:
            with ema_weights():
                sample_and_print(args, engine, cfg, metrics,
                                 text_data=text_data, tokenizer=tokenizer)
            return float("nan")
        ledger.note("init", seconds=max(0.0, time.time() - t_proc0
                                        - restore_secs))
        loss = _loop(args, engine, cfg, vocab, text_data, val_data, metrics,
                     start_step, ema, ema_weights, telem, ledger, live_mon)
        t_loop_done = time.time()
        report_unfired()
        if args.generate > 0:
            with ema_weights():
                sample_and_print(args, engine, cfg, metrics,
                                 text_data=text_data, tokenizer=tokenizer)
            ledger.note("sample", seconds=time.time() - t_loop_done)
            t_loop_done = time.time()
    finally:
        try:
            stop_telemetry(args, telem, plane, owners)
            # the final sketch snapshot into the log, the endpoint down
            stop_monitor(live_mon, live_srv)
            if t_loop_done is not None:
                ledger.note("teardown",
                            seconds=max(0.0, time.time() - t_loop_done))
        finally:
            metrics.close()
    return loss


def _loop(args, engine, cfg, vocab, text_data, val_data, metrics,
          start_step, ema, ema_weights, telem, ledger, live_mon) -> float:
    """The step loop from `start_step`: prefetched batches, step lines
    at log points (with `telem`'s fields), validation and checkpoints on
    their cadence, `ledger` stamped with every non-step second and
    `live_mon` fed the exact window rates and dumping its flight ring on
    an abort; the pipeline's bubble calibration at the first spans-level
    log point that has two fenced steps; under --profile-dir inside the
    profiler's capture."""
    device = engine.device
    monitor = (HealthMonitor(policy=GuardPolicy.for_mode(args.health))
               if args.health != "off" else None)
    rates = StepRates(args.batch_size * args.seq_len, telemetry=telem,
                      health=monitor, ledger=ledger, monitor=live_mon)
    dtype = "bf16" if args.bf16 else "f32"
    saver = checkpoint.AsyncSaver() if args.async_save else None
    queued = []          # stats of the async saves, logged once written

    def save_ckpt(ckpt_dir, step):
        stats = {"step": step, "dir": str(ckpt_dir)}
        extra = {"ema": ema} if ema is not None else None
        keep = args.keep_checkpoints or None
        if saver is not None:
            saver.save(ckpt_dir, engine, step, extra=extra, keep=keep,
                       stats=stats)
            queued.append(stats)
        else:
            checkpoint.save(ckpt_dir, engine, step, extra=extra, keep=keep,
                            stats=stats)
            metrics.log(event="ckpt_save", **stats)

    def save_failed(step, err):
        # the atomic rename means latest() still points at the previous
        # checkpoint: a failed save (ENOSPC, an IO error) must not kill
        # a healthy run
        if D.process_count() > 1:
            # the peers already wait in the save's barrier: carrying on
            # here would wedge them; raise and let every process stop
            raise err
        rprint(f"warning: checkpoint save failed ({err}); the previous "
              f"checkpoint remains the restore point", flush=True)
        metrics.log(event="ckpt_save_failed", step=step, error=str(err))
        ledger.note("ckpt_save_failed", count=1)

    def val_loss(step: int) -> float:
        """Held-out loss on a fresh batch seeded by the training step
        (the --text tail, the shards' val.bin, or a seed stream disjoint
        from training), on the averaged weights under --ema-decay."""
        val_args = args if val_data is not None else argparse.Namespace(
            **{**vars(args), "seed": args.seed + 1})
        tok, tgt = make_batch(val_args, vocab, 10**9 + step, val_data)
        with ema_weights():
            return engine.eval_loss(rows(tok), rows(tgt))

    # across processes every process builds the same batch; an engine
    # takes the rows of its cells' replicas (the pipeline the whole)
    rows = getattr(engine, "local_batch", None) or (lambda x: x)

    def batches():
        for step in range(start_step, args.steps):
            # a chaos stall sleeps here, in the producer: a prefetched
            # pipeline may absorb it, at --prefetch 0 it is a data stall
            chaos.on_data_load(step)
            tok, tgt = make_batch(args, vocab, step, text_data)
            yield rows(tok), rows(tgt)

    placed = prefetch_to_device(batches(), place_on(device),
                                depth=args.prefetch)
    loss, last = float("nan"), start_step - 1
    data_stall = 0.0     # the wait for the next placed batch since the
    failed = True        # last log point
    # the asynchronous step: the loss stays on the card, read only where
    # a host value is needed, so the host queues step k + 1 behind step k
    step_fn = (engine.train_batch_async if telem is None
               else lambda t, g: telem.count_step(engine.train_batch_async,
                                                  t, g))
    try:
        # the --profile-dir capture spans the loop (a no-op without it)
        with device_trace_ctx(args.profile_dir):
            placed_it = iter(placed)
            for step in range(start_step, args.steps):
                # chaos step faults (kill, poison, heartbeat freeze), each
                # once a plan: a restarted child replays the window clean
                chaos.on_step(step, engine)
                t_fetch = time.time()
                tok, tgt = next(placed_it)
                data_stall += time.time() - t_fetch
                loss_dev = step_fn(tok, tgt)
                if ema is not None:
                    ema_update(ema, engine.params, args.ema_decay)
                saving = bool(args.save_dir) and (
                    (step + 1) % args.save_every == 0
                    or step == args.steps - 1)
                at_log = sync_every(step, args.log_every, args.steps)
                if at_log or saving:
                    # log points, the last step and the saves' finite
                    # check read the loss; no other step waits for it
                    loss = float(loss_dev)
                if at_log:
                    if monitor is not None:
                        verdicts = monitor.observe(step, loss,
                                                   engine.health_snapshot())
                        for v in verdicts:
                            rprint(str(v), flush=True)
                        fatal = [v for v in verdicts if v.action == "abort"]
                        if fatal:
                            if live_mon is not None:
                                # the process exits before the next line
                                # would reach the monitor: dump now
                                live_mon.flight_dump(
                                    "anomaly:" + ",".join(
                                        v.kind for v in fatal), step=step,
                                    trigger=[str(v) for v in fatal])
                            if args.save_dir:
                                save_ckpt(f"{args.save_dir}/diverged", step)
                                if saver is not None:
                                    saver.wait()
                            raise SystemExit(
                                f"health policy abort at step {step}: "
                                + "; ".join(v.detail for v in fatal))
                    # liveness and health for the supervisor: a stale
                    # mtime is a hung loop, "dead ..." a dead run
                    beat(args, monitor)
                    if not np.isfinite(loss):
                        if live_mon is not None:
                            live_mon.flight_dump(
                                "divergence:nonfinite_loss", step=step,
                                trigger={"loss": str(loss)})
                        if args.save_dir:
                            # forensic only: under diverged/, so --resume
                            # keeps finding the last good checkpoint
                            save_ckpt(f"{args.save_dir}/diverged", step)
                            if saver is not None:
                                saver.wait()
                            rprint(f"diverged-state snapshot: {args.save_dir}/"
                                  f"diverged/ckpt_{step}", flush=True)
                        raise SystemExit(
                            f"loss became non-finite ({loss}) at step {step}; "
                            f"try --grad-clip, a lower --lr, or --lr-schedule "
                            f"with --warmup-steps")
                    r = rates.log_point(step - last)
                    last = step
                    if data_stall > 0.01:
                        ledger.note("data_stall", seconds=data_stall)
                    data_stall = 0.0
                    perf = mfu(r["tokens_per_sec"], cfg, args.seq_len, dtype,
                               device=device)
                    cum = mfu(r["tokens_per_sec_cum"], cfg, args.seq_len,
                              dtype, device=device)
                    mfu_txt = ("" if perf["mfu"] is None else
                               f"  {perf['tflops']:.1f} TF/s "
                               f"({perf['mfu'] * 100:.1f}% MFU)")
                    rprint(f"step {step:5d}  loss {loss:.4f}  "
                          f"tok/s {r['tokens_per_sec']:,.0f}{mfu_txt}",
                          flush=True)
                    # the health and telemetry fields ride the same line
                    fields = {k: v for k, v in r.items()
                              if k not in ("tokens_per_sec",
                                           "tokens_per_sec_cum")}
                    metrics.log(**step_event(step, loss, r, perf, cum),
                                **fields)
                    if live_mon is not None and monitor is not None:
                        # /status.json's health: the heartbeat status
                        live_mon.health = monitor.heartbeat_status()
                    line = telemetry_line(fields) if telem else ""
                    if line:
                        rprint(line, flush=True)
                    if (telem is not None and args.telemetry == "spans"
                            and isinstance(engine, PipelineLMEngine)
                            and "bubble_measured" not in telem.bubble):
                        _calibrate_bubble(args, engine, vocab, text_data,
                                          step, telem, rates, metrics)
                    if args.experts and not isinstance(engine,
                                                       PipelineLMEngine):
                        # the capacity drop is silent in the loss: show it
                        # (the pipeline, as the reference's, reports none)
                        rs = engine.router_stats(tok)
                        rprint(f"             moe drop "
                              f"{rs['drop_fraction']:.1%}  load "
                              f"{rs['expert_load']}", flush=True)
                        metrics.log(event="moe_router", step=step, **rs)
                if args.val_every and ((step + 1) % args.val_every == 0
                                       or step == args.steps - 1):
                    tv = time.time()
                    vl = val_loss(step)
                    rates.pause(time.time() - tv, kind="val")
                    ppl = float(np.exp(min(vl, 20)))
                    rprint(f"step {step:5d}  val_loss {vl:.4f}  "
                           f"ppl {ppl:,.2f}", flush=True)
                    metrics.log(event="val", step=step, val_loss=round(vl, 6),
                                perplexity=round(ppl, 3))
                if saving:
                    ts = time.time()
                    if not np.isfinite(loss) or (monitor is not None
                                                 and monitor.unhealthy()):
                        # never make a poisoned iterate the restore point
                        status = (f"loss {loss}" if not np.isfinite(loss)
                                  else monitor.heartbeat_status())
                        rprint(f"step {step}: state is {status!r} — "
                               f"skipping checkpoint save", flush=True)
                        metrics.log(event="ckpt_save_skipped", step=step)
                        ledger.note("ckpt_save_skipped_unhealthy", count=1)
                    else:
                        try:
                            save_ckpt(args.save_dir, step)
                        except (checkpoint.CheckpointError, OSError) as e:
                            save_failed(step, e)
                        except RuntimeError as e:
                            # the async saver surfaces its worker's failure
                            # on the next call, wrapped
                            if "checkpoint" not in str(e):
                                raise
                            save_failed(step, e)
                    rates.pause(time.time() - ts, kind="ckpt_save")
        failed = False
    finally:
        # the supervisor's SIGKILL follows within its grace window: the
        # process exits now, its daemon threads with it (a producer in a
        # stall, a write the atomic rename keeps from `latest()`)
        term = terminating(sys.exc_info()[1])
        # abandoning mid-stream must not leave placed batches held by a
        # blocked producer thread
        if hasattr(placed, "close") and not term:
            placed.close()
        if saver is not None and term:
            pass
        elif saver is not None:
            if not failed:
                saver.wait()      # drains; raises a failed write (on
                saver.close()     # every process together)
                for stats in queued:
                    metrics.log(event="ckpt_save", **stats)
            else:
                # an exception is already propagating: don't let a
                # write error from close() replace it
                try:
                    saver.close()
                except RuntimeError as err:
                    print(f"[warn] async checkpoint save failed during "
                          f"teardown: {err!r}", file=sys.stderr)
    return loss


def _calibrate_bubble(args, engine, vocab, text_data, step, telem, rates,
                      metrics) -> None:
    """The pipeline's measured bubble (`calibrate_compiled`: the median
    fenced step and a few fenced eval passes on this step's batch, laid
    on the verified tables), excluded from the throughput windows as a
    "calibration" pause; once it has two fenced steps after the first,
    a `"bubble"` event and the `bubble measured ... vs static ...`
    line."""
    tc = time.time()
    tok, tgt = make_batch(args, vocab, step, text_data)
    cal = calibrate_compiled(engine, tracer(), tok, tgt)
    rates.pause(time.time() - tc, kind="calibration")
    if cal is None:
        return
    telem.set_bubble(bubble_static=cal["bubble_static"],
                     bubble_measured=cal["bubble_measured"])
    metrics.log(event="bubble", step=step, **cal["bubble_detail"],
                bubble_static=cal["bubble_static"],
                bubble_measured=cal["bubble_measured"])
    si = engine.schedule_info()
    rprint(f"             bubble measured {cal['bubble_measured']:.1%} vs "
           f"static {cal['bubble_static']:.1%} ({si['schedule']}, n_mu="
           f"{si['n_mu']}, pp={si['pp']})", flush=True)


def sample_and_print(args, engine, cfg, metrics=None, text_data=None,
                     tokenizer=None):
    """Decode `args.generate` tokens from the engine's parameters
    through the contiguous `generate`, after `--prompt` (byte-level, or
    through `tokenizer`) or a 16-token prefix of the training stream,
    and print the root driver's decode, prompt and sample lines (the
    rate includes the prefill and, on the card, the kernels' first-use
    build)."""
    if args.prompt:
        prompt = (tokenizer.encode(args.prompt) if tokenizer is not None
                  else np.frombuffer(args.prompt.encode(), np.uint8).astype(
                      np.int32))[None, :]
    else:
        prompt = make_batch(args, cfg.vocab, 0, text_data)[0][:1, :16]
    if (not args.kv_int8 and isinstance(engine, PipelineLMEngine)
            and engine.tp == engine.sp == engine.ep == 1
            and not engine.fsdp):
        # decode on the pp-cut parameters, each stage its own cache (at
        # vpp > 1 the chunks in logical order)
        t0 = time.time()
        out = engine.generate(prompt, args.generate,
                              temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p, seed=args.seed)
        dt = time.time() - t0
        rprint(f"decode: {prompt.shape[0] * args.generate / dt:,.0f} tok/s "
              f"(pp-sharded decode; includes prefill)", flush=True)
        _print_sample(prompt, out, tokenizer)
        return out
    if args.kv_int8 and isinstance(engine, PipelineLMEngine):
        rprint("note: --kv-int8 decodes on the REPLICATED path (full params "
              "re-gathered to one device); the pipelined per-stage cache "
              "stays bf16 — drop --kv-int8 to decode on the pp-sharded "
              "params", flush=True)
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
    rprint(f"decode: {rep['tokens_per_sec']:,.0f} tok/s  "
          f"~{rep['bytes_per_token'] / 2**20:.1f} MiB/token sweep "
          f"-> {rep['hbm_gbps']:.1f} GB/s{util} [includes prefill]",
          flush=True)
    if metrics is not None:
        metrics.log(event="generate", **rep)
    _print_sample(prompt, out, tokenizer)
    return out


def _print_sample(prompt, out, tokenizer) -> None:
    if tokenizer is not None:
        rprint(f"prompt: {tokenizer.decode_bytes(prompt[0])!r}")
        rprint(f"sample: {tokenizer.decode_bytes(out[0])!r}", flush=True)
    else:
        rprint(f"prompt: {_show(prompt[0])}")
        rprint(f"sample: {_show(out[0])}", flush=True)


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
