"""MLP training driver of the PyTorch port — counterpart of the root
`train.py`, the source paper's main path.

    python -m shallowspeed_tpu_torch.train [--dp N] [--pp M] \
        [--schedule naive|gpipe|pipedream] [--engine auto|fused|vm|spmd]
    python -m shallowspeed_tpu_torch.train --device cpu --epochs 1 --max-batches 4

Trains the reference's MLP ([784, 128, 127, 126, 125, 124, 123, 10],
global batch 128, 4 microbatches, SGD lr 0.006, 20 epochs by default) on
MNIST-784 from `--data-dir`, synthesized there when absent (this
package never downloads). One process drives a (dp, pp) grid whose
cells are all `--device` (the card unless `--device cpu` is given), so
every layout runs on one card:

- `--engine auto`: `fused` for pp = 1, `spmd` for pp > 1 with
  `--schedule gpipe`, else `vm`;
- `fused` (`engine.FusedDPEngine`): data parallel, the epoch placed on
  the device once and stepped with no host copy per batch;
- `vm` (`parallel.worker.PipelineExecutor`): the instruction VM running
  the naive, GPipe or PipeDream-Flush schedule;
- `spmd` (`parallel.spmd_pipeline.SPMDPipelineEngine`): the GPipe clock
  with the stage axis batched.

Prints the reference's `Epoch: N, Time Spent: S, Accuracy: A%` lines
(accuracy before each epoch's updates, then the trained result), writes
its `epoch` / `final` JSONL records with `--log-file`, checks at the end
that the DP replicas are bit-identical and prints the model hash.
`--save-dir` checkpoints after every epoch (the JAX package's format,
with the canonical optimizer record, so any engine, of either package,
resumes any other's); `--resume` / `--auto-resume` restore the newest
verified checkpoint.

`--health monitor|guard` computes the health pack on the device every
batch (guard skips an update with non-finite gradients, bit for bit),
prints the anomaly verdicts and writes a `health` record after every epoch, and skips the
checkpoint of an unhealthy epoch. `--engine fp8` is the single-device
fp8-e4m3 trainer (`fp8.Fp8TrainEngine`, `train_fp8`): step lines every
`--log-every` steps with the numerics fields, shadow parity every
`--shadow-every` steps, the guard's bf16 fallback.

`--overlap on [--bucket-mb MB]` (`parallel.overlap`): the fused
engine reduces each bucket between the last microbatch's layer VJPs,
the SPMD engine double-buffers its hops and reduces the last backward
tick's buckets in its layer loop; the instruction VM refuses it with
the root driver's message. Bit for bit the bulk reduction's training.

Launched once per process with the reference's variables
(`JAX_COORDINATOR_ADDRESS`, `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`;
`distributed.initialize` runs first), the (dp, pp) grid is cut from the
processes' cells (`parallel.mesh`): `--engine spmd` runs over them (the
stage hops, or the replicas' sums, between processes), each process
loads every replica's shard and trains its own, process 0 alone prints
and writes the JSONL log, and the model hash is the one-process run's.
The fused, VM and fp8 engines are refused there (`NotPorted`), and a
failed checkpoint save raises instead of being skipped (the peers would
wait in the save's barrier).

`--telemetry steps|spans` traces the engines' spans ("step" / "run" of
the fused engine, "step" / "epoch" of the SPMD pipeline, the VM's
"batch" and per-instruction spans; `spans` fences them on the device)
and logs a `"telemetry"` event every epoch (allocated device memory,
the owners "train.params" / "train.opt_state", host RSS, the last
batch's counted collective bytes, the VM's measured `comm_bytes`);
`--trace-dir`, `--profile-dir`, `--profile` and `--profile-hz` as in
`train_lm`. `--engine fp8` refuses `--telemetry`, as the root driver
does. At pp > 1 the telemetry events carry the schedule's static
bubble; the VM at `spans` replays its last batch's fenced Forward /
Backward spans on the schedule's dataflow and adds the measured one
(`telemetry.bubble.span_replay_ops` / `replay_trace`).

The goodput ledger (`"ledger"` lines: init, val, ckpt_save, failed and
skipped saves; under `--engine fp8` also the shadow-parity pauses and
the `fp8_fallback` count) and the live monitor (`--monitor-port`,
`--slo`, `--flight-recorder`) as in `train_lm`.

The root driver's other flags (chaos, the heartbeat) are recognised and
refused with `NotPorted`; `--platform` and `--host-devices` give way to
`--device`.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted, checkpoint
from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.data.dataset import Dataset
from shallowspeed_tpu_torch.data.mnist import ensure_mnist
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.fp8 import Fp8TrainEngine
from shallowspeed_tpu_torch.metrics import MetricsLogger, StepRates
from shallowspeed_tpu_torch.models.mlp import MLPStage
from shallowspeed_tpu_torch.optim import OPTIMIZERS
from shallowspeed_tpu_torch.parallel.mesh import make_mesh
from shallowspeed_tpu_torch.parallel.overlap import from_flags
from shallowspeed_tpu_torch.parallel.schedules import (GPipeSchedule,
                                                       InferenceSchedule,
                                                       NaiveParallelSchedule,
                                                       PipeDreamSchedule)
from shallowspeed_tpu_torch.parallel.spmd_pipeline import SPMDPipelineEngine
from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor
from shallowspeed_tpu_torch.telemetry import profiler
from shallowspeed_tpu_torch.telemetry.anomaly import GuardPolicy
from shallowspeed_tpu_torch.telemetry.bubble import (replay_trace,
                                                     span_replay_ops,
                                                     static_bubble)
from shallowspeed_tpu_torch.telemetry.driver import (CHAOS,
                                                     add_telemetry_flags,
                                                     owners_of,
                                                     start_monitor,
                                                     start_telemetry,
                                                     stop_monitor,
                                                     stop_telemetry)
from shallowspeed_tpu_torch.telemetry.goodput import GoodputLedger
from shallowspeed_tpu_torch.telemetry.health import HealthMonitor
from shallowspeed_tpu_torch.telemetry.numerics import NumericsMonitor
from shallowspeed_tpu_torch.telemetry.profiler import device_trace_ctx
from shallowspeed_tpu_torch.telemetry.trace import tracer
from shallowspeed_tpu_torch.utils import (assert_replicas_in_sync,
                                          get_model_hash, rprint)

EPOCHS = 20
GLOBAL_BATCH_SIZE = 128
N_MUBATCHES = 4
LAYER_SIZES = [784, 128, 127, 126, 125, 124, 123, 10]
LR = 0.006

SCHEDULES = {"naive": NaiveParallelSchedule, "gpipe": GPipeSchedule,
             "pipedream": PipeDreamSchedule}

_DEVICE = "--device replaces it: every cell of the dp x pp grid runs there"

# the root driver's flags this driver does not have, and where each
# comes from
UNPORTED = {
    **dict.fromkeys(["--chaos", "--chaos-state", "--chaos-seed",
                     "--heartbeat-file", "--replica"], CHAOS),
    **dict.fromkeys(["--platform", "--host-devices"], _DEVICE),
}


class _Refuse(argparse.Action):
    """Any use of an unported flag raises `NotPorted`."""

    def __call__(self, parser, namespace, values, option_string=None):
        raise NotPorted(f"train {option_string}", UNPORTED[option_string])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dp", type=int, default=1,
                   help="Degree of data parallelism (=number of full model replicas)")
    p.add_argument("--pp", type=int, default=1, help="Number of pipeline stages")
    p.add_argument("--schedule", type=str,
                   choices=["pipedream", "gpipe", "naive"], default="naive")
    p.add_argument("--engine", type=str,
                   choices=["auto", "vm", "fused", "spmd", "fp8"],
                   default="auto",
                   help="auto: fused for pp=1, spmd (the GPipe clock) for "
                        "pp>1 with --schedule gpipe, else the instruction "
                        "VM; fp8: the single-device fp8-e4m3 trainer with "
                        "its numerics pack, shadow parity and bf16 "
                        "fallback")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--batch-size", type=int, default=GLOBAL_BATCH_SIZE)
    p.add_argument("--mubatches", type=int, default=N_MUBATCHES)
    p.add_argument("--lr", type=float, default=LR)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "momentum", "adam", "adamw"])
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--overlap", default="off", choices=["off", "on"],
                   help="comm/compute interleaving (parallel.overlap): "
                        "bucketed dp gradient reduction issued inside the "
                        "backward (fused engine) and double-buffered "
                        "stage hops + the peeled bucketed reduction (spmd "
                        "engine); the default bulk reduction is the "
                        "oracle")
    p.add_argument("--bucket-mb", type=float, default=4.0,
                   help="with --overlap on: target bytes per reduction "
                        "bucket (MiB); smaller = more, earlier "
                        "reductions")
    p.add_argument("--weight-decay", type=float, default=0.01,
                   help="decoupled weight decay (adamw only)")
    p.add_argument("--data-dir", type=str, default="data/mnist_784",
                   help="MNIST-784 npy files; synthesized there if absent")
    p.add_argument("--max-batches", type=int, default=0,
                   help="limit batches per epoch (0 = all); for smoke tests")
    p.add_argument("--save-dir", type=str, default="",
                   help="checkpoint directory; saves after every epoch")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --save-dir")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the latest checkpoint if one exists, "
                        "start fresh otherwise")
    p.add_argument("--log-file", type=str, default="",
                   help="append per-epoch JSONL metrics here")
    p.add_argument("--health", default="off",
                   choices=["off", "monitor", "guard"],
                   help="monitor: the health pack (grad/param norms, "
                        "non-finite sentinel) every batch, anomaly "
                        "verdicts per epoch; guard: monitor + skip any "
                        "update with non-finite gradients bit for bit")
    p.add_argument("--shadow-every", type=int, default=16,
                   help="--engine fp8: the f32 oracle's parity on the "
                        "live batch every N steps (0 = off; never step 0)")
    p.add_argument("--log-every", type=int, default=10,
                   help="--engine fp8: step-line cadence")
    p.add_argument("--device", type=str, default=None,
                   help="the device every cell of the grid runs on "
                        "(default: the GPU; 'cpu' only when asked)")
    add_telemetry_flags(p)
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", action=_Refuse,
                       help=argparse.SUPPRESS)
    return p


def parse_args(argv=None):
    return parser().parse_args(argv)


def build(args, device):
    """(engine, train shards, val shards) for the configured layout, as
    the root driver's `build`."""
    dp, pp = args.dp, args.pp
    assert dp >= 1 and pp >= 1
    assert args.batch_size % dp == 0, "Batch size must be divisible by DP"

    mesh = make_mesh(dp, pp, device)
    optimizer = _optimizer(args)

    data_dir = ensure_mnist(Path(args.data_dir))
    local_bs = args.batch_size // dp
    assert local_bs % args.mubatches == 0, (
        f"local batch {local_bs} must be divisible by --mubatches "
        f"{args.mubatches}")
    mubatch_size = local_bs // args.mubatches
    train_ds = [Dataset(data_dir, args.batch_size, mubatch_size).load(r, dp)
                for r in range(dp)]
    # validation: the whole local batch as one microbatch
    val_ds = [Dataset(data_dir, args.batch_size, local_bs, validation=True)
              .load(r, dp) for r in range(dp)]

    kind = args.engine
    if kind == "auto":
        kind = ("fused" if pp == 1
                else "spmd" if args.schedule == "gpipe" else "vm")
    if kind == "fused" and pp != 1:
        raise SystemExit("--engine fused requires --pp 1")
    if kind == "spmd" and args.schedule != "gpipe":
        raise SystemExit("--engine spmd implements the gpipe schedule; use "
                         "--schedule gpipe (or --engine vm)")
    ov = from_flags(args.overlap, args.bucket_mb)
    if kind == "fused":
        stage = MLPStage(LAYER_SIZES, 0, 1, batch_size=args.batch_size)
        engine = FusedDPEngine(stage, optimizer, mesh, health=args.health,
                               overlap=ov)
    elif kind == "spmd":
        engine = SPMDPipelineEngine(LAYER_SIZES, optimizer, mesh,
                                    args.mubatches, mubatch_size,
                                    args.batch_size, health=args.health,
                                    overlap=ov)
    else:
        if ov is not None:
            raise SystemExit(
                "--overlap on needs a compiled engine (fused or spmd); "
                "the instruction VM already issues its collectives "
                "per-instruction")
        stages = [MLPStage(LAYER_SIZES, s, pp, batch_size=args.batch_size)
                  for s in range(pp)]
        engine = PipelineExecutor(mesh, stages, optimizer,
                                  health=args.health)
    return engine, train_ds, val_ds


def compute_accuracy(engine, val_ds) -> float:
    """Argmax of the last stage's output against the one-hot target,
    streamed over the validation batches."""
    correct = total = 0
    for batch_id in range(val_ds[0].get_num_batches()):
        targets = np.concatenate(
            [ds.load_micro_batch_target(batch_id, 0) for ds in val_ds])
        if hasattr(engine, "infer"):  # fused / spmd engines
            x = np.concatenate(
                [ds.load_micro_batch_input(batch_id, 0) for ds in val_ds])
            out = engine.infer(x)
        else:  # pipeline VM
            out = engine.infer_batch(InferenceSchedule, 1, batch_id, val_ds)
        pred = out.argmax(dim=-1).cpu().numpy()
        correct += int((pred == targets.argmax(axis=-1)).sum())
        total += len(pred)
    return correct / total


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _restore(args, engine) -> int:
    """The first epoch to train: 0, or the one after the restored
    checkpoint's (as the root driver's resume path)."""
    if args.auto_resume and not args.resume:
        if not args.save_dir:
            raise SystemExit("--auto-resume requires --save-dir")
        if checkpoint.has_checkpoint(args.save_dir):
            args.resume = True
    if not args.resume:
        return 0
    if not args.save_dir:
        raise SystemExit("--resume requires --save-dir")
    start_epoch, ck, quarantined = checkpoint.restore_latest(
        engine, args.save_dir)
    if ck is not None:
        rprint(f"resumed from {ck} at epoch {start_epoch}")
    elif args.auto_resume:
        rprint(f"--auto-resume: no restorable checkpoint under "
               f"{args.save_dir!r}; starting fresh")
    elif quarantined:
        print(f"--resume: every checkpoint under {args.save_dir!r} failed "
              f"verification ({len(quarantined)} quarantined)",
              file=sys.stderr)
        raise SystemExit(checkpoint.EXIT_CORRUPT_CKPT)
    else:
        raise SystemExit(f"--resume: no checkpoint found under "
                         f"{args.save_dir!r}")
    return start_epoch


def _optimizer(args):
    opt_kw = {"grad_clip": args.grad_clip or None}
    if args.optimizer == "adamw":
        opt_kw["weight_decay"] = args.weight_decay
    return OPTIMIZERS[args.optimizer](lr=args.lr, **opt_kw)


def train_fp8(args):
    """The fp8 driver: a step loop over `fp8.Fp8TrainEngine` whose step
    lines carry the numerics fields (`NumericsMonitor`, always on) and,
    under `--health`, the health fields; shadow parity against the f32
    oracle every `--shadow-every` steps; under `--health guard` a
    `fallback_bf16` verdict switches the engine to the master-precision
    step and a repeated one (`abort`) exits. Returns (the final
    validation loss, the engine). The reference's goodput `ledger`
    lines, chaos hooks, heartbeat and live monitor are not ported, so
    this driver writes no `ledger` events."""
    for flag, val in (("--dp", args.dp != 1), ("--pp", args.pp != 1),
                      ("--save-dir", bool(args.save_dir)),
                      ("--telemetry", args.telemetry != "off"),
                      ("--overlap", args.overlap != "off")):
        if val:
            raise SystemExit(
                f"--engine fp8 is the single-device numerics trainer; "
                f"{flag} is not supported with it")
    t_proc0 = time.time()
    device = resolve_device(args.device)
    engine = Fp8TrainEngine(LAYER_SIZES, _optimizer(args), device=device)
    data_dir = ensure_mnist(Path(args.data_dir))
    train_ds = Dataset(data_dir, args.batch_size,
                       args.batch_size).load(0, 1)
    val_ds = Dataset(data_dir, args.batch_size, args.batch_size,
                     validation=True).load(0, 1)
    n_batches = train_ds.get_num_batches()
    if args.max_batches:
        n_batches = min(n_batches, args.max_batches)
    total_steps = n_batches * args.epochs
    metrics = MetricsLogger(
        args.log_file, engine=type(engine).__name__, dp=1, pp=1,
        schedule="fp8", batch_size=args.batch_size, device=str(device))
    policy = (GuardPolicy.for_mode(args.health)
              if args.health != "off" else None)
    num_mon = NumericsMonitor(policy=policy)
    monitor = HealthMonitor(policy=policy) if args.health != "off" else None
    guarded = args.health == "guard"
    ledger = GoodputLedger(metrics)
    plane = profiler.from_args(args, metrics)
    live_mon, live_srv = start_monitor(args, metrics, plane)
    rates = StepRates(args.batch_size, health=monitor, numerics=num_mon,
                      ledger=ledger, monitor=live_mon)

    def val_loss() -> float:
        t0 = time.time()
        nb = val_ds.get_num_batches()
        tot = sum(engine.eval_loss(val_ds.load_micro_batch_input(b, 0),
                                   val_ds.load_micro_batch_target(b, 0))
                  for b in range(nb))
        rates.pause(time.time() - t0, kind="val")
        return tot / max(nb, 1)

    last_logged = -1
    ledger.note("init", seconds=time.time() - t_proc0)
    try:
        for step in range(total_steps):
            batch_id = step % n_batches
            x = train_ds.load_micro_batch_input(batch_id, 0)
            y = train_ds.load_micro_batch_target(batch_id, 0)
            loss = engine.train_batch(x, y)
            # one fetch of the pack a step: the scale-collapse signature
            # shows only at the step it happens
            snap = engine.health_snapshot()
            verdicts = num_mon.observe(step, snap)
            if args.shadow_every and step and step % args.shadow_every == 0:
                t_sh = time.time()
                parity = engine.shadow_parity(x, y)
                rates.pause(time.time() - t_sh, kind="shadow_parity")
                verdicts += num_mon.note_parity(step, parity)
            if monitor is not None:
                verdicts += monitor.observe(step, loss, snap)
            fatal = []
            for v in verdicts:
                rprint(str(v))
                if v.action == "fallback_bf16" and guarded \
                        and engine.precision == "fp8":
                    engine.fallback_bf16()
                    num_mon.note_fallback()
                    ledger.note("fp8_fallback", count=1)
                    rprint(f"numerics guard: falling back to the bf16 "
                           f"master-precision step at step {step} "
                           f"({v.kind})")
                elif v.action == "abort" and guarded:
                    fatal.append(v)
            at_end = step == total_steps - 1
            if verdicts or at_end or step - last_logged >= args.log_every:
                r = rates.log_point(step - last_logged)
                last_logged = step
                metrics.log(event="step", step=step,
                            loss=round(float(loss), 6),
                            tokens_per_sec=round(r.pop("tokens_per_sec"),
                                                 1),
                            tokens_per_sec_cum=round(
                                r.pop("tokens_per_sec_cum"), 1), **r)
                rprint(f"step {step:5d}  loss {loss:.5f}  "
                       f"precision {engine.precision}"
                       + (f"  parity "
                          f"{num_mon._last_parity['loss_rel']:.3g}"
                          if num_mon._last_parity else ""))
            if fatal:
                if live_mon is not None:
                    live_mon.flight_dump(
                        "numerics:" + ",".join(v.kind for v in fatal),
                        step=step, trigger=[str(v) for v in fatal])
                raise SystemExit(
                    f"numerics policy abort at step {step}: "
                    + "; ".join(v.detail for v in fatal))
        final = val_loss()
        rprint(f"final val loss {final:.5f}  precision "
               f"{engine.precision}  shadow samples "
               f"{num_mon.shadow_total}")
        metrics.log(event="val", step=max(total_steps - 1, 0),
                    val_loss=round(final, 6))
    finally:
        try:
            if plane is not None:
                plane.close()
            stop_monitor(live_mon, live_srv)
        finally:
            metrics.close()
    return final, engine


def train(args):
    """Run the configured training; returns (final validation accuracy,
    the trained engine) — for `--engine fp8`, (the final validation
    loss, the engine)."""
    t_proc0 = time.time()     # the goodput ledger's init
    D.initialize()
    if args.engine == "fp8":
        if D.process_count() > 1:
            D.refuse("the fp8 trainer (train --engine fp8)")
        return train_fp8(args)
    device = resolve_device(args.device)
    schedule_cls = SCHEDULES[args.schedule]
    engine, train_ds, val_ds = build(args, device)
    if D.process_count() > 1:
        rprint(D.describe())
    n_batches = train_ds[0].get_num_batches()
    if args.max_batches:
        n_batches = min(n_batches, args.max_batches)
    start_epoch = _restore(args, engine)
    metrics = MetricsLogger(
        args.log_file if D.process_zero() else None, dp=args.dp,
        pp=args.pp, schedule=args.schedule,
        engine=type(engine).__name__, batch_size=args.batch_size,
        device=str(device))
    # the health pack and its monitor, fed once an epoch (the pack is
    # computed on the device every batch, by the engine's step, staged
    # epoch or not; a guard skip happens in-step)
    monitor = (HealthMonitor(policy=GuardPolicy.for_mode(args.health))
               if args.health != "off" else None)
    # fused / spmd engines: the epoch's batches placed on the device
    # once, each epoch stepped with no host copy per batch
    staged = (engine.stage_epoch(train_ds, n_batches)
              if hasattr(engine, "train_epoch") else None)
    owners = owners_of(engine)
    telem = plane = live_mon = live_srv = None
    ledger = GoodputLedger(metrics)
    start = time.time()
    try:
        telem, plane = start_telemetry(args, engine, metrics, owners, "f32",
                                       ledger)
        live_mon, live_srv = start_monitor(args, metrics, plane)
        if telem is not None and args.pp > 1:
            telem.set_bubble(bubble_static=static_bubble(
                args.schedule, args.mubatches, args.pp)["bubble_fraction"])
        ledger.note("init", seconds=time.time() - t_proc0)
        with device_trace_ctx(args.profile_dir):
            _epochs(args, engine, schedule_cls, train_ds, val_ds, n_batches,
                    staged, start_epoch, start, metrics, monitor, telem,
                    device, ledger, live_mon)
        accuracy = compute_accuracy(engine, val_ds)
        rprint(f"Epoch: {args.epochs}, Time Spent: "
               f"{time.time() - start:.2f}s, Accuracy: {accuracy * 100:.2f}%")
        metrics.final(accuracy, time.time() - start)
    finally:
        try:
            stop_telemetry(args, telem, plane, owners)
            stop_monitor(live_mon, live_srv)
        finally:
            metrics.close()
    # DP replicas hold bit-identical weights (the reference's closing
    # hash check)
    assert_replicas_in_sync(engine.replicas())
    rprint(f"model hash: {get_model_hash(engine.params)}")
    return accuracy, engine


def _epochs(args, engine, schedule_cls, train_ds, val_ds, n_batches, staged,
            start_epoch, start, metrics, monitor, telem, device,
            ledger, live_mon) -> None:
    """The epochs from `start_epoch`: accuracy line, training, the
    epoch record, health, telemetry and checkpoint, once an epoch, with
    the val and save seconds and the failed or skipped saves stamped
    into `ledger`. The MLP driver writes no step lines, so the live
    monitor's `step_ms` sketch takes each epoch's mean batch time."""
    for epoch in range(start_epoch, args.epochs):
        t_val = time.time()
        accuracy = compute_accuracy(engine, val_ds)
        ledger.note("val", seconds=time.time() - t_val)
        rprint(f"Epoch: {epoch}, Time Spent: {time.time() - start:.2f}s, "
               f"Accuracy: {accuracy * 100:.2f}%")
        t_epoch = time.time()
        trace_mark = 0
        if staged is not None:
            engine.train_epoch(staged)
        else:
            for batch_id in range(n_batches):
                if batch_id == n_batches - 1:
                    # the bubble replay reads only the last batch's
                    # spans (batch ids repeat across epochs)
                    trace_mark = tracer().event_count
                engine.train_batch(schedule_cls, args.mubatches,
                                   batch_id, train_ds)
        _sync(device)   # the epoch's time is the device's work
        epoch_s = time.time() - t_epoch
        metrics.epoch(epoch, accuracy, n_batches * args.batch_size, epoch_s)
        if live_mon is not None and n_batches:
            live_mon.observe("step_ms", epoch_s * 1e3 / n_batches,
                             count=n_batches)
        if monitor is not None:
            # the last batch's pack and the verdicts, once an epoch
            # (the MLP driver has no step lines)
            for v in monitor.observe(epoch, None,
                                     engine.health_snapshot()):
                rprint(str(v))
            metrics.log(event="health", step=epoch,
                        **monitor.step_fields())
        if telem is not None:
            if (args.telemetry == "spans" and staged is None
                    and args.pp > 1):
                # the VM's fenced per-instruction spans are the executed
                # schedule: replay the last batch's on its dataflow
                ops = span_replay_ops(tracer().events_since(trace_mark),
                                      batch=n_batches - 1)
                if ops:
                    telem.set_bubble(bubble_measured=replay_trace(
                        ops, args.pp)["bubble_fraction"])
            tf = telem.step_fields()
            metrics.log(event="telemetry", epoch=epoch, **tf)
            if "bubble_measured" in tf:
                rprint(f"  telemetry: bubble measured "
                       f"{tf['bubble_measured']:.1%} vs static "
                       f"{tf.get('bubble_static', 0.0):.1%}  "
                       f"hbm {tf.get('hbm_live_mib', 0):,.0f} MiB")
        t_save = time.time()
        if args.save_dir and monitor is not None \
                and monitor.unhealthy():
            # never checkpoint a poisoned iterate
            rprint(f"epoch {epoch}: health is "
                   f"{monitor.heartbeat_status()!r} — skipping "
                   f"checkpoint save")
            ledger.note("ckpt_save_skipped_unhealthy", count=1)
        elif args.save_dir:
            try:
                checkpoint.save(args.save_dir, engine, epoch)
            except (checkpoint.CheckpointError, OSError) as e:
                if D.process_count() > 1:
                    # the peers already wait in the save's barrier:
                    # carrying on here would wedge them; raise and
                    # let every process stop
                    raise
                # atomic rename: latest() still points at the
                # previous checkpoint — keep training
                rprint(f"warning: checkpoint save failed ({e}); the "
                       f"previous checkpoint remains the restore point")
                ledger.note("ckpt_save_failed", count=1)
        if args.save_dir:
            ledger.note("ckpt_save", seconds=time.time() - t_save)


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
