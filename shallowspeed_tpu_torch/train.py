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

The root driver's other flags (the fp8 engine, the overlapped
reduction, the telemetry, health, chaos and profiling planes) are
recognised and refused with `NotPorted`; `--platform` and
`--host-devices` give way to `--device`.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted, checkpoint, resolve_device
from shallowspeed_tpu_torch.data.dataset import Dataset
from shallowspeed_tpu_torch.data.mnist import ensure_mnist
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.metrics import MetricsLogger
from shallowspeed_tpu_torch.models.mlp import MLPStage
from shallowspeed_tpu_torch.optim import OPTIMIZERS
from shallowspeed_tpu_torch.parallel.mesh import make_mesh
from shallowspeed_tpu_torch.parallel.schedules import (GPipeSchedule,
                                                       InferenceSchedule,
                                                       NaiveParallelSchedule,
                                                       PipeDreamSchedule)
from shallowspeed_tpu_torch.parallel.spmd_pipeline import SPMDPipelineEngine
from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor
from shallowspeed_tpu_torch.utils import (assert_replicas_in_sync,
                                          get_model_hash, rprint)

EPOCHS = 20
GLOBAL_BATCH_SIZE = 128
N_MUBATCHES = 4
LAYER_SIZES = [784, 128, 127, 126, 125, 124, 123, 10]
LR = 0.006

SCHEDULES = {"naive": NaiveParallelSchedule, "gpipe": GPipeSchedule,
             "pipedream": PipeDreamSchedule}

_FP8 = "Queue 1 item 4, fp8 training"
_MESH = "Queue 1 item 5, multi-device engines and comm overlap"
_PLANES = "Queue 1 item 6, planes"
_DEVICE = "--device replaces it: every cell of the dp x pp grid runs there"

# the root driver's flags this driver does not have, and where each
# comes from
UNPORTED = {
    **dict.fromkeys(["--shadow-every", "--log-every"], _FP8),
    "--bucket-mb": _MESH,
    **dict.fromkeys(
        ["--health", "--telemetry", "--trace-dir", "--chaos",
         "--chaos-state", "--chaos-seed", "--profile-dir", "--profile",
         "--profile-hz", "--monitor-port", "--slo", "--flight-recorder",
         "--heartbeat-file", "--replica"], _PLANES),
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
                        "VM; fp8 is not ported")
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--batch-size", type=int, default=GLOBAL_BATCH_SIZE)
    p.add_argument("--mubatches", type=int, default=N_MUBATCHES)
    p.add_argument("--lr", type=float, default=LR)
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "momentum", "adam", "adamw"])
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = off)")
    p.add_argument("--overlap", default="off", choices=["off", "on"],
                   help="the bulk reduction (off) only; on is not ported")
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
    p.add_argument("--device", type=str, default=None,
                   help="the device every cell of the grid runs on "
                        "(default: the GPU; 'cpu' only when asked)")
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
    if args.engine == "fp8":
        raise NotPorted("train --engine fp8", _FP8)
    if args.overlap != "off":
        raise NotPorted("train --overlap on", _MESH)

    mesh = make_mesh(dp, pp, device)
    opt_kw = {"grad_clip": args.grad_clip or None}
    if args.optimizer == "adamw":
        opt_kw["weight_decay"] = args.weight_decay
    optimizer = OPTIMIZERS[args.optimizer](lr=args.lr, **opt_kw)

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
    if kind == "fused":
        stage = MLPStage(LAYER_SIZES, 0, 1, batch_size=args.batch_size)
        engine = FusedDPEngine(stage, optimizer, mesh)
    elif kind == "spmd":
        engine = SPMDPipelineEngine(LAYER_SIZES, optimizer, mesh,
                                    args.mubatches, mubatch_size,
                                    args.batch_size)
    else:
        stages = [MLPStage(LAYER_SIZES, s, pp, batch_size=args.batch_size)
                  for s in range(pp)]
        engine = PipelineExecutor(mesh, stages, optimizer)
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


def train(args):
    """Run the configured training; returns (final validation accuracy,
    the trained engine)."""
    device = resolve_device(args.device)
    schedule_cls = SCHEDULES[args.schedule]
    engine, train_ds, val_ds = build(args, device)
    n_batches = train_ds[0].get_num_batches()
    if args.max_batches:
        n_batches = min(n_batches, args.max_batches)
    start_epoch = _restore(args, engine)
    metrics = MetricsLogger(
        args.log_file, dp=args.dp, pp=args.pp, schedule=args.schedule,
        engine=type(engine).__name__, batch_size=args.batch_size,
        device=str(device))
    # fused / spmd engines: the epoch's batches placed on the device
    # once, each epoch stepped with no host copy per batch
    staged = (engine.stage_epoch(train_ds, n_batches)
              if hasattr(engine, "train_epoch") else None)
    start = time.time()
    try:
        for epoch in range(start_epoch, args.epochs):
            accuracy = compute_accuracy(engine, val_ds)
            rprint(f"Epoch: {epoch}, Time Spent: {time.time() - start:.2f}s, "
                   f"Accuracy: {accuracy * 100:.2f}%")
            t_epoch = time.time()
            if staged is not None:
                engine.train_epoch(staged)
            else:
                for batch_id in range(n_batches):
                    engine.train_batch(schedule_cls, args.mubatches,
                                       batch_id, train_ds)
            _sync(device)   # the epoch's time is the device's work
            metrics.epoch(epoch, accuracy, n_batches * args.batch_size,
                          time.time() - t_epoch)
            if args.save_dir:
                try:
                    checkpoint.save(args.save_dir, engine, epoch)
                except (checkpoint.CheckpointError, OSError) as e:
                    # atomic rename: latest() still points at the
                    # previous checkpoint — keep training
                    rprint(f"warning: checkpoint save failed ({e}); the "
                           f"previous checkpoint remains the restore point")

        accuracy = compute_accuracy(engine, val_ds)
        rprint(f"Epoch: {args.epochs}, Time Spent: "
               f"{time.time() - start:.2f}s, Accuracy: {accuracy * 100:.2f}%")
        metrics.final(accuracy, time.time() - start)
    finally:
        metrics.close()
    # DP replicas hold bit-identical weights (the reference's closing
    # hash check)
    assert_replicas_in_sync(engine.replicas())
    rprint(f"model hash: {get_model_hash(engine.params)}")
    return accuracy, engine


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
