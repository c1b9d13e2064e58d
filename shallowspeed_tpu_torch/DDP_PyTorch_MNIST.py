"""Self-contained PyTorch DP baseline — the port's counterpart of
`scripts/DDP_PyTorch_MNIST.py`: an independent implementation (plain
`torch.nn`, none of this package's engines) of data-parallel MNIST-MLP
training, compared against serial training by the absolute weight
divergence, the source paper's strongest equivalence check.

    python -m shallowspeed_tpu_torch.DDP_PyTorch_MNIST [--ranks 4]
        [--epochs 5] [--batch-size 128] [--lr 1e-3]
        [--data-dir data/mnist_784] [--device cpu]

As in the root script, the DP ranks live in one process: each holds a
model replica (784 -> 64 -> 64 -> 10, `torch.manual_seed(0)`, drawn on
the CPU and then moved) and computes the gradient of its strided shard
of each global batch, the loss scaled by 1 / ranks; the gradients are
summed across the replicas (the reference's blocking all-reduce) and
every replica takes the same Adam step. The replicas are asserted
identical after every epoch. The data is this package's synthetic MNIST
(`data.mnist.ensure_mnist`), written into `--data-dir` when it is
absent. Runs on the card unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.data.mnist import ensure_mnist


class MLP(torch.nn.Module):
    """The reference topology 784 -> 64 -> 64 -> 10, drawn from
    `torch.manual_seed(0)` on the CPU."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.net = torch.nn.Sequential(
            torch.nn.Linear(784, 64), torch.nn.ReLU(),
            torch.nn.Linear(64, 64), torch.nn.ReLU(),
            torch.nn.Linear(64, 10),
        )

    def forward(self, x):
        return self.net(x)


def load_data(data_dir, device):
    """(x_train, y_train, x_val, y_val) on `device`, labels as ints."""
    arrays = [np.load(Path(data_dir) / f) for f in
              ("x_train.npy", "y_train.npy", "x_val.npy", "y_val.npy")]
    arrays[1], arrays[3] = arrays[1].argmax(1), arrays[3].argmax(1)
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def accuracy(model, x, y) -> float:
    with torch.no_grad():
        return (model(x).argmax(1) == y).float().mean().item()


def train_serial(x, y, epochs, gbs, lr):
    """One model, Adam, `epochs` passes over the whole global batches."""
    model = MLP().to(x.device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    loss_fn = torch.nn.CrossEntropyLoss()
    n = len(x) - len(x) % gbs
    for _ in range(epochs):
        for b in range(n // gbs):
            xb, yb = x[b * gbs:(b + 1) * gbs], y[b * gbs:(b + 1) * gbs]
            opt.zero_grad()
            loss_fn(model(xb), yb).backward()
            opt.step()
    return model


def train_ddp(x, y, epochs, gbs, lr, ranks):
    """`ranks` replicas, each on its strided shard, the gradients summed
    across them every step; the replicas asserted identical at the start
    and after every epoch."""
    if gbs % ranks:
        raise ValueError(f"--batch-size {gbs} does not split over "
                         f"--ranks {ranks}")
    replicas = [MLP().to(x.device) for _ in range(ranks)]
    _check_identical(replicas, "DDP replicas start apart")
    opts = [torch.optim.Adam(m.parameters(), lr=lr) for m in replicas]
    loss_fn = torch.nn.CrossEntropyLoss()
    n = len(x) - len(x) % gbs
    for _ in range(epochs):
        for b in range(n // gbs):
            xb, yb = x[b * gbs:(b + 1) * gbs], y[b * gbs:(b + 1) * gbs]
            for r, (m, o) in enumerate(zip(replicas, opts)):
                o.zero_grad()
                # the 1 / ranks scale and a SUM across replicas: the mean
                # over the global batch
                (loss_fn(m(xb[r::ranks]), yb[r::ranks]) / ranks).backward()
            for params in zip(*(m.parameters() for m in replicas)):
                total = sum(p.grad for p in params)
                for p in params:
                    p.grad = total.clone()
            for o in opts:
                o.step()
        _check_identical(replicas, "DDP replicas diverged")
    return replicas[0]


def _check_identical(replicas, what) -> None:
    for r in replicas[1:]:
        for p0, pr in zip(replicas[0].parameters(), r.parameters()):
            if not torch.equal(p0, pr):
                raise AssertionError(what)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--data-dir", default="data/mnist_784")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def _timed(fn, device):
    t0 = time.time()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.time() - t0


def main(argv=None) -> dict:
    """Train serially and as DDP, print the root script's three lines,
    and return their numbers."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.set_num_threads(1)     # as the source paper's script
    x_tr, y_tr, x_va, y_va = load_data(ensure_mnist(Path(args.data_dir)),
                                       device)
    serial, t_serial = _timed(lambda: train_serial(
        x_tr, y_tr, args.epochs, args.batch_size, args.lr), device)
    acc_serial = accuracy(serial, x_va, y_va)
    print(f"serial: {t_serial:.2f}s, test accuracy {acc_serial * 100:.2f}%")
    ddp, t_ddp = _timed(lambda: train_ddp(
        x_tr, y_tr, args.epochs, args.batch_size, args.lr, args.ranks),
        device)
    acc_ddp = accuracy(ddp, x_va, y_va)
    print(f"ddp x{args.ranks}: {t_ddp:.2f}s, "
          f"test accuracy {acc_ddp * 100:.2f}%")
    div = max((a - b).abs().max().item()
              for a, b in zip(serial.parameters(), ddp.parameters()))
    print(f"max abs weight divergence vs serial: {div:.3e}")
    return {"serial_s": t_serial, "serial_accuracy": acc_serial,
            "ddp_s": t_ddp, "ddp_accuracy": acc_ddp, "ranks": args.ranks,
            "divergence": div, "device": str(device)}


if __name__ == "__main__":
    main()
