"""Stage-partitioned MLP with a manual backward — counterpart of
`shallowspeed_tpu/models/mlp.py`.

- Parameters are a list of {"W": (out, in), "b": (1, out)} dicts per
  stage; grads are *returned* by `backward`, never stored on the
  tensors (no autograd: the explicit stash and the summed-gradient
  contract are the design).
- `forward` returns an explicit **stash** (per-Linear inputs and ReLU
  masks, the head's logits and probs) that `backward` consumes, so a
  pipeline keeps several microbatches in flight.
- Deterministic dims-keyed init: each Linear's weights are drawn on the
  host from `MT19937(SeedSequence(in + out * 1337))`, so every stage of
  every (dp, pp) layout, in either package, gets the same bits.
- Stage slicing with a one-dim overlap; the last stage ends in
  Softmax + MSELoss, and its backward takes the *target*.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.random import MT19937, RandomState, SeedSequence

from shallowspeed_tpu_torch.ops import functional as F


def stage_layer_sizes(sizes: list[int], stage_idx: int, n_stages: int) -> list[int]:
    """The layer-size slice owned by `stage_idx`, overlapping one
    boundary dim: `len(sizes) % n_stages == 0`; interior stages own
    `len(sizes) // n_stages` Linears and the last stage one fewer."""
    assert len(sizes) % n_stages == 0, (len(sizes), n_stages)
    stage_size = len(sizes) // n_stages
    lo = stage_idx * stage_size
    hi = min(len(sizes), lo + stage_size + 1)
    return sizes[lo:hi]


def init_linear_np(in_dims: int, out_dims: int) -> dict[str, np.ndarray]:
    """Host-side deterministic init for one Linear, keyed only by its
    dims: the same weights however the model is partitioned."""
    rs = RandomState(MT19937(SeedSequence(in_dims + out_dims * 1337)))
    w = (rs.normal(0.0, 1.0, (out_dims, in_dims)).astype(np.float32)
         / np.sqrt(in_dims)).astype(np.float32)
    b = np.zeros((1, out_dims), dtype=np.float32)
    return {"W": w, "b": b}


def init_stage_params(sizes: list[int], stage_idx: int = 0,
                      n_stages: int = 1) -> list[dict[str, np.ndarray]]:
    """Parameters of one pipeline stage (host numpy; the engines place
    them)."""
    local = stage_layer_sizes(sizes, stage_idx, n_stages)
    return [init_linear_np(local[i], local[i + 1]) for i in range(len(local) - 1)]


def accumulate_grads(acc, new):
    """Sum-accumulate a stage's gradients in place (acc += new)."""
    for a, g in zip(acc, new):
        a["W"].add_(g["W"])
        a["b"].add_(g["b"])
    return acc


class MLPStage:
    """One pipeline stage of the partitioned MLP: static structure
    only; params and stash flow through arguments and return values.

    Interior stage: [Linear+ReLU] * k.
    Last stage:     [Linear+ReLU] * (k-1), Linear (no act), Softmax,
                    MSELoss. MSELoss's forward is the identity, so the
                    stage's forward output is the softmax probabilities.
    """

    def __init__(self, sizes: list[int], stage_idx: int, n_stages: int,
                 batch_size: int):
        self.sizes = list(sizes)
        self.stage_idx = stage_idx
        self.n_stages = n_stages
        self.batch_size = batch_size  # GLOBAL batch size
        self.local_sizes = stage_layer_sizes(sizes, stage_idx, n_stages)
        self.is_first_stage = stage_idx == 0
        self.is_last_stage = stage_idx == n_stages - 1
        self.n_linears = len(self.local_sizes) - 1
        self.in_dim = self.local_sizes[0]
        self.out_dim = self.local_sizes[-1]

    def init(self) -> list[dict[str, np.ndarray]]:
        return init_stage_params(self.sizes, self.stage_idx, self.n_stages)

    def forward(self, params, x: torch.Tensor):
        """Returns (out, stash): one stash entry per Linear — {"x": input}
        plus {"mask": relu bitmask} when it has a ReLU — and on the last
        stage a trailing {"logits", "probs"} entry for the heads."""
        stash = []
        h = x
        for i, layer in enumerate(params):
            entry = {"x": h}
            h = F.linear(h, layer["W"], layer["b"])
            has_relu = not (self.is_last_stage and i == self.n_linears - 1)
            if has_relu:
                entry["mask"] = h > 0
                h = F.relu(h)
            stash.append(entry)
        if self.is_last_stage:
            logits = h
            h = F.softmax(logits)
            stash.append({"logits": logits, "probs": h})
        return h, stash

    def infer(self, params, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode forward: the output only."""
        out, _ = self.forward(params, x)
        return out

    def backward(self, params, stash, dout: torch.Tensor, emit=None):
        """Returns (dx, grads), grads shaped like `params`. On the last
        stage `dout` is the **target** batch: the MSELoss head turns it
        into the upstream gradient (global batch size), then Softmax's
        VJP recomputes from the stashed logits. Layers in reverse; with
        `emit`, each layer's gradients go to `emit(2 i, dW)` and `emit(2
        i + 1, db)` as they are made (`parallel.overlap.mlp_leaf_order`'s
        ids: an overlapped reduction issues each bucket between layer
        VJPs)."""
        if self.is_last_stage:
            head = stash[-1]
            dout = F.mse_loss_grad(head["probs"], dout, self.batch_size)
            dout = F.softmax_grad(dout, head["logits"])
        grads: list = [None] * self.n_linears
        for i in range(self.n_linears - 1, -1, -1):
            entry = stash[i]
            if "mask" in entry:
                dout = F.relu_grad(dout, entry["mask"])
            dout, dw, db = F.linear_grad(dout, entry["x"], params[i]["W"])
            grads[i] = {"W": dw, "b": db}
            if emit is not None:
                emit(2 * i, dw)
                emit(2 * i + 1, db)
        return dout, grads

    def loss(self, params, x: torch.Tensor, target: torch.Tensor):
        """MSE loss value (global batch size). Only valid on the last
        stage of a 1-stage model or fed with last-stage inputs."""
        out, _ = self.forward(params, x)
        return F.mse_loss(out, target, self.batch_size)

    def __repr__(self):
        layers = []
        for i in range(self.n_linears):
            act = "relu" if not (self.is_last_stage and i == self.n_linears - 1) else None
            layers.append(
                f"Linear({self.local_sizes[i]}->{self.local_sizes[i+1]}, act: {act})"
            )
        if self.is_last_stage:
            layers += ["Softmax()", "MSELoss()"]
        return f"MLPStage[{self.stage_idx}/{self.n_stages}]({', '.join(layers)})"
