"""fp8-e4m3 forward-matmul training — counterpart of
`shallowspeed_tpu/fp8.py`.

A minimal single-device trainer (a dense ReLU MLP with an MSE head)
whose forward matmuls run in fp8-e4m3 through `ops.matmul.fp8_dense`:

- activations quantized with a DELAYED per-tensor scale: this step's
  per-layer input absmaxes only feed the NEXT steps' scales, through a
  rolling 16-step amax history carried like optimizer state and seeded
  at 1.0 (the Transformer-Engine recipe); weights with a just-in-time
  per-out-channel scale;
- the backward is fp8_dense's straight-through VJP, gradients f32 end
  to end, parameters and optimizer state f32 masters;
- the numerics pack: per-layer overflow/underflow fractions at every
  activation quantize (`ops.matmul.fp8_clamp_stats`) with the amax and
  scale series (`fp8_amax`, `fp8_scale`, `fp8_overflow`,
  `fp8_underflow`) ride the health pack of every step, on the device
  until a snapshot fetches them;
- shadow parity (`shadow_parity`): the quantized loss and gradients
  against a frozen f32 oracle on the same batch, no state update;
- the bf16 fallback (`fallback_bf16`): later steps run the
  master-precision matmuls while the amax history keeps rolling (the
  state, the pack keys and the scale series stay as they were).

On the card the fp8 products run the hand-written e4m3 GEMM of
`csrc/blocked_matmul.cu`; the oracle's and the backward's products are
f32 `torch.matmul` (TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.ops.matmul import (E4M3_MAX, fp8_clamp_stats,
                                               fp8_dense)
from shallowspeed_tpu_torch.telemetry.health import (engine_snapshot,
                                                     grad_health, note_step,
                                                     snapshot,
                                                     update_health)
from shallowspeed_tpu_torch.weights import leaves, params_from_numpy

# rolling absmax window (steps) behind the delayed activation scale
AMAX_HISTORY = 16

# "fp8": the quantized forward matmuls; "bf16": the master-precision
# fallback the numerics guard escalates to (everything else unchanged)
PRECISION_MODES = ("fp8", "bf16")


def init_fp8_mlp(sizes, seed: int = 0) -> dict:
    """f32 master params of a dense ReLU MLP as numpy arrays, the
    reference's draw: He-scaled weights, zero biases. `sizes` is
    [d_in, hidden..., d_out]."""
    rng = np.random.default_rng(seed)
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = rng.standard_normal((fan_in, fan_out)) * np.sqrt(2.0 / fan_in)
        layers.append({"W": w.astype(np.float32),
                       "b": np.zeros((fan_out,), np.float32)})
    return {"layers": layers}


def _mse(pred, y):
    return torch.mean(torch.square(pred - y))


class Fp8TrainEngine:
    """Single-device fp8 forward-matmul trainer on `device` (the card
    unless the caller names another)."""

    def __init__(self, sizes, optimizer, seed: int = 0,
                 precision: str = "fp8", device=None):
        if precision not in PRECISION_MODES:
            raise ValueError(
                f"unsupported precision={precision!r}; expected one of "
                f"{PRECISION_MODES} (fp8 = quantized forward matmuls, "
                f"bf16 = the master-precision fallback path)")
        if len(sizes) < 2 or any(int(s) < 1 for s in sizes):
            raise ValueError(
                f"sizes must be [d_in, hidden..., d_out] with positive "
                f"dims, got {list(sizes)!r}")
        self.sizes = list(sizes)
        self.opt = optimizer
        self.precision = precision
        self.device = resolve_device(device)
        self.params = params_from_numpy(init_fp8_mlp(sizes, seed),
                                        self.device)
        for p in leaves(self.params):
            p.requires_grad_(True)
        self.opt_state = optimizer.init(self.params)
        # seeded at 1.0 (scale ~ 1/448): conservative for O(1)
        # activations, and never zero
        self.amax_hist = torch.ones((len(sizes) - 1, AMAX_HISTORY),
                                    dtype=torch.float32, device=self.device)
        self.last_health = None

    # ------------------------------------------------------- the step

    def _forward(self, params, scales, x):
        """(prediction, per-layer input absmaxes, per-layer overflow and
        underflow fractions). The absmax is measured on the f32 input of
        each quantized matmul (what FUTURE steps' scales come from); the
        clamp stats describe what the clip did to THIS step's
        operands."""
        h = x
        amaxes, overflows, underflows = [], [], []
        n = len(params["layers"])
        for i, layer in enumerate(params["layers"]):
            hd = h.detach()
            amaxes.append(torch.amax(torch.abs(hd)))
            over, under = fp8_clamp_stats(hd, scales[i])
            overflows.append(over)
            underflows.append(under)
            h = fp8_dense(h, layer["W"], scales[i]) + layer["b"]
            if i < n - 1:
                h = torch.relu(h)
        return (h, torch.stack(amaxes), torch.stack(overflows),
                torch.stack(underflows))

    def _oracle_forward(self, params, x):
        """The frozen master-precision forward: the same layers with f32
        matmuls and no quantize (the parity oracle and the fallback
        step's path); absmaxes still measured so the history rolls."""
        h = x
        amaxes = []
        n = len(params["layers"])
        for i, layer in enumerate(params["layers"]):
            amaxes.append(torch.amax(torch.abs(h.detach())))
            h = h @ layer["W"] + layer["b"]
            if i < n - 1:
                h = torch.relu(h)
        return h, torch.stack(amaxes)

    @staticmethod
    def _scales(amax_hist):
        """Delayed per-tensor activation scales: the window max over the
        amax history, floored away from zero."""
        return torch.clamp(torch.amax(amax_hist, dim=1) / E4M3_MAX,
                           min=1e-12)

    def _place(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a, np.float32))
        return t.to(self.device, torch.float32)

    def _value_and_grad(self, forward, x, y):
        with torch.enable_grad():
            out = forward(x)
            loss = _mse(out[0], y)
            grads = torch.autograd.grad(loss, list(leaves(self.params)))
        it = iter(grads)
        tree = {"layers": [{k: next(it) for k in layer}
                           for layer in self.params["layers"]]}
        return loss.detach(), tree, [o.detach() for o in out[1:]]

    def _update(self, grads, amaxes):
        """The optimizer step, the rolled history and the pack's health
        part (before / after the update)."""
        pack = grad_health(self.params, grads)
        old = snapshot(self.params)
        self.params, self.opt_state = self.opt.step(self.params, grads,
                                                    self.opt_state)
        pack = update_health(pack, old, self.params)
        # roll the window: slot 0 is this step's measurement
        hist = torch.roll(self.amax_hist, 1, dims=1)
        hist[:, 0] = amaxes
        self.amax_hist = hist
        return pack

    def train_batch(self, x, y) -> float:
        """One step on (x, y) under the current precision; returns the
        loss (a host sync)."""
        x, y = self._place(x), self._place(y)
        scales = self._scales(self.amax_hist)
        if self.precision == "bf16":
            loss, grads, (amaxes,) = self._value_and_grad(
                lambda a: self._oracle_forward(self.params, a), x, y)
            pack = self._update(grads, amaxes)
            zeros = torch.zeros_like(scales)
            over = under = zeros
        else:
            loss, grads, (amaxes, over, under) = self._value_and_grad(
                lambda a: self._forward(self.params, scales, a), x, y)
            pack = self._update(grads, amaxes)
        pack["fp8_amax"] = amaxes
        pack["fp8_scale"] = scales
        pack["fp8_overflow"] = over
        pack["fp8_underflow"] = under
        note_step(self, pack)
        return float(loss)

    def fallback_bf16(self) -> None:
        """Switch later steps to the master-precision fallback — the
        guard escalation's middle rung. Idempotent."""
        self.precision = "bf16"

    def shadow_parity(self, x, y) -> dict:
        """The quantized loss and gradients against the frozen f32
        oracle's on `(x, y)`, no state update: {"parity_loss_rel",
        "parity_grad_relmax" (the worst leaf's max |dq - do| /
        max |do|)} as host floats."""
        x, y = self._place(x), self._place(y)
        scales = self._scales(self.amax_hist)
        ql, qg, _ = self._value_and_grad(
            lambda a: self._forward(self.params, scales, a), x, y)
        ol, og, _ = self._value_and_grad(
            lambda a: self._oracle_forward(self.params, a), x, y)
        loss_rel = torch.abs(ql - ol) / torch.clamp(torch.abs(ol),
                                                   min=1e-12)
        rels = [torch.amax(torch.abs(a - b))
                / torch.clamp(torch.amax(torch.abs(b)), min=1e-12)
                for a, b in zip(leaves(qg), leaves(og))]
        return {"parity_loss_rel": float(loss_rel),
                "parity_grad_relmax": float(torch.amax(torch.stack(rels)))}

    @torch.no_grad()
    def eval_loss(self, x, y) -> float:
        x, y = self._place(x), self._place(y)
        pred = self._forward(self.params, self._scales(self.amax_hist),
                             x)[0]
        return float(_mse(pred, y))

    def health_snapshot(self) -> dict | None:
        return engine_snapshot(self)
