"""Optimizers — counterpart of `shallowspeed_tpu/optim.py`.

Same interface as the reference: `init(params) -> state` and
`step(params, grads, state) -> (params, state)` over a parameter tree
(nested dicts and lists of tensors), with `lr` a float or a schedule
(a callable of the 0-based step counter carried in the state) and
optional global-norm clipping before the update. The update formulas
are the reference's term for term, so a trajectory agrees with the JAX
package's to rounding; `torch.optim` is not used because its rounding
order differs.

Unlike the reference, `step` updates the parameter and moment tensors
IN PLACE (they are large, and nothing else holds them) and returns the
same objects; the step counter `t` is a Python int and the schedule is
evaluated on the host in float32, as the reference traces it.
`map_state_trees` re-lays every params-shaped moment tree with an
engine's params transform, for checkpoints' canonical optimizer
record. Adafactor is not ported yet and raises `NotPorted`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch.weights import leaves, map_tree

_F32 = np.float32

# ------------------------------------------------------------- schedules


def constant(peak: float, warmup: int = 0, total: int = 0, end: float = 0.0):
    """Constant schedule (warmup/total/end accepted and ignored, so
    every SCHEDULES entry is built the same way)."""
    return lambda t: float(_F32(peak))


def warmup_linear(peak: float, warmup: int, total: int, end: float = 0.0):
    """Linear 0 -> peak over `warmup` steps, then linear peak -> end at
    `total` steps (clamped after); float32 arithmetic."""
    def sched(t):
        t = _F32(t)
        up = _F32(peak) * t / _F32(max(warmup, 1))
        frac = np.clip((t - _F32(warmup)) / _F32(max(total - warmup, 1)),
                       _F32(0.0), _F32(1.0))
        down = _F32(peak) + _F32(end - peak) * frac
        return float(up if t < warmup else down)

    return sched


def warmup_cosine(peak: float, warmup: int, total: int, end: float = 0.0):
    """Linear 0 -> peak over `warmup` steps, then cosine peak -> end at
    `total` steps (clamped after); float32 arithmetic."""
    def sched(t):
        t = _F32(t)
        up = _F32(peak) * t / _F32(max(warmup, 1))
        frac = np.clip((t - _F32(warmup)) / _F32(max(total - warmup, 1)),
                       _F32(0.0), _F32(1.0))
        down = _F32(end) + _F32((peak - end) * 0.5) * (
            _F32(1.0) + np.cos(_F32(math.pi) * frac))
        return float(up if t < warmup else down)

    return sched


SCHEDULES = {"constant": constant, "linear": warmup_linear,
             "cosine": warmup_cosine}

# -------------------------------------------------------------- clipping


def global_norm(grads) -> torch.Tensor:
    """L2 norm over every leaf of the gradient tree, accumulated in
    float32; a 0-dim tensor on the leaves' device (no host sync)."""
    total = None
    for g in leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scale the whole tree so its global norm is at most `max_norm`
    (scale = min(1, max_norm / (norm + 1e-12))). In place; returns the
    tree."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads


# ------------------------------------------------------------ optimizers


class _Optimizer:
    """Shared lr / schedule / clipping plumbing."""

    def __init__(self, lr, grad_clip: float | None = None):
        self.lr = lr
        self.grad_clip = grad_clip

    def _lr_at(self, t: int) -> float:
        if callable(self.lr):
            return float(_F32(self.lr(t)))
        return float(_F32(self.lr))

    def _prep(self, grads):
        if self.grad_clip is not None:
            return clip_by_global_norm(grads, self.grad_clip)
        return grads

    def map_state_trees(self, state, fn):
        """Apply `fn` — a params-shaped tree -> params-shaped tree
        transform (an engine's re-layout between its params and the
        canonical checkpoint layout) — to every params-shaped moment
        tree inside `state`, passing step counters through. The seam
        that makes optimizer state engine-agnostic in checkpoints
        (`checkpoint.py`'s `opt_canon.npz`). Default: no params-shaped
        trees (SGD)."""
        return state


class SGD(_Optimizer):
    """Plain SGD: p - lr * g. Stateless with a static lr; carries a step
    counter only when driven by a schedule."""

    def init(self, params):
        return {"t": 0} if callable(self.lr) else ()

    @torch.no_grad()
    def step(self, params, grads, state=()):
        grads = self._prep(grads)
        sched = callable(self.lr)
        t = state["t"] if sched else 0
        lr = self._lr_at(t)
        for p, g in zip(leaves(params), leaves(grads)):
            p.sub_((lr * g).to(p.dtype))
        return params, ({"t": t + 1} if sched else state)


class MomentumSGD(_Optimizer):
    """SGD with classical momentum: v = momentum v + g; p - lr v."""

    def __init__(self, lr, momentum: float = 0.9,
                 grad_clip: float | None = None):
        super().__init__(lr, grad_clip)
        self.momentum = momentum

    def init(self, params):
        vel = map_tree(torch.zeros_like, params)
        return {"v": vel, "t": 0} if callable(self.lr) else vel

    @torch.no_grad()
    def step(self, params, grads, state):
        grads = self._prep(grads)
        sched = callable(self.lr)
        vel = state["v"] if sched else state
        t = state["t"] if sched else 0
        lr = self._lr_at(t)
        for p, g, v in zip(leaves(params), leaves(grads), leaves(vel)):
            v.mul_(self.momentum).add_(g.to(v.dtype))
            p.sub_((lr * v).to(p.dtype))
        return params, ({"v": vel, "t": t + 1} if sched else vel)

    def map_state_trees(self, state, fn):
        if isinstance(state, dict) and "v" in state:
            return {"v": fn(state["v"]), "t": state["t"]}
        return fn(state)


class Adam(_Optimizer):
    """Adam with bias correction; AdamW adds decoupled weight decay."""

    weight_decay = 0.0

    def __init__(self, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, grad_clip: float | None = None):
        super().__init__(lr, grad_clip)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"m": map_tree(torch.zeros_like, params),
                "v": map_tree(torch.zeros_like, params), "t": 0}

    @torch.no_grad()
    def step(self, params, grads, state):
        grads = self._prep(grads)
        lr = self._lr_at(state["t"])        # schedule indexed 0-based
        t = state["t"] + 1
        b1, b2 = self.b1, self.b2
        bc1 = float(_F32(1.0) - _F32(b1) ** _F32(t))
        bc2 = float(_F32(1.0) - _F32(b2) ** _F32(t))
        wd = self.weight_decay
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), leaves(state["v"])):
            # m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if wd:
                upd = upd + wd * p
            p.sub_((lr * upd).to(p.dtype))
        return params, {"m": state["m"], "v": state["v"], "t": t}

    def map_state_trees(self, state, fn):
        return {"m": fn(state["m"]), "v": fn(state["v"]), "t": state["t"]}


class AdamW(Adam):
    """Adam with decoupled weight decay: p - lr (m^/(sqrt(v^) + eps) +
    wd p) on every leaf, norms included (torch.optim.AdamW semantics,
    the reference's rounding order)."""

    def __init__(self, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 grad_clip: float | None = None):
        super().__init__(lr, b1, b2, eps, grad_clip)
        self.weight_decay = weight_decay


class Adafactor(_Optimizer):
    def __init__(self, *args, **kwargs):
        raise NotPorted("the Adafactor optimizer",
                        "Queue 1, training features after slice 2")


OPTIMIZERS = {"sgd": SGD, "momentum": MomentumSGD, "adam": Adam,
              "adamw": AdamW, "adafactor": Adafactor}


# ------------------------------------------------------------------- EMA


@torch.no_grad()
def ema_update(ema, params, decay):
    """One exponential-moving-average step, in place: ema <- d*ema +
    (1-d)*params in float32 (d = float32(decay)), the reference's
    `ema_update` term for term. Returns `ema`. The driver owns the
    average and evaluates or samples by swapping it into the engine."""
    d = _F32(decay)
    one_minus = float(_F32(1.0) - d)
    for e, p in zip(leaves(ema), leaves(params)):
        e.copy_(e * float(d) + p.float() * one_minus)
    return ema


def ema_init(params):
    """Start the average AT the current params (a copy; an all-zeros
    start would bias early evals toward zero)."""
    return map_tree(lambda p: p.detach().clone(), params)
