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
record (Adafactor's factored state has none, and raises there, as
the reference's does).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shallowspeed_tpu_torch.weights import leaves, map_tree, sorted_leaves

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
    """Shared lr / schedule / clipping plumbing. `step` clips (unless
    `clip=False`: a caller that clipped the whole tree already, such as
    ZeRO's sharded update over slices) and hands the tree to the
    subclass's `_update`. `elementwise` says whether the update of each
    element reads that element's gradient and state only, so that it
    can run on any slice of the tree (`parallel/zero.py`)."""

    elementwise = True

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

    @torch.no_grad()
    def step(self, params, grads, state=(), clip: bool = True):
        """One update of `params` and `state` in place by `grads`,
        clipped first unless `clip` is False; returns (params, state)."""
        return self._update(params, self._prep(grads) if clip else grads,
                            state)

    def map_state_trees(self, state, fn):
        """Apply `fn` — a params-shaped tree -> params-shaped tree
        transform (an engine's re-layout between its params and the
        canonical checkpoint layout) — to every params-shaped moment
        tree inside `state`, passing step counters through. The seam
        that makes optimizer state engine-agnostic in checkpoints
        (`checkpoint.py`'s `opt_canon.npz`). Default: no params-shaped
        trees (SGD)."""
        return state

    @torch.no_grad()
    def guarded_step(self, params, grads, state, ok, old_params=None,
                     clip: bool = True):
        """`step` with the whole update gated on `ok`: when it is false
        every parameter and every optimizer-state leaf — moments,
        Adafactor's factored slots, the step counter — keeps its old
        value bit for bit, so a skipped step is indistinguishable from
        never having run (the health layer's `skip_step` guard).

        `ok` is a 0-d bool tensor on the device (the health pack's
        `nonfinite == 0`): the tensors are snapshotted, updated in
        place and put back with `torch.where`, no host branch.
        `old_params`, bit-exact copies of the parameters in JAX leaf
        order (`telemetry.health.snapshot`, which the health pack takes
        anyway), stand in for the parameters' own snapshot. The step
        counter is a host int, so an optimizer whose state carries one
        reads `ok` once, after the update's kernels are queued (the
        card keeps running them while the host waits). A host bool `ok`
        (the pipeline VM decides once per batch on the host) skips the
        update outright."""
        if not isinstance(ok, torch.Tensor):
            return self.step(params, grads, state, clip=clip) if ok \
                else (params, state)
        # every optimizer here updates its tensors in place, so the
        # snapshot pairs each tensor with its own old value
        if old_params is None:
            pairs = [(t, t.clone()) for t in leaves(params)
                     if isinstance(t, torch.Tensor)]
        else:
            pairs = list(zip(sorted_leaves(params), old_params))
        pairs += [(t, t.clone()) for t in leaves(state)
                  if isinstance(t, torch.Tensor)]
        params, new_state = self.step(params, grads, state, clip=clip)
        for t, o in pairs:
            t.copy_(torch.where(ok.to(t.device), t, o))
        if isinstance(new_state, dict) and "t" in new_state \
                and not bool(ok):
            new_state = {**new_state, "t": state["t"]}
        return params, new_state


class SGD(_Optimizer):
    """Plain SGD: p - lr * g. Stateless with a static lr; carries a step
    counter only when driven by a schedule."""

    def init(self, params):
        return {"t": 0} if callable(self.lr) else ()

    def _update(self, params, grads, state=()):
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

    def _update(self, params, grads, state):
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

    def _update(self, params, grads, state):
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
    """Adafactor (Shazeer & Stern, 2018), the reference's term for term:
    leaves with ndim >= 2 keep factored second moments over their
    trailing two dims (a row vector vr and a column vector vc; leading
    dims, such as MoE experts, stay elementwise), the others a full v.
    beta2 follows 1 - t^(-decay_pow); the update is RMS-clipped at
    `clip_threshold`; `scale_parameter` multiplies the step by
    max(eps_scale, RMS(p)), so `lr` is a relative step size; the first
    moment (beta1 > 0) is optional; decoupled decay uses the same
    scaled step. On one device every leaf is unsharded, so every leaf
    with ndim >= 2 factors; a parallel engine passes its placement
    (`init(params, specs)`) and a leaf sharded on its trailing two dims
    keeps a full v, as the reference decides. Its row and column statistics, the update's
    RMS and the parameter's RMS reduce over whole leaves, so it is not
    `elementwise`: ZeRO gathers a leaf's slices before this update.

    The state is {"slots": tuple of per-leaf dicts ({"vr", "vc"} or
    {"v"}, plus "m" with beta1), "t": step}, the slots in the JAX
    package's leaf order (`weights.sorted_leaves`), so that the state
    crosses packages and checkpoints as it is."""

    elementwise = False

    def __init__(self, lr, beta1: float = 0.0, decay_pow: float = 0.8,
                 eps: float = 1e-30, eps_scale: float = 1e-3,
                 clip_threshold: float = 1.0, scale_parameter: bool = True,
                 weight_decay: float = 0.0, grad_clip: float | None = None):
        super().__init__(lr, grad_clip)
        self.beta1 = beta1
        self.decay_pow = decay_pow
        self.eps = eps
        self.eps_scale = eps_scale
        self.clip_threshold = clip_threshold
        self.scale_parameter = scale_parameter
        self.weight_decay = weight_decay

    @staticmethod
    def factored(p, spec=None) -> bool:
        """Whether leaf `p` keeps factored moments: ndim >= 2 and, when
        the leaf has a placement `spec` (per dimension an axis name or
        None, `parallel.gspmd.P`), its trailing two dims unsharded — the
        reference's `_factored`: Megatron's column- and row-sharded
        matrices and FSDP's sharded ones keep a full v."""
        if p.dim() < 2:
            return False
        if spec is None:
            return True
        entries = tuple(spec) + (None,) * (p.dim() - len(tuple(spec)))
        return entries[-1] is None and entries[-2] is None

    def _slot(self, p, spec=None):
        f32 = dict(dtype=torch.float32, device=p.device)
        if self.factored(p, spec):
            slot = {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        else:
            slot = {"v": torch.zeros(p.shape, **f32)}
        if self.beta1 > 0.0:
            slot["m"] = torch.zeros(p.shape, **f32)
        return slot

    def init(self, params, specs=None):
        """Zero state; `specs`, a tree of placement specs matching
        `params` (the parallel engines'), decides which leaves factor."""
        ps = list(sorted_leaves(params))
        ss = [None] * len(ps) if specs is None else list(sorted_leaves(specs))
        return {"slots": tuple(self._slot(p, s) for p, s in zip(ps, ss)),
                "t": 0}

    def _update(self, params, grads, state):
        lr = self._lr_at(state["t"])
        t = state["t"] + 1
        beta2 = _F32(1.0) - _F32(t) ** _F32(-self.decay_pow)
        b2, one_b2 = float(beta2), float(_F32(1.0) - beta2)
        b1, one_b1 = self.beta1, float(_F32(1.0) - _F32(self.beta1))
        for p, g, slot in zip(sorted_leaves(params), sorted_leaves(grads),
                              state["slots"]):
            gf = g.float()
            g2 = gf * gf + self.eps
            if "vr" in slot:
                vr = b2 * slot["vr"] + one_b2 * g2.mean(dim=-1)
                vc = b2 * slot["vc"] + one_b2 * g2.mean(dim=-2)
                slot["vr"].copy_(vr)
                slot["vc"].copy_(vc)
                # v^ = (vr / mean(vr)) x vc, the rank-1 reconstruction
                rfac = vr / vr.mean(dim=-1, keepdim=True)
                u = gf * torch.rsqrt(rfac[..., :, None] * vc[..., None, :])
            else:
                v = b2 * slot["v"] + one_b2 * g2
                slot["v"].copy_(v)
                u = gf * torch.rsqrt(v)
            rms_u = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms_u / self.clip_threshold, min=1.0)
            pf = p.float()
            if b1 > 0.0:
                m = b1 * slot["m"] + one_b1 * u
                slot["m"].copy_(m)
                u = m
            if self.scale_parameter:    # a 0-d f32 tensor: no host sync
                a = lr * torch.clamp(torch.sqrt(torch.mean(pf * pf)),
                                     min=self.eps_scale)
                a_wd = a * self.weight_decay
            else:
                a, a_wd = lr, float(_F32(lr) * _F32(self.weight_decay))
            upd = a * u + a_wd * pf
            p.copy_((pf - upd).to(p.dtype))
        return params, {"slots": state["slots"], "t": t}

    def map_state_trees(self, state, fn):
        raise ValueError(
            "Adafactor state is factored (per-leaf vr/vc vectors keyed to "
            "the flattened engine params), not params-shaped; it cannot "
            "be re-laid-out by a params-tree transform. Engines whose "
            "layout IS canonical interchange it directly.")


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
