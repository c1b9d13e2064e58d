"""Training-health pack — counterpart of
`shallowspeed_tpu/telemetry/health.py`, on tensors.

Device side (`grad_health` / `update_health`): after the engine's
gradients are fully reduced, the global and per-group gradient and
parameter L2 norms (f32 accumulation), the non-finite count and the
update-to-parameter ratio, as a small dict of 0-d tensors on the
parameters' device. The pack and the cumulative counters (`note_step`)
stay on the device until `engine_snapshot` fetches them at a log point:
no host sync per step — the port's form of the reference's "zero new
executables".

One process drives every engine of the port, so the reference's
per-leaf `psum` over the mesh axes a leaf's spec shards (`spec_axes`)
becomes a plain sum: a sharded leaf comes as its shards
(`parallel.zero.Slices`), whose statistics are summed in rank order. The pipeline VM keeps one
LOCAL pack per stage and the driver merges them (`merge_packs`).

Unlike the reference's functional update, the port's optimizers update
in place, so `update_health` takes a snapshot of the old parameters
(`snapshot`) made before the step.

Host side: `HealthMonitor` aggregates the packs, runs the streaming
anomaly detector (`telemetry/anomaly.py`), attaches policy actions
(warn | skip_step | abort) to its verdicts and hands step lines their
`health_*` fields (`metrics.StepRates(health=...)`). The skip itself
happens in the step: `--health guard` gates the optimizer update on
`nonfinite == 0` through `optim._Optimizer.guarded_step`, leaving the
parameters and optimizer state bit-identical on a skipped step.
"""

from __future__ import annotations

import math

import torch

from shallowspeed_tpu_torch.weights import sorted_leaves

MODES = ("off", "monitor", "guard")


def check_mode(health: str) -> str:
    if health not in MODES:
        raise ValueError(f"health={health!r}; expected one of {MODES}")
    return health


def _grouped(tree):
    """(group, leaf) over a tree in the JAX package's leaf order: list
    trees (the MLP family's per-layer lists) group per layer,
    "layer<i>"; dict trees (the transformer family, the SPMD stacks)
    per top-level key. The reference's `_group_of` of a tree path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for leaf in sorted_leaves(tree[k]):
                yield str(k), leaf
    else:
        for i, v in enumerate(tree):
            for leaf in sorted_leaves(v):
                yield f"layer{i}", leaf


def _sq(tensors) -> torch.Tensor:
    """(n,) f32: each tensor's sum of squares, from one fused f32 norm
    pass over all of them (a few multi-tensor kernels, no temporaries,
    where a reduction per leaf would launch hundreds)."""
    norms = torch._foreach_norm([t.detach() for t in tensors], 2,
                                dtype=torch.float32)
    return torch.square(torch.stack(norms))


def _parts(g) -> tuple:
    """The tensors holding one gradient leaf: a ZeRO-2 leaf's slices
    (`parallel.zero.Slices`), else the leaf itself."""
    return getattr(g, "parts", (g,))


@torch.no_grad()
def leaf_squares(gs) -> torch.Tensor:
    """(n,) f32: each leaf's sum of squares (`_sq`), a leaf held as
    slices summing its slices' in rank order."""
    parts = [_parts(g) for g in gs]
    flat = [t for p in parts for t in p]
    sq = _sq([t.to(flat[0].device) for t in flat])
    if len(flat) == len(gs):
        return sq
    out, at = [], 0
    for p in parts:
        acc = sq[at]
        for j in range(1, len(p)):
            acc = acc + sq[at + j]
        out.append(acc)
        at += len(p)
    return torch.stack(out)


@torch.no_grad()
def grad_health(params, grads) -> dict:
    """The health pack of one step: {"grad_norm", "param_norm",
    "nonfinite" (int32), "groups": {name: grad norm}}, 0-d tensors on
    the gradients' device, summed in the reference's leaf order. Call
    on the engine's fully reduced gradients, before the update (the
    optimizer may clip them in place). A ZeRO-2 engine's leaves come as
    `Slices`: each leaf's statistics sum its slices in rank order, the
    reference's psum over the dp axis."""
    names, gs = zip(*_grouped(grads))
    sq = leaf_squares(gs)
    dev = sq.device
    nf = torch.stack([t.numel() - torch.isfinite(t.detach()).sum().to(dev)
                      for g in gs for t in _parts(g)]).sum().to(torch.int32)
    groups = {}
    for i, name in enumerate(names):
        groups.setdefault(name, []).append(i)
    return {"grad_norm": torch.sqrt(torch.sum(sq)),
            "param_norm": param_l2(params), "nonfinite": nf,
            "groups": {k: torch.sqrt(torch.sum(sq[idx]))
                       for k, idx in groups.items()}}


@torch.no_grad()
def snapshot(params) -> list:
    """Bit-exact copies of the parameters' leaves (JAX leaf order; a
    leaf held as slices, slice by slice): the "old" side of
    `update_health`, taken before an in-place update, and under guard
    what a skipped step puts back (`guarded_step`'s `old_params`)."""
    src = [t.detach() for p in sorted_leaves(params) for t in _parts(p)]
    out = [torch.empty_like(p) for p in src]
    torch._foreach_copy_(out, src)
    return out


@torch.no_grad()
def update_health(pack: dict, old: list, new_params,
                  skipped=None) -> dict:
    """Finish the pack after the optimizer update: the update-to-param
    ratio ||new - old|| / ||old|| (0 on a skipped step) with `old` the
    `snapshot` taken before the update, plus the `skipped` flag (an
    int32 0-d tensor) under guard."""
    new = [t.detach().float() for n in sorted_leaves(new_params)
           for t in _parts(n)]
    dsq = torch.sum(_sq(torch._foreach_sub(new, [o.float() for o in old])))
    pack = dict(pack)
    pack["update_ratio"] = torch.sqrt(dsq) / (pack["param_norm"] + 1e-12)
    if skipped is not None:
        pack["skipped"] = torch.as_tensor(skipped).to(torch.int32)
    return pack


@torch.no_grad()
def param_l2(tree) -> torch.Tensor:
    """Global L2 of a tree (f32 accumulation), a 0-d tensor; a leaf
    held as slices (`parallel.zero.Slices`) counts each slice once."""
    return torch.sqrt(torch.sum(leaf_squares(list(sorted_leaves(tree)))))


def note_step(engine, pack) -> None:
    """Record one step's pack on `engine`: `last_health`, and the
    device-side CUMULATIVE counters (one tiny add a step, no host
    sync), so a transient guarded skip or non-finite step between log
    points reaches the next snapshot although `last_health` is
    overwritten every step."""
    cum = getattr(engine, "_health_cum", None)
    nf_step = (pack["nonfinite"] > 0).to(torch.int32)
    new = {"nonfinite_steps_total":
           nf_step if cum is None
           else cum["nonfinite_steps_total"] + nf_step}
    if "skipped" in pack:
        prev = 0 if cum is None else cum.get("skipped_total", 0)
        new["skipped_total"] = prev + pack["skipped"]
    engine._health_cum = new
    engine.last_health = pack


def engine_snapshot(engine) -> dict | None:
    """The engines' shared `health_snapshot` body: the last pack and the
    cumulative counters as one host dict."""
    if engine.last_health is None:
        return None
    cum = getattr(engine, "_health_cum", None) or {}
    return fetch_pack({**engine.last_health, **cum})


# --------------------------------------------------------- host side


def _host(v):
    return v.tolist() if isinstance(v, torch.Tensor) else v


def fetch_pack(pack) -> dict | None:
    """Device pack -> plain-python dict (a host sync; call at log points
    only)."""
    if pack is None:
        return None
    out = {
        "grad_norm": float(_host(pack["grad_norm"])),
        "param_norm": float(_host(pack["param_norm"])),
        "nonfinite": int(_host(pack["nonfinite"])),
        "groups": {k: float(_host(v)) for k, v in pack["groups"].items()},
    }
    if "update_ratio" in pack:
        out["update_ratio"] = float(_host(pack["update_ratio"]))
    for k in ("skipped", "skipped_total", "nonfinite_steps_total"):
        if k in pack:
            out[k] = int(_host(pack[k]))
    # fp8 delayed-scaling bookkeeping (fp8.Fp8TrainEngine): per-layer
    # activation absmax, the scale it produced and the clamp fractions
    # at each quantize — what NumericsMonitor reduces
    for k in ("fp8_amax", "fp8_scale", "fp8_overflow", "fp8_underflow"):
        if k in pack:
            out[k] = [float(v) for v in
                      torch.as_tensor(pack[k]).reshape(-1).tolist()]
    return out


def merge_packs(packs: list) -> dict | None:
    """Driver-side merge of per-STAGE host packs (the pipeline VM's
    stages): norms combine as sqrt(sum of squares) — stages partition
    the parameters — counts sum, groups get a stage prefix, and the
    global update ratio is recovered from the per-stage (ratio,
    param_norm) pairs."""
    packs = [p for p in packs if p]
    if not packs:
        return None
    gsq = sum(p["grad_norm"] ** 2 for p in packs)
    psq = sum(p["param_norm"] ** 2 for p in packs)
    out = {
        "grad_norm": math.sqrt(gsq),
        "param_norm": math.sqrt(psq),
        "nonfinite": sum(p["nonfinite"] for p in packs),
        "groups": {f"s{i}.{k}": v for i, p in enumerate(packs)
                   for k, v in p["groups"].items()},
    }
    if all("update_ratio" in p for p in packs):
        dsq = sum((p["update_ratio"] * p["param_norm"]) ** 2
                  for p in packs)
        out["update_ratio"] = math.sqrt(dsq) / (math.sqrt(psq) + 1e-12)
    if any("skipped" in p for p in packs):
        # stages skip in lockstep (one global ok); any stage's flag
        out["skipped"] = max(p.get("skipped", 0) for p in packs)
    return out


class HealthMonitor:
    """Host-side aggregator: per-step health packs in, verdicts and
    step-line fields out (the reference's, line for line).

    `observe(step, loss, pack)` runs the anomaly detector and returns
    the policy-annotated verdicts of this observation; the driver
    decides what an `abort` does (a labeled SystemExit).
    `step_fields()` is merged into step lines by
    `metrics.StepRates(health=...)`; `heartbeat_status()` is "ok" or
    "dead <reason>"; `unhealthy()` gates checkpoint saves."""

    def __init__(self, policy=None, dead_after: int = 3, **detector_kw):
        from shallowspeed_tpu_torch.telemetry.anomaly import (
            AnomalyDetector, GuardPolicy)

        self.detector = AnomalyDetector(**detector_kw)
        self.policy = policy or GuardPolicy()
        self.dead_after = dead_after
        self.skipped_total = 0
        self.nonfinite_steps = 0
        self._consec_nonfinite = 0
        self._prev_nf_total = 0
        self.dead_reason: str | None = None
        self._last: dict = {}
        self._verdicts_since_log: list = []

    def observe(self, step: int, loss, pack: dict | None) -> list:
        """One observation (per log point: the packs are computed every
        step on the device; fetching them is the host sync). Returns
        this observation's verdicts with `action` set."""
        from shallowspeed_tpu_torch.telemetry.anomaly import Verdict

        verdicts = self.detector.observe(step, loss=loss, pack=pack)
        if pack is not None:
            self._last = dict(pack)
            # the engines' device-side CUMULATIVE counters (note_step)
            # count a transient skip or non-finite step between log
            # points although the last pack of the window is clean
            if "skipped_total" in pack:
                self.skipped_total = pack["skipped_total"]
            elif pack.get("skipped"):
                self.skipped_total += 1
            if "nonfinite_steps_total" in pack:
                delta = pack["nonfinite_steps_total"] \
                    - self._prev_nf_total
                self._prev_nf_total = pack["nonfinite_steps_total"]
                self.nonfinite_steps = pack["nonfinite_steps_total"]
                bad_window = delta > 0
                if bad_window and pack.get("nonfinite", 0) == 0:
                    # the event happened mid-window; the detector only
                    # saw the clean last pack — surface it anyway
                    verdicts.append(Verdict(
                        "nonfinite", step, severity="error",
                        detail=f"{delta} step(s) since the last log "
                               f"point had non-finite gradients"))
            else:
                bad_window = pack.get("nonfinite", 0) > 0
                if bad_window:
                    self.nonfinite_steps += 1
            if bad_window:
                self._consec_nonfinite += 1
            else:
                self._consec_nonfinite = 0
        for v in verdicts:
            v.action = self.policy.action(v.kind)
        if self._consec_nonfinite >= self.dead_after:
            self.dead_reason = (f"nonfinite gradients for "
                                f"{self._consec_nonfinite} consecutive "
                                f"observations")
        elif any(v.kind == "divergence" for v in verdicts):
            self.dead_reason = "loss divergence"
        self._verdicts_since_log.extend(verdicts)
        return verdicts

    def step_fields(self) -> dict:
        """Health fields for the next step line; drains the verdict
        window."""
        out: dict = {}
        p = self._last
        if p:
            out["health_grad_norm"] = round(p.get("grad_norm", 0.0), 6)
            out["health_param_norm"] = round(p.get("param_norm", 0.0), 6)
            if "update_ratio" in p:
                out["health_update_ratio"] = round(p["update_ratio"], 9)
            out["health_nonfinite"] = int(p.get("nonfinite", 0))
        out["health_skipped_total"] = self.skipped_total
        verdicts = self._verdicts_since_log
        self._verdicts_since_log = []
        if verdicts:
            out["health_verdicts"] = [v.kind for v in verdicts]
        return out

    def heartbeat_status(self) -> str:
        return f"dead {self.dead_reason}" if self.dead_reason else "ok"

    def unhealthy(self) -> bool:
        """Whether the run's state, as of the last observed pack, is one
        a checkpoint must NOT capture: non-finite gradients or a dead
        verdict. The drivers gate saves on this."""
        return bool(self.dead_reason) or self._consec_nonfinite > 0


def step_with_health(optimizer, params, grads, state, mode: str):
    """The engines' update under health `mode` ("monitor" or "guard"):
    the pack of the reduced `grads`, the optimizer step — under "guard"
    gated on the pack's `nonfinite == 0` (`guarded_step`) — and
    `update_health` (with `skipped` under guard). One parameter
    `snapshot` serves both the update ratio and the guard's restore.
    Returns (params, state, pack)."""
    pack = grad_health(params, grads)
    old = snapshot(params)
    if mode == "guard":
        ok = pack["nonfinite"] == 0
        params, state = optimizer.guarded_step(params, grads, state, ok,
                                               old_params=old)
        return params, state, update_health(pack, old, params,
                                            skipped=(~ok).to(torch.int32))
    params, state = optimizer.step(params, grads, state)
    return params, state, update_health(pack, old, params)


def step_replicas_with_health(optimizer, replicas, totals, states,
                              mode: str) -> dict:
    """The data-parallel engines' update under health `mode`: replica 0
    through `step_with_health` (the pack: the replicas' reduced
    gradients are equal), every other replica taking the same guard
    decision. Replaces `states[r]` with each replica's new state;
    returns the pack."""
    _, states[0], pack = step_with_health(optimizer, replicas[0], totals[0],
                                          states[0], mode)
    for r in range(1, len(replicas)):
        if mode == "guard":
            _, states[r] = optimizer.guarded_step(
                replicas[r], totals[r], states[r], pack["skipped"] == 0)
        else:
            _, states[r] = optimizer.step(replicas[r], totals[r], states[r])
    return pack
