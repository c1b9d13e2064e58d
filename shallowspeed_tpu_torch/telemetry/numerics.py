"""Numerics monitor — the runtime precision telemetry of the fp8 path, a
copy of `shallowspeed_tpu/telemetry/numerics.py` (pure Python) on the
port's `anomaly`.

- the **numerics pack** (device side, in `fp8.Fp8TrainEngine`'s step):
  per-layer overflow/underflow fractions at every activation quantize
  plus the live amax/scale values, riding the health pack;
- `NumericsMonitor` (host side, this module): robust-EWMA drift
  z-scores over each layer's log2(scale) series, a sign-flip
  oscillation score, scale-collapse detection at the 1e-12 floor, and
  the shadow-parity series from the frozen master-precision oracle
  (`Fp8TrainEngine.shadow_parity`);
- verdicts reuse `anomaly.Verdict` with kinds ``scale_collapse`` /
  ``parity_drift``; `GuardPolicy` maps them to actions, with
  ``fallback_bf16`` as the guarded default — and the monitor
  ESCALATES: a kind that fires again after the fallback was taken
  comes back with action ``abort`` (warn → fall back → abort).

Fields ride step lines as `num_*`, the reference's names.
"""

from __future__ import annotations

import math

from shallowspeed_tpu_torch.telemetry.anomaly import (GuardPolicy, RobustEWMA,
                                                Verdict)

# a delayed scale at (or indistinguishably near) the 1e-12 divide
# floor means the amax history is gone — nothing real is that small
COLLAPSE_FLOOR = 1e-10

# parity envelopes. The LOSS rel-err is the discriminative gate: a
# healthy fp8 step tracks the f32 oracle to ~1e-3..2e-2 once the amax
# history has warmed, while a collapsed scale blows it past 0.1
# (the reference's measurement on its fp8 MLP). The worst-leaf grad relmax is
# deliberately loose — on small models a single ReLU mask flip under
# quantization drives one leaf's relmax toward 1.0 on perfectly
# healthy steps (and a fully-collapsed scale only saturates it AT
# 1.0), so the grad budget catches only outright blowups (quantized
# grads LARGER than oracle: scale explosion, inf); the field's job is
# attribution on the step line, not the trigger.
PARITY_LOSS_BUDGET = 0.05
PARITY_GRAD_BUDGET = 2.0

# oscillation: fraction of sign flips in successive log2(scale) deltas
# over the window; a scale alternating every observation scores 1.0
OSC_WINDOW = 16
OSC_THRESHOLD = 0.75


class NumericsMonitor:
    """Host-side reducer for the numerics pack + shadow-parity series.

    `observe(step, pack)` ingests one health-pack fetch (the same dict
    `HealthMonitor.observe` sees — only the `fp8_*` keys are read);
    `note_parity(step, parity)` ingests one shadow-parity sample.
    Both return policy-annotated verdicts. `step_fields()` is merged
    into step lines by `metrics.StepRates(numerics=...)` and drains
    the verdict window, mirroring `HealthMonitor.step_fields`."""

    def __init__(self, policy: GuardPolicy | None = None,
                 drift_z: float = 6.0, patience: int = 3,
                 collapse_floor: float = COLLAPSE_FLOOR,
                 parity_loss_budget: float = PARITY_LOSS_BUDGET,
                 parity_grad_budget: float = PARITY_GRAD_BUDGET,
                 alpha: float = 0.05, warmup: int = 8):
        self.policy = policy or GuardPolicy()
        self.drift_z = float(drift_z)
        self.patience = int(patience)
        self.collapse_floor = float(collapse_floor)
        self.parity_loss_budget = float(parity_loss_budget)
        self.parity_grad_budget = float(parity_grad_budget)
        self._alpha, self._warmup = float(alpha), int(warmup)
        self._scale_ewma: dict[int, RobustEWMA] = {}
        self._deltas: dict[int, list[float]] = {}   # log2-scale deltas
        self._prev_log2: dict[int, float] = {}
        self._parity_ewma = RobustEWMA(alpha, warmup)
        self._collapse_run: dict[int, int] = {}
        self._parity_run = 0
        self._last: dict = {}
        self._last_parity: dict = {}
        self.shadow_total = 0
        self.fallback_taken = False
        self._verdicts_since_log: list[Verdict] = []

    # ------------------------------------------------------- ingest

    def observe(self, step: int, pack: dict | None) -> list[Verdict]:
        """One health-pack observation; returns this observation's
        numerics verdicts with `action` set (escalated past the
        fallback where it was already taken)."""
        if not pack or "fp8_scale" not in pack:
            return []
        scales = [float(s) for s in pack["fp8_scale"]]
        self._last = {
            "scales": scales,
            "amaxes": [float(a) for a in pack.get("fp8_amax", ())],
            "overflow": [float(v) for v in pack.get("fp8_overflow", ())],
            "underflow": [float(v)
                          for v in pack.get("fp8_underflow", ())],
        }
        out: list[Verdict] = []
        drift_layers = []
        for i, s in enumerate(scales):
            if not math.isfinite(s):
                continue
            # collapse: the floor means the history behind this layer's
            # scale is zero/denormal — every quantize saturates
            if s <= self.collapse_floor:
                run = self._collapse_run.get(i, 0) + 1
                self._collapse_run[i] = run
                if run == 1:     # report on arrival, not every step
                    out.append(Verdict(
                        "scale_collapse", step, severity="error",
                        detail=f"layer {i} delayed scale {s:.3g} is at "
                               f"the divide floor (amax history "
                               f"collapsed); overflow frac "
                               f"{self._overflow_at(i):.3f}"))
            else:
                self._collapse_run[i] = 0
            log2s = math.log2(max(s, 1e-300))
            ew = self._scale_ewma.get(i)
            if ew is None:
                ew = self._scale_ewma[i] = RobustEWMA(self._alpha,
                                                      self._warmup)
            z = ew.update(log2s)
            if z is not None and abs(z) > self.drift_z:
                drift_layers.append((i, z))
            prev = self._prev_log2.get(i)
            if prev is not None:
                d = self._deltas.setdefault(i, [])
                d.append(log2s - prev)
                del d[:-OSC_WINDOW]
            self._prev_log2[i] = log2s
        self._last["drift_z"] = max(
            (abs(z) for _, z in drift_layers), default=None)
        self._last["osc"] = max(
            (self._osc_score(i) for i in self._deltas), default=0.0)
        # drift/oscillation inform, they do not fire alone: a real
        # range shift lands in the parity gate or the clamp fractions;
        # the z-score and osc score ride the step line for the operator
        for v in out:
            v.action = self._action(v.kind)
        self._verdicts_since_log.extend(out)
        return out

    def note_parity(self, step: int, parity: dict) -> list[Verdict]:
        """One shadow-parity sample (`Fp8TrainEngine.shadow_parity`'s
        dict: parity_loss_rel + parity_grad_relmax)."""
        loss_rel = float(parity.get("parity_loss_rel", float("nan")))
        grad_rel = float(parity.get("parity_grad_relmax", float("nan")))
        self.shadow_total += 1
        self._last_parity = {"loss_rel": loss_rel, "grad_rel": grad_rel}
        out: list[Verdict] = []
        bad = (not math.isfinite(loss_rel)
               or loss_rel > self.parity_loss_budget
               or not math.isfinite(grad_rel)
               or grad_rel > self.parity_grad_budget)
        z = self._parity_ewma.update(loss_rel)
        trending = z is not None and z > self.drift_z
        if bad or trending:
            self._parity_run += 1
            # an outright envelope violation fires immediately; a
            # trend inside the envelope needs `patience` consecutive
            # samples (slow walks should not flap the guard)
            if bad or self._parity_run >= self.patience:
                why = (f"loss rel-err {loss_rel:.3g} vs budget "
                       f"{self.parity_loss_budget:g}, grad relmax "
                       f"{grad_rel:.3g} vs {self.parity_grad_budget:g}"
                       if bad else
                       f"loss rel-err {loss_rel:.3g} is {z:.1f} robust "
                       f"sigmas above its EWMA "
                       f"{self._parity_ewma.mean:.3g}")
                out.append(Verdict("parity_drift", step,
                                   severity="error",
                                   detail=f"shadow parity: {why}"))
                self._parity_run = 0
        else:
            self._parity_run = 0
        for v in out:
            v.action = self._action(v.kind)
        self._verdicts_since_log.extend(out)
        return out

    def note_fallback(self) -> None:
        """The driver took the bf16 fallback — the same verdict kinds
        now escalate to abort (warn → fall back → abort)."""
        self.fallback_taken = True

    def _action(self, kind: str) -> str:
        act = self.policy.action(kind)
        if act == "fallback_bf16" and self.fallback_taken:
            return "abort"    # the middle rung was already used
        return act

    def _overflow_at(self, i: int) -> float:
        over = self._last.get("overflow") or []
        return over[i] if i < len(over) else float("nan")

    def _osc_score(self, i: int) -> float:
        d = [x for x in self._deltas.get(i, ()) if x != 0.0]
        if len(d) < 2:
            return 0.0
        flips = sum(1 for a, b in zip(d, d[1:]) if a * b < 0)
        return flips / (len(d) - 1)

    # -------------------------------------------------------- output

    def step_fields(self) -> dict:
        """`num_*` fields for the next step line (the reference's
        names); drains the verdict window."""
        out: dict = {}
        p = self._last
        if p:
            if p.get("overflow"):
                out["num_overflow_max"] = round(max(p["overflow"]), 6)
            if p.get("underflow"):
                out["num_underflow_max"] = round(max(p["underflow"]), 6)
            if p.get("scales"):
                out["num_scale_min"] = float(
                    f"{min(p['scales']):.6g}")
            if p.get("amaxes"):
                out["num_amax_max"] = float(
                    f"{max(p['amaxes']):.6g}")
            if p.get("drift_z") is not None:
                out["num_drift_z"] = round(p["drift_z"], 3)
            out["num_osc"] = round(p.get("osc", 0.0), 3)
        if self._last_parity:
            out["num_parity_loss_rel"] = float(
                f"{self._last_parity['loss_rel']:.6g}")
            out["num_parity_grad_relmax"] = float(
                f"{self._last_parity['grad_rel']:.6g}")
        if self.shadow_total:
            out["num_shadow_total"] = self.shadow_total
        if self.fallback_taken:
            out["num_precision"] = "bf16"
        elif p:
            out["num_precision"] = "fp8"
        verdicts = self._verdicts_since_log
        self._verdicts_since_log = []
        if verdicts:
            out["num_verdicts"] = [v.kind for v in verdicts]
        return out
