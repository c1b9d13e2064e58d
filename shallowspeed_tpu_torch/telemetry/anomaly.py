"""Streaming anomaly detection over training-health series — a copy of
`shallowspeed_tpu/telemetry/anomaly.py` (pure Python; the port keeps
its own copy rather than import the JAX package).

Host-side stdlib math only, so the detector runs anywhere. The
device-side numerics live in `telemetry/health.py`; this module turns
their per-step series into *verdicts*:

- ``nonfinite``   the on-device sentinel fired (NaN/Inf in the grads);
- ``loss_spike``  the loss jumped far outside its recent distribution
                  (robust EWMA z-score — mean AND deviation are
                  exponentially weighted, so one spike does not poison
                  the baseline the way a windowed stddev would);
- ``divergence``  the loss EWMA has risen a sustained fraction above
                  its best level for several consecutive observations;
- ``grad_spike``  the same robust z-score over the grad-norm series;
- ``dead_layer``  a per-group gradient norm has been ~zero for several
                  consecutive observations while the global gradient
                  is alive.

`GuardPolicy` maps verdict kinds to actions (``warn`` | ``skip_step``
| ``fallback_bf16`` | ``abort``). The skip itself is enacted on the
device (the engines gate the optimizer update on the nonfinite
sentinel when built with ``health="guard"`` — `optim.guarded_step`);
`abort` is enacted by the driver (a labeled exit).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

ACTIONS = ("warn", "skip_step", "fallback_bf16", "abort")


class RobustEWMA:
    """Exponentially weighted mean + mean-absolute-deviation tracker.

    `update(x)` returns the z-score of x against the state BEFORE
    absorbing it (None during warmup or when the deviation is ~0 and
    x equals the mean). The MAD-based scale (x1.4826, the normal
    consistency constant) keeps one outlier from inflating the
    denominator the way a squared deviation would."""

    def __init__(self, alpha: float = 0.05, warmup: int = 8):
        self.alpha = float(alpha)
        self.warmup = int(warmup)
        self.n = 0
        self.mean: float | None = None
        self.dev: float | None = None

    def update(self, x: float) -> float | None:
        x = float(x)
        if not math.isfinite(x):
            return None  # nonfinite has its own verdict; keep the
            #              baseline clean
        z = None
        if self.n >= self.warmup:
            scale = 1.4826 * self.dev + 1e-12
            z = (x - self.mean) / scale
        if self.mean is None:
            self.mean, self.dev = x, 0.0
        else:
            err = abs(x - self.mean)
            self.mean += self.alpha * (x - self.mean)
            self.dev += self.alpha * (err - self.dev)
        self.n += 1
        return z


@dataclass
class Verdict:
    """One detector finding; `action` is attached by the policy."""

    kind: str
    step: int
    detail: str
    severity: str = "warn"
    action: str = "warn"

    def __str__(self) -> str:
        return f"[health] {self.kind} at step {self.step}: {self.detail}"


@dataclass
class GuardPolicy:
    """Verdict kind -> action. The driver maps `--health monitor` to
    all-warn and `--health guard` to the guarded defaults below."""

    nonfinite: str = "warn"
    loss_spike: str = "warn"
    grad_spike: str = "warn"
    divergence: str = "warn"
    dead_layer: str = "warn"
    # numerics-monitor kinds (telemetry/numerics.py):
    # shadow-parity drift and a collapsed delayed scale. Under guard
    # their action is `fallback_bf16` — the quantized path is the
    # OPTIONAL precision, so the proportionate response is to stop
    # quantizing, not to stop training; the NumericsMonitor escalates
    # a verdict that repeats AFTER the fallback to abort.
    parity_drift: str = "warn"
    scale_collapse: str = "warn"
    # memory-watch kinds (the reference's telemetry/memory.MemoryWatch):
    # sustained resident-bytes growth and a z-spike step change. Warn
    # in every mode — memory anomalies are diagnosed from the flight
    # dump, not auto-actioned: skipping a step frees nothing, and a
    # bf16 fallback would RAISE residency.
    mem_leak: str = "warn"
    mem_drift: str = "warn"

    def action(self, kind: str) -> str:
        act = getattr(self, kind, "warn")
        assert act in ACTIONS, act
        return act

    @classmethod
    def for_mode(cls, mode: str) -> "GuardPolicy":
        if mode == "guard":
            # the nonfinite skip is compiled into the step; the host
            # policy records it. Divergence still only warns — the
            # heartbeat status (health.HealthMonitor.heartbeat_status)
            # is what escalates a numerically-dead run to the elastic
            # supervisor for a restart from the last good checkpoint.
            return cls(nonfinite="skip_step",
                       parity_drift="fallback_bf16",
                       scale_collapse="fallback_bf16")
        return cls()


class AnomalyDetector:
    """Feeds the loss / grad-norm / per-group series; yields verdicts.

    Thresholds are deliberately conservative defaults: a z of 6 on a
    robust scale is far outside anything a healthy LM loss curve does
    at log-point granularity, and every sustained detector needs
    `patience` consecutive bad observations before it fires."""

    def __init__(self, spike_z: float = 6.0, div_factor: float = 0.2,
                 patience: int = 3, dead_eps: float = 1e-12,
                 alpha: float = 0.05, warmup: int = 8):
        self.spike_z = float(spike_z)
        self.div_factor = float(div_factor)
        self.patience = int(patience)
        self.dead_eps = float(dead_eps)
        self._loss = RobustEWMA(alpha, warmup)
        self._grad = RobustEWMA(alpha, warmup)
        self._best_loss_ewma = math.inf
        self._div_run = 0
        self._dead_runs: dict[str, int] = {}
        self._dead_reported: set[str] = set()

    def observe(self, step: int, loss=None, pack: dict | None = None
                ) -> list[Verdict]:
        out: list[Verdict] = []
        if pack is not None and pack.get("nonfinite", 0) > 0:
            out.append(Verdict(
                "nonfinite", step, severity="error",
                detail=f"{pack['nonfinite']} non-finite gradient "
                       f"entries (grad_norm="
                       f"{pack.get('grad_norm', float('nan'))})"))
        if loss is not None and math.isfinite(float(loss)):
            z = self._loss.update(float(loss))
            if z is not None and z > self.spike_z:
                out.append(Verdict(
                    "loss_spike", step,
                    detail=f"loss {float(loss):.4f} is {z:.1f} robust "
                           f"sigmas above its EWMA "
                           f"{self._loss.mean:.4f}"))
            ewma = self._loss.mean
            self._best_loss_ewma = min(self._best_loss_ewma, ewma)
            if (self._loss.n > self._loss.warmup
                    and ewma > self._best_loss_ewma
                    * (1.0 + self.div_factor)):
                self._div_run += 1
                if self._div_run == self.patience:
                    out.append(Verdict(
                        "divergence", step, severity="error",
                        detail=f"loss EWMA {ewma:.4f} has stayed >"
                               f"{self.div_factor:.0%} above its best "
                               f"{self._best_loss_ewma:.4f} for "
                               f"{self.patience} observations"))
            else:
                self._div_run = 0
        elif loss is not None:
            # a nonfinite LOSS is divergence by definition
            out.append(Verdict(
                "divergence", step, severity="error",
                detail=f"loss is non-finite ({loss})"))
        if pack is not None:
            gn = pack.get("grad_norm")
            if gn is not None and math.isfinite(gn):
                z = self._grad.update(gn)
                if z is not None and z > self.spike_z:
                    out.append(Verdict(
                        "grad_spike", step,
                        detail=f"grad norm {gn:.4g} is {z:.1f} robust "
                               f"sigmas above its EWMA "
                               f"{self._grad.mean:.4g}"))
            out.extend(self._dead_layers(step, pack))
        return out

    def _dead_layers(self, step: int, pack: dict) -> list[Verdict]:
        out = []
        gn = pack.get("grad_norm") or 0.0
        alive = math.isfinite(gn) and gn > self.dead_eps
        for name, g in (pack.get("groups") or {}).items():
            if alive and g <= self.dead_eps * max(1.0, gn):
                run = self._dead_runs.get(name, 0) + 1
                self._dead_runs[name] = run
                if run >= self.patience \
                        and name not in self._dead_reported:
                    self._dead_reported.add(name)
                    out.append(Verdict(
                        "dead_layer", step, severity="error",
                        detail=f"group {name!r} gradient has been ~0 "
                               f"for {run} observations while the "
                               f"global grad norm is {gn:.4g}"))
            else:
                self._dead_runs[name] = 0
                self._dead_reported.discard(name)
        return out
