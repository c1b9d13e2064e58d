"""Structured JSONL metrics — the parts of `shallowspeed_tpu/metrics.py`
the port's drivers use: `MetricsLogger` (serving and training, with the
MLP driver's `epoch` and `final` records) and `StepRates` (training
throughput windows, with the health and numerics monitors' fields),
plus `step_event`, the LM driver's `"step"` line in the reference's
field names. The live monitor feed, the goodput ledger, the telemetry
fields and file-rotation handling are not ported yet."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL writer, flushed per line; a no-op when `path`
    is falsy. Every line carries `t` (seconds since start), `wall` and
    `mono` stamps like the reference's."""

    def __init__(self, path=None, **run_info):
        self.path = Path(path) if path else None
        self._t0 = time.time()
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
            self.log(event="run_start", **run_info)

    def log(self, **fields) -> None:
        if self._fh is None:
            return
        now = time.time()
        fields.setdefault("t", round(now - self._t0, 3))
        fields.setdefault("wall", round(now, 3))
        fields.setdefault("mono", round(time.monotonic(), 6))
        self._fh.write(json.dumps(fields) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()

    def epoch(self, epoch: int, accuracy_start: float, samples: int,
              epoch_seconds: float) -> None:
        """One record per training epoch. `accuracy_start` is the
        validation accuracy measured BEFORE this epoch's updates (the
        reference's print semantics); the trained result lands in the
        `final` record."""
        sps = samples / epoch_seconds if epoch_seconds > 0 else 0.0
        self.log(event="epoch", epoch=epoch,
                 accuracy_start=round(accuracy_start, 6),
                 epoch_seconds=round(epoch_seconds, 4),
                 samples_per_sec=round(sps, 1))

    def final(self, accuracy: float, total_seconds: float) -> None:
        """Post-training validation accuracy — the run's headline result."""
        self.log(event="final", accuracy=round(accuracy, 6),
                 total_seconds=round(total_seconds, 3))


class StepRates:
    """Per-window and cumulative training throughput between log
    points, with validation and checkpoint time excluded (`pause`):
    the reference's `StepRates` with its health and numerics
    attachments. With `health` (a `telemetry.health.HealthMonitor`)
    every log point also carries its `health_*` fields, with `numerics`
    (a `telemetry.numerics.NumericsMonitor`) its `num_*` fields."""

    def __init__(self, tokens_per_step: float, clock=time.time,
                 health=None, numerics=None):
        self.tokens_per_step = float(tokens_per_step)
        self._clock = clock
        self._t0 = clock()
        self._win_t = self._t0
        self._steps = 0
        self._pause = 0.0
        self._win_pause = 0.0
        self.health = health
        self.numerics = numerics

    def pause(self, seconds: float, kind: str | None = None) -> None:
        """Exclude `seconds` of non-training wall time from both rates.
        `kind` names it as the reference's goodput buckets do ("val",
        "ckpt_save", "shadow_parity"); the ledger is not ported, so it
        is not recorded."""
        self._pause += float(seconds)

    def log_point(self, steps_since_last: int) -> dict:
        """Close the window of `steps_since_last` steps; returns
        {"tokens_per_sec": window rate, "tokens_per_sec_cum": run rate}."""
        now = self._clock()
        self._steps += int(steps_since_last)
        win_secs = max(now - self._win_t
                       - (self._pause - self._win_pause), 1e-9)
        cum_secs = max(now - self._t0 - self._pause, 1e-9)
        self._win_t, self._win_pause = now, self._pause
        out = {"tokens_per_sec":
               self.tokens_per_step * steps_since_last / win_secs,
               "tokens_per_sec_cum":
               self.tokens_per_step * self._steps / cum_secs}
        if self.health is not None:
            out.update(self.health.step_fields())
        if self.numerics is not None:
            out.update(self.numerics.step_fields())
        return out


def step_event(step: int, loss: float, rates: dict, perf: dict,
               cum: dict) -> dict:
    """The fields of a training `"step"` JSONL line, named as the
    reference driver (`train_lm.py`) names them: `rates` from
    `StepRates.log_point`, `perf` / `cum` from `flops.mfu` of the window
    and cumulative rates (mfu None where no peak is known)."""
    def r(x, n):
        return None if x is None else round(x, n)

    return {"event": "step", "step": step, "loss": round(loss, 6),
            "tokens_per_sec": round(rates["tokens_per_sec"], 1),
            "tflops": round(perf["tflops"], 2), "mfu": r(perf["mfu"], 4),
            "tokens_per_sec_cum": round(rates["tokens_per_sec_cum"], 1),
            "tflops_cum": round(cum["tflops"], 2),
            "mfu_cum": r(cum["mfu"], 4)}
