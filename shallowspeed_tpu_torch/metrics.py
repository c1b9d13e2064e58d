"""Structured JSONL metrics — the parts of `shallowspeed_tpu/metrics.py`
the port's drivers use: `MetricsLogger` (serving and training, with the
MLP driver's `epoch` and `final` records, and the live monitor's feed)
and `StepRates` (training throughput windows, with the health and
numerics monitors' fields, the goodput ledger and the live monitor's
step-time sketches), plus `step_event`, the LM driver's `"step"` line
in the reference's field names. With `telemetry` (a
`telemetry.report.RunTelemetry`) the log points carry its fields.
File-rotation handling is not ported."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL writer, flushed per line; a no-op when `path`
    is falsy. Every line carries `t` (seconds since start), `wall` and
    `mono` stamps like the reference's.

    With a `telemetry.monitor.Monitor` attached (`monitor=`, or set
    `.monitor` later, as `monitor.from_args` does), every logged line is
    also fed to `Monitor.note_line`, with no log file too: the live
    plane ingests exactly the records the file gets."""

    def __init__(self, path=None, monitor=None, **run_info):
        self.path = Path(path) if path else None
        self.monitor = monitor
        self._t0 = time.time()
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
            self.log(event="run_start", **run_info)

    def log(self, **fields) -> None:
        if self._fh is None and self.monitor is None:
            return
        now = time.time()
        fields.setdefault("t", round(now - self._t0, 3))
        fields.setdefault("wall", round(now, 3))
        fields.setdefault("mono", round(time.monotonic(), 6))
        if self._fh is not None:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()
        if self.monitor is not None:
            self.monitor.note_line(fields)

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
    the reference's `StepRates`. With `health` (a
    `telemetry.health.HealthMonitor`) every log point also carries its
    `health_*` fields, with `numerics` (a
    `telemetry.numerics.NumericsMonitor`) its `num_*` fields, with
    `telemetry` (a `telemetry.report.RunTelemetry`) its memory,
    traffic, bubble and waterfall fields — whose own cost is excluded
    from the next window as a pause, as the reference does.

    With `ledger` (a `telemetry.goodput.GoodputLedger`) every `pause`
    is also stamped as a ledger line of its kind, so window-sum +
    excluded ledger seconds == wall clock by construction, and the
    guarded skipped steps between log points land as in-window ledger
    counts. With `monitor` (a `telemetry.monitor.Monitor`) every closed
    window feeds its exact pause-excluded step time and tok/s to the
    monitor's `step_ms` / `tok_s` sketches."""

    def __init__(self, tokens_per_step: float, clock=time.time,
                 telemetry=None, health=None, numerics=None, ledger=None,
                 monitor=None):
        self.tokens_per_step = float(tokens_per_step)
        self._clock = clock
        self._t0 = clock()
        self._win_t = self._t0
        self._steps = 0
        self._pause = 0.0
        self._win_pause = 0.0
        self.telemetry = telemetry
        self.health = health
        self.numerics = numerics
        self.ledger = ledger
        self._led_prev = {"recompiles": 0, "health_skipped_total": 0}
        self.monitor = monitor

    def pause(self, seconds: float, kind: str = "pause") -> None:
        """Exclude `seconds` of non-training wall time from both rates.
        `kind` names the goodput-ledger bucket the excluded time lands in
        (`telemetry.goodput.EXCLUDED_KINDS`: "val", "ckpt_save",
        "telemetry", "calibration", "shadow_parity", ...)."""
        self._pause += float(seconds)
        # a sub-0.1 ms pause would write one near-empty ledger line per
        # log point
        if self.ledger is not None and float(seconds) > 1e-4:
            self.ledger.note(kind, seconds=float(seconds))

    def log_point(self, steps_since_last: int) -> dict:
        """Close the window of `steps_since_last` steps; returns
        {"tokens_per_sec": window rate, "tokens_per_sec_cum": run rate}."""
        now = self._clock()
        self._steps += int(steps_since_last)
        win_secs = max(now - self._win_t
                       - (self._pause - self._win_pause), 1e-9)
        cum_secs = max(now - self._t0 - self._pause, 1e-9)
        self._win_t, self._win_pause = now, self._pause
        win = self.tokens_per_step * steps_since_last / win_secs
        out = {"tokens_per_sec": win,
               "tokens_per_sec_cum":
               self.tokens_per_step * self._steps / cum_secs}
        if self.monitor is not None and steps_since_last > 0:
            # the window's mean step time, weighted by its step count
            self.monitor.observe("step_ms",
                                 win_secs * 1e3 / steps_since_last,
                                 count=int(steps_since_last))
            self.monitor.observe("tok_s", win)
        if self.health is not None:
            out.update(self.health.step_fields())
        if self.numerics is not None:
            out.update(self.numerics.step_fields())
        if self.telemetry is not None:
            out.update(self.telemetry.step_fields(
                window_secs=win_secs,
                steps_in_window=int(steps_since_last)))
            self.pause(self._clock() - now, kind="telemetry")
        if self.ledger is not None:
            # cumulative counters on the step line: stamp their deltas
            for field, kind in (("recompiles", "recompiles"),
                                ("health_skipped_total", "skipped_steps")):
                cur = out.get(field)
                if isinstance(cur, int):
                    delta = cur - self._led_prev[field]
                    if delta > 0:
                        self.ledger.note(kind, count=delta)
                    self._led_prev[field] = cur
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
