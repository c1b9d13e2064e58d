"""Live telemetry plane — what the run looks like *while it runs*.

A copy of `shallowspeed_tpu/telemetry/monitor.py` (pure stdlib plus
`sketch`; the port keeps its own copy rather than import the JAX
package). The server thread and the tailer read host dicts only:
nothing on them touches a CUDA tensor or the tracer's fences. The
port's `serve --serve` grafts its request gateway on the endpoint as
the `extra` target, and `serve --shed-load` wires the alerts into
`ServingEngine.on_alert`.

Everything before this module reduced a FINISHED metrics JSONL
(`--goodput`, `report.request_summary`); an operator watching a
serving fleet, the elastic supervisor deciding whether a child is
healthy, or an MPMD-era controller rebalancing stages needs the same
answers while the process is alive. Four parts:

- **Streaming aggregation** (`sketch.LogHistogram`): p50/p95/p99 over
  step time, ttft/tpot, tok/s, queue depth and free blocks in constant
  memory, fed from `metrics.StepRates` (exact pause-excluded window
  rates) and the schema-v6 ``"request"``/``"generate"`` lines. The
  sketches serialize into the JSONL as periodic schema-v7
  ``"monitor"`` snapshot events and MERGE across processes/stanzas —
  `--goodput` cross-checks the merged sketch quantiles against its
  exact offline percentiles (same nearest-rank rule, so they agree to
  the sketch's documented rel_err).
- **Live endpoints** (`StatusServer`): a stdlib ``http.server`` behind
  ``--monitor-port`` on the drivers and the elastic supervisor —
  ``/status.json`` (quantiles, goodput-so-far, health verdict,
  queue/alloc state, last fault, active alerts) and ``/metrics`` in
  Prometheus text exposition format. ``python -m
  shallowspeed_tpu_torch.telemetry --live f.jsonl`` tails a growing file and
  renders the same view for endpoint-less runs.
- **SLO burn-rate alerts** (`parse_slos` + the per-rule dual-window
  evaluator): declarative SLOs (``--slo
  'ttft_p95_ms<500,availability>0.99'``) evaluated over a fast and a
  slow window; an alert fires only when BOTH windows burn error
  budget faster than the threshold (the multiwindow rule that kills
  both flavors of false page: a blip trips the fast window but not
  the slow, a slow bleed trips the slow but resolved blips keep the
  fast window clean). Alerts land as schema-v7 ``"alert"`` events and
  reach `ServingEngine.on_alert` (load shedding, opt-in).
- **Anomaly flight recorder** (`FlightRecorder`): a ring of the last N
  full-resolution lines (step/tick/request/ledger + tracer spans)
  dumped to ``flightrec_<step>.json`` when an anomaly verdict fires, a
  chaos fault stamps, or an SLO alert trips — the forensics AROUND the
  incident, not a summary after it.

One ingestion path: `Monitor.note_line(rec)` accepts exactly the dicts
`metrics.MetricsLogger` writes, so the in-process wiring (the logger
forwards every line), the `--live` tailer, and the supervisor's
aggregation (tailing the child's ledger file across restarts) are the
same code — live and offline can only disagree by the sketch error.

Heavier deps (torch) never load here: pure stdlib, like `sketch`.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from collections import deque
from pathlib import Path

from shallowspeed_tpu_torch.telemetry.sketch import LogHistogram, MetricSketches

# sketch names the monitor maintains; anything can be observed, these
# are the documented core set
CORE_SKETCHES = ("step_ms", "ttft_ms", "tpot_ms", "tok_s",
                 "queue_depth", "free_blocks")

# worst-K exemplars the monitor keeps per latency metric: the request
# ids behind the tail quantile, so a fleet view can name WHICH request
# (on which replica) is burning an SLO instead of just how badly
EXEMPLAR_METRICS = ("ttft_ms", "tpot_ms")
EXEMPLAR_K = 5

# native-Prometheus-histogram bucket ladder: a FIXED,
# data-independent {1, 2.5, 5} x 10^k grid so every replica exports
# the same `le` boundaries — which is the whole point: cumulative
# bucket counts SUM across replicas, so fleet quantiles computed by
# histogram_quantile() in Prometheus/Grafana are correct, where
# averaging the pre-computed per-replica quantile labels of the
# summary export is not. Spans sub-ms ttft to multi-minute e2e; the
# counts at each boundary come from the log-bucketed sketch at its
# documented rel_err.
HIST_LE = tuple(m * 10.0 ** k for k in range(-1, 6)
                for m in (1.0, 2.5, 5.0))

# the cap on retained in-flight lifecycle accumulations (one dict per
# live request id) — a monitor on a long-lived replica must stay O(1)
LIFECYCLE_CAP = 1024


def prom_histogram_lines(base: str, sk: LogHistogram,
                         label: str = "",
                         type_line: bool = True) -> list[str]:
    """Render one sketch as a native Prometheus histogram
    (`<base>_hist_bucket{le=...}` cumulative counts + `_sum`/`_count`)
    on the shared HIST_LE ladder. `label` is an optional extra label
    clause (e.g. 'replica="r0",') spliced before `le`; pass
    `type_line=False` for every series after the first of one metric
    (the exposition format wants ONE # TYPE per metric name)."""
    lines = [f"# TYPE {base}_hist histogram"] if type_line else []
    for le in HIST_LE:
        lines.append(f'{base}_hist_bucket{{{label}le="{le:g}"}} '
                     f"{sk.count_le(le)}")
    lines.append(f'{base}_hist_bucket{{{label}le="+Inf"}} {sk.n}')
    if label:
        lines.append(f"{base}_hist_sum{{{label.rstrip(',')}}} "
                     f"{sk.total:.6g}")
        lines.append(f"{base}_hist_count{{{label.rstrip(',')}}} "
                     f"{sk.n}")
    else:
        lines.append(f"{base}_hist_sum {sk.total:.6g}")
        lines.append(f"{base}_hist_count {sk.n}")
    return lines


class PortInUseError(OSError):
    """--monitor-port names a port this process cannot bind."""


def prom_escape(value) -> str:
    """Prometheus text-exposition label-value escaping (backslash,
    double quote, newline) — replica names are operator input and must
    not be able to break the /metrics parse."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


# --------------------------------------------------------------- SLOs


_SLO_RE = re.compile(r"^\s*([a-zA-Z0-9_]+)\s*([<>])\s*"
                     r"([0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*$")
_QUANT_RE = re.compile(r"^(.*?)_p([0-9]{1,2})(_[a-z0-9]+)?$")


class SloRule:
    """One declarative SLO plus its dual-window burn-rate state.

    Two shapes:

    - quantile rule (``ttft_p95_ms<500``): every observation of the
      underlying sketch (here ``ttft_ms``) is good iff it satisfies
      the threshold; the error budget is the quantile's complement
      (p95 -> 5% of observations may be bad). Burn rate over a window
      = bad_fraction / budget — burn 1.0 exactly spends the budget,
      burn 10 exhausts it 10x too fast.
    - scalar rule (``availability>0.99``): fed downtime seconds
      (supervisor restart stamps); burn = downtime_in_window /
      (window * (1 - target)).

    An alert fires when BOTH the fast and the slow window exceed the
    burn threshold, at ``critical`` when both exceed the critical
    threshold; it resolves when either window recovers.
    """

    def __init__(self, spec: str, fast_s: float = 60.0,
                 slow_s: float = 600.0, warn_burn: float = 2.0,
                 critical_burn: float = 10.0, min_count: int = 5):
        m = _SLO_RE.match(spec)
        if not m:
            raise ValueError(
                f"bad SLO {spec!r}: want 'metric<value' or "
                f"'metric>value' (e.g. ttft_p95_ms<500, "
                f"availability>0.99)")
        self.spec = spec.strip()
        self.metric, self.op = m.group(1), m.group(2)
        self.threshold = float(m.group(3))
        self.fast_s, self.slow_s = float(fast_s), float(slow_s)
        self.warn_burn, self.critical_burn = (float(warn_burn),
                                              float(critical_burn))
        self.min_count = int(min_count)
        qm = _QUANT_RE.match(self.metric)
        if self.metric == "availability":
            self.sketch = None
            self.q = None
            if self.op != ">" or not 0.0 < self.threshold < 1.0:
                raise ValueError(f"bad SLO {spec!r}: availability "
                                 f"takes '>frac' with frac in (0, 1)")
            self.budget = 1.0 - self.threshold
        elif qm:
            self.sketch = qm.group(1) + (qm.group(3) or "")
            self.q = int(qm.group(2))
            if not 0 < self.q < 100:
                raise ValueError(f"bad SLO {spec!r}: quantile must be "
                                 f"in (0, 100)")
            self.budget = max(1.0 - self.q / 100.0, 1e-6)
        else:
            raise ValueError(
                f"bad SLO {spec!r}: metric must be 'availability' or "
                f"'<sketch>_pNN[_unit]' over one of the monitor "
                f"sketches (e.g. {', '.join(CORE_SKETCHES)})")
        # (t, bad_count, total_count) for quantile rules;
        # (t, down_seconds, 0) for the availability rule
        self._events: deque = deque()
        self.state: str | None = None      # None | "warn" | "critical"
        self.last_value: float | None = None

    # ------------------------------------------------------------ feed

    def record(self, value: float, now: float, count: int = 1) -> None:
        """One observation of this rule's underlying sketch metric."""
        good = (value < self.threshold if self.op == "<"
                else value > self.threshold)
        self.last_value = float(value)
        self._events.append((now, 0 if good else count, count))
        self._prune(now)

    def record_counts(self, bad: int, total: int, now: float) -> None:
        """Pre-judged observations (the fleet path: a merged sketch
        delta yields bad/total counts against the threshold without
        the raw values)."""
        if total <= 0:
            return
        self._events.append((now, max(0, int(bad)), int(total)))
        self._prune(now)

    def record_down(self, seconds: float, now: float) -> None:
        """Availability rule: `seconds` of downtime ending at `now`."""
        self._events.append((now, float(seconds), 0))
        self._prune(now)

    def _prune(self, now: float) -> None:
        horizon = now - self.slow_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    # ------------------------------------------------------- evaluate

    def burn(self, window_s: float, now: float) -> float:
        lo = now - window_s
        if self.sketch is None:
            down = sum(b for t, b, _ in self._events if t > lo)
            return down / (window_s * self.budget)
        bad = tot = 0
        for t, b, c in self._events:
            if t > lo:
                bad += b
                tot += c
        if tot < self.min_count:
            return 0.0
        return (bad / tot) / self.budget

    def evaluate(self, now: float) -> dict | None:
        """Returns an alert record when the state CHANGES (fire,
        escalate, resolve), else None."""
        self._prune(now)
        bf = self.burn(self.fast_s, now)
        bs = self.burn(self.slow_s, now)
        sev = ("critical" if min(bf, bs) >= self.critical_burn
               else "warn" if min(bf, bs) >= self.warn_burn else None)
        if sev == self.state:
            return None
        prev, self.state = self.state, sev
        rec = {"slo": self.spec, "metric": self.metric,
               "state": "firing" if sev else "resolved",
               "severity": sev or prev,
               "burn_fast": round(bf, 3), "burn_slow": round(bs, 3),
               "threshold": self.threshold}
        if self.last_value is not None:
            rec["value"] = round(self.last_value, 6)
        return rec

    def status(self, now: float) -> dict:
        return {"slo": self.spec,
                "state": self.state or "ok",
                "burn_fast": round(self.burn(self.fast_s, now), 3),
                "burn_slow": round(self.burn(self.slow_s, now), 3)}


def parse_slos(spec: str, **kw) -> list[SloRule]:
    """``--slo 'ttft_p95_ms<500,availability>0.99'`` -> rules.
    A typed ValueError on the first bad token (fail at arg time, not
    mid-run)."""
    if not spec or not spec.strip():
        return []
    return [SloRule(tok, **kw) for tok in spec.split(",") if tok.strip()]


# ---------------------------------------------------- flight recorder


class FlightRecorder:
    """Ring buffer of the last `capacity` full-resolution records
    (metrics lines + tracer span events), dumped on incident triggers.

    Dumps are deduplicated by (reason, step) and capped per run —
    an alert flapping at log-point cadence must not fill the disk
    with identical snapshots.
    """

    def __init__(self, capacity: int = 256, out_dir=None,
                 max_dumps: int = 16):
        self.ring: deque = deque(maxlen=max(1, int(capacity)))
        self.out_dir = Path(out_dir) if out_dir else Path(".")
        self.max_dumps = int(max_dumps)
        self.dumps: list[str] = []
        self._seen: set = set()

    def record(self, rec: dict) -> None:
        self.ring.append(rec)

    def dump(self, reason: str, step=None, trigger=None) -> str | None:
        key = (reason, step)
        if key in self._seen or len(self.dumps) >= self.max_dumps:
            return None
        self._seen.add(key)
        tag = step if step is not None else f"n{len(self.dumps)}"
        path = self.out_dir / f"flightrec_{tag}.json"
        k = 0
        while path.exists():
            k += 1
            path = self.out_dir / f"flightrec_{tag}_{k}.json"
        payload = {"reason": reason, "step": step,
                   "wall": round(time.time(), 3), "trigger": trigger,
                   "n_entries": len(self.ring),
                   "ring": list(self.ring)}
        try:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
        except OSError:
            return None
        self.dumps.append(str(path))
        return str(path)


# ------------------------------------------------------------ monitor


class Monitor:
    """The live telemetry plane for one process (module docstring).

    `note_line(rec)` is the single ingestion path; `emit` (usually the
    bound `MetricsLogger.log`) receives the periodic ``"monitor"``
    snapshots and ``"alert"`` events this monitor produces;
    `alert_listeners` (e.g. `ServingEngine.on_alert`) get every alert
    record as a dict.

    `derive_steps=True` (the tailer / supervisor mode) reconstructs
    per-step time and tok/s from consecutive ``"step"`` lines; the
    in-process drivers leave it False and feed exact pause-excluded
    window rates through `StepRates(monitor=...)` instead — wiring
    both would double-count.
    """

    def __init__(self, slos: str = "", flight: int = 256,
                 flight_dir=None, rel_err: float = 0.01, emit=None,
                 derive_steps: bool = False, snapshot_every: int = 64,
                 clock=time.time, slo_kw: dict | None = None,
                 label: str | None = None):
        self.label = label          # replica name in a fleet view
        self.sketches = MetricSketches(rel_err=rel_err)
        # worst-K (value, request id) per latency metric — the
        # exemplar linkage a fleet's worst-ttft bucket resolves to
        self.exemplars: dict[str, list] = {}
        self.rules = parse_slos(slos, **(slo_kw or {}))
        self.flight = FlightRecorder(capacity=flight or 256,
                                     out_dir=flight_dir)
        self.flight_enabled = flight > 0
        self.emit = emit
        self.derive_steps = bool(derive_steps)
        self.snapshot_every = int(snapshot_every)
        self.clock = clock
        self.alert_listeners: list = []
        self.counters = {"lines": 0, "steps": 0, "requests": 0,
                         "faults": 0, "alerts": 0, "restarts": 0,
                         "snapshots": 0, "flight_dumps": 0}
        self.health = "ok"
        self.last_fault: dict | None = None
        self.last_step: dict | None = None
        # continuous-profiling plane: the drivers attach
        # their ProfilerPlane here so (a) /profile.json serves the
        # live sampler state and (b) every flight-dump trigger
        # (anomaly verdict, chaos fault, SLO burn) ALSO arms a
        # high-rate capture window; tailer-mode monitors instead keep
        # the stream's last cumulative "profile" snapshot
        self.profiler = None
        self.last_profile: dict | None = None
        self.serving: dict = {}
        # numerics observatory: last-seen schema-v13 num_*
        # step fields — the live precision story /status.json and
        # /metrics serve next to health, and the fleet view rolls up
        self.numerics: dict = {}
        # memory observatory: last-seen schema-v15 memory
        # step fields (per-owner MiB, untracked residual, host RSS),
        # the last recovered-OOM ledger stamp, and the last forensic
        # payload a memory flight dump carried
        self.memory: dict = {}
        # per-request lifecycle accounting: in-flight
        # phase-time accumulation keyed by request id, reduced on
        # "finished" into the rq_* component sketches and the
        # slowest-request decomposition /status.json serves
        self._lifecycle_acc: dict[str, dict] = {}
        self.slowest_request: dict | None = None
        self.active_alerts: dict[str, dict] = {}
        self._first_wall: float | None = None
        self._last_wall: float | None = None
        self._loss_s = 0.0            # ledgered non-productive seconds
        self._downtime_s = 0.0
        self._prev_step: tuple | None = None   # (step, wall)
        self._lines_since_snap = 0
        self._emitting = False
        self._lock = threading.RLock()

    # -------------------------------------------------------- ingest

    def observe(self, name: str, value, count: int = 1) -> None:
        """Direct sketch feed (exact values — `StepRates` uses this
        for pause-excluded step_ms/tok_s); also feeds any SLO rule
        bound to that sketch."""
        with self._lock:
            self.sketches.observe(name, value, count)
            now = self._now()
            for rule in self.rules:
                if rule.sketch == name:
                    rule.record(float(value), now, count)
            self._evaluate(now)

    def note_line(self, rec: dict) -> None:
        """Ingest one metrics-JSONL record (exactly the dict
        `MetricsLogger` writes / the tailer parses)."""
        if not isinstance(rec, dict):
            return
        if self._emitting:
            return      # our own monitor/alert emission re-entering
        ev = rec.get("event")
        if ev == "monitor":
            return      # derived data; merging it back would double-count
        with self._lock:
            self.counters["lines"] += 1
            wall = rec.get("wall")
            if isinstance(wall, (int, float)):
                if self._first_wall is None:
                    self._first_wall = float(wall)
                self._last_wall = max(self._last_wall or 0.0,
                                      float(wall))
            if ev is not None and self.flight_enabled:
                self.flight.record(rec)
            handler = getattr(self, f"_on_{ev}", None) \
                if isinstance(ev, str) else None
            if handler is not None:
                handler(rec)
            self._lines_since_snap += 1
            if self.snapshot_every and \
                    self._lines_since_snap >= self.snapshot_every:
                self._snapshot_locked()
            self._evaluate(self._now())

    def record_span(self, ev: dict) -> None:
        """Tracer subscriber: span events join the flight ring (full
        resolution around an incident includes the phase spans)."""
        if self.flight_enabled:
            with self._lock:
                self.flight.record(ev)

    # per-event handlers (note_line dispatch) ------------------------

    def _on_step(self, rec: dict) -> None:
        self.counters["steps"] += 1
        self.last_step = {k: rec.get(k) for k in
                          ("step", "loss", "tokens_per_sec", "mfu",
                           "wall") if k in rec}
        verdicts = rec.get("health_verdicts")
        if verdicts:
            self.health = "warn: " + ",".join(str(v) for v in verdicts)
            self._flight_dump("anomaly:" + ",".join(
                str(v) for v in verdicts), rec.get("step"), rec)
        elif rec.get("health_nonfinite"):
            self.health = "warn: nonfinite"
        self._note_numerics(rec)
        self._note_memory(rec)
        if self.derive_steps:
            step, wall = rec.get("step"), rec.get("wall")
            if isinstance(rec.get("tokens_per_sec"), (int, float)):
                self.observe_locked("tok_s", rec["tokens_per_sec"])
            if isinstance(step, int) and isinstance(wall, (int, float)):
                if self._prev_step is not None:
                    s0, w0 = self._prev_step
                    if step > s0 and wall > w0:
                        # approximate (pauses between log points are
                        # not excluded here; the in-process StepRates
                        # feed is the exact one)
                        ms = (wall - w0) * 1e3 / (step - s0)
                        self.observe_locked("step_ms", ms,
                                            count=step - s0)
                self._prev_step = (step, float(wall))

    def _on_request(self, rec: dict) -> None:
        self.counters["requests"] += 1
        now = self._now()
        for field, name in (("ttft_ms", "ttft_ms"),
                            ("tpot_ms", "tpot_ms")):
            v = rec.get(field)
            if isinstance(v, (int, float)):
                self.sketches.observe(name, v)
                if name in EXEMPLAR_METRICS:
                    self._note_exemplar(name, rec.get("id"), float(v))
                for rule in self.rules:
                    if rule.sketch == name:
                        rule.record(float(v), now)
        if isinstance(rec.get("queue_depth"), int):
            self.serving["queue_depth"] = rec["queue_depth"]

    def _on_generate(self, rec: dict) -> None:
        for field, name in (("tokens_per_sec", "tok_s"),
                            ("queue_depth", "queue_depth"),
                            ("free_blocks", "free_blocks")):
            v = rec.get(field)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.sketches.observe(name, v)
        now = self._now()
        for field in ("queue_depth", "active_slots", "free_blocks",
                      "blocks_touched", "hbm_gbps",
                      # schema v9: speculative-decoding window tallies
                      # — acceptance rate rides /status.json so a
                      # fleet view sees whether speculation is paying
                      "spec_drafted", "spec_accepted",
                      "spec_accept_rate",
                      # schema v14: prefix-cache gauges — hit rate +
                      # cold-list/index size ride /status.json so the
                      # fleet view sees whether caching is paying
                      "prefix_hit_rate", "cold_blocks",
                      "prefix_blocks",
                      # schema v15: capacity-plane gauges — the
                      # admission-headroom estimate the fleet view and
                      # router placement read (negative = the replica
                      # is overcommitted, evictions coming)
                      "live_blocks", "blocks_needed",
                      "headroom_blocks"):
            if field in rec:
                self.serving[field] = rec[field]
        for rule in self.rules:
            if rule.sketch in ("tok_s", "queue_depth", "free_blocks"):
                v = rec.get({"tok_s": "tokens_per_sec"}.get(
                    rule.sketch, rule.sketch))
                if isinstance(v, (int, float)):
                    rule.record(float(v), now)

    def _on_lifecycle(self, rec: dict) -> None:
        """Accumulate one request's phase transitions into the rq_*
        waterfall components (telemetry/tracing.PHASE_COMPONENT — the
        same mapping the offline stitcher uses), feeding the
        per-component sketches on completion and keeping the
        slowest-request decomposition for /status.json. Engine-side
        components only (queue/prefill/decode); the cross-process
        pieces (failover gap, breaker wait) are the stitcher's."""
        from shallowspeed_tpu_torch.telemetry.tracing import PHASE_COMPONENT

        rid = rec.get("id")
        if not isinstance(rid, str):
            return
        st = self._lifecycle_acc.get(rid)
        if st is None:
            while len(self._lifecycle_acc) >= LIFECYCLE_CAP:
                self._lifecycle_acc.pop(
                    next(iter(self._lifecycle_acc)))
            st = self._lifecycle_acc[rid] = {
                "by": {}, "trace": rec.get("trace")}
        ms = rec.get("ms_in_prev")
        prev = rec.get("prev")
        if isinstance(ms, (int, float)) and isinstance(prev, str):
            comp = PHASE_COMPONENT.get(prev)
            if comp is not None:
                st["by"][comp] = st["by"].get(comp, 0.0) + float(ms)
        if rec.get("phase") != "finished":
            return
        st = self._lifecycle_acc.pop(rid)
        total = sum(st["by"].values())
        for comp, v in st["by"].items():
            self.sketches.observe(comp + "_ms", v)
        if total > (self.slowest_request or {}).get("e2e_ms", -1.0):
            self.slowest_request = {
                "id": rid, "trace": st["trace"],
                "e2e_ms": round(total, 3),
                "by_component_ms": {k: round(v, 3) for k, v
                                    in sorted(st["by"].items())}}

    def _on_ledger(self, rec: dict) -> None:
        secs = rec.get("seconds")
        if isinstance(secs, (int, float)):
            self._loss_s += float(secs)
            if rec.get("kind") == "restart_downtime":
                self._downtime_s += float(secs)
                self.counters["restarts"] += 1
                now = self._now()
                for rule in self.rules:
                    if rule.sketch is None:
                        rule.record_down(float(secs), now)
        if rec.get("kind") == "oom":
            # schema v15: a recovered OutOfBlocks stamp. Trip the
            # memory flight dump here too (tailer mode: no engine
            # listener wired) — in live serve mode the engine's
            # oom_listeners fired the RICH forensic dump first, so
            # this one dedups away on the same ("oom", tick) key.
            self.memory["last_oom"] = {
                k: rec[k] for k in ("requested", "free", "cold",
                                    "live", "id", "tick") if k in rec}
            self._flight_dump("oom", rec.get("tick"), rec)

    def _note_memory(self, rec: dict) -> None:
        """Fold schema-v15 memory step fields into the live memory
        view; a MemoryWatch verdict (mem_leak / mem_drift) trips the
        same incident path as a health verdict — flight dump +
        profiler capture window."""
        for field in ("hbm_live_mib", "hbm_owned_mib",
                      "hbm_untracked_mib", "host_rss_mib",
                      "hbm_within_bound"):
            if field in rec and rec[field] is not None:
                self.memory[field] = rec[field]
        verdicts = rec.get("mem_verdicts")
        if verdicts:
            self.memory["last_verdicts"] = [str(v) for v in verdicts]
            self.health = "warn: " + ",".join(str(v) for v in verdicts)
            self._flight_dump("memory:" + ",".join(
                str(v) for v in verdicts), rec.get("step"), rec)

    def memory_flight_dump(self, payload: dict, step=None) -> None:
        """OOM-forensics trigger (`ServingEngine.oom_listeners` →
        here, wired by serve.py): keep the forensic payload on the
        live memory view and dump it through the flight recorder /
        profiler capture path. `step` is the engine tick, matching the
        ledger stamp's dedup key."""
        with self._lock:
            self.memory["oom_forensics"] = payload
            self._flight_dump("oom", step, payload)

    def _on_fault(self, rec: dict) -> None:
        self.counters["faults"] += 1
        self.last_fault = dict(rec)
        self._flight_dump(f"fault:{rec.get('kind')}", rec.get("step"),
                          rec)

    def _on_health(self, rec: dict) -> None:
        verdicts = rec.get("health_verdicts")
        if verdicts:
            self.health = "warn: " + ",".join(str(v) for v in verdicts)
            self._flight_dump("anomaly:" + ",".join(
                str(v) for v in verdicts), rec.get("step"), rec)
        self._note_numerics(rec)

    def _note_numerics(self, rec: dict) -> None:
        """Fold schema-v13 num_* step fields into the live numerics
        view; a numerics verdict (scale_collapse / parity_drift) trips
        the same incident path as a health verdict — flight dump +
        profiler capture window."""
        for field in ("num_overflow_max", "num_underflow_max",
                      "num_scale_min", "num_amax_max", "num_drift_z",
                      "num_osc", "num_parity_loss_rel",
                      "num_parity_grad_relmax", "num_shadow_total",
                      "num_precision"):
            if field in rec and rec[field] is not None:
                self.numerics[field] = rec[field]
        verdicts = rec.get("num_verdicts")
        if verdicts:
            self.numerics["last_verdicts"] = [str(v) for v in verdicts]
            self.health = "warn: " + ",".join(str(v) for v in verdicts)
            self._flight_dump("numerics:" + ",".join(
                str(v) for v in verdicts), rec.get("step"), rec)

    def _on_profile(self, rec: dict) -> None:
        # tailer/fleet path: a file-fed replica's latest cumulative
        # profiler snapshot (events are cumulative, so last wins)
        self.last_profile = dict(rec)

    def _on_alert(self, rec: dict) -> None:
        # alerts from ANOTHER process's monitor (tailer mode): surface
        # them without re-evaluating
        if rec.get("state") == "firing":
            self.active_alerts[rec.get("slo", "?")] = dict(rec)
        else:
            self.active_alerts.pop(rec.get("slo", "?"), None)

    # ------------------------------------------------------ internals

    def _note_exemplar(self, name: str, rid, value: float) -> None:
        """Keep the K worst (value, id) pairs for `name` — tail-quantile
        forensics: the fleet view's worst-ttft bucket names these."""
        if rid is None:
            return
        ex = self.exemplars.setdefault(name, [])
        ex.append((value, str(rid)))
        ex.sort(key=lambda p: -p[0])
        del ex[EXEMPLAR_K:]

    def observe_locked(self, name, value, count=1):
        # observe() body without re-taking the RLock-guarded evaluate
        # (RLock makes this safe either way; kept for symmetry)
        self.sketches.observe(name, value, count)
        now = self._now()
        for rule in self.rules:
            if rule.sketch == name:
                rule.record(float(value), now, count)

    def _now(self) -> float:
        # event time: the last wall stamp seen keeps tailed history
        # evaluating in ITS timeline; live processes stamp wall
        # continuously so this is ~now there
        return self._last_wall if self._last_wall is not None \
            else self.clock()

    def _evaluate(self, now: float) -> None:
        for rule in self.rules:
            rec = rule.evaluate(now)
            if rec is None:
                continue
            self.counters["alerts"] += 1
            rec["wall"] = round(now, 3)
            if rec["state"] == "firing":
                self.active_alerts[rule.spec] = rec
                self._flight_dump(
                    f"slo:{rule.spec}",
                    (self.last_step or {}).get("step"), rec)
            else:
                self.active_alerts.pop(rule.spec, None)
            self._emit_rec("alert", rec)
            for fn in list(self.alert_listeners):
                try:
                    fn(rec)
                except Exception:
                    pass  # a broken listener must not kill the run

    def flight_dump(self, reason: str, step=None, trigger=None) -> None:
        """Public incident trigger — the drivers call this on their
        labeled-abort paths (divergence exit, fatal anomaly verdict),
        where the process dies before the next line would reach
        `note_line`."""
        with self._lock:
            self._flight_dump(reason, step, trigger)

    def _flight_dump(self, reason: str, step, trigger) -> None:
        # every incident that would dump the metrics ring also arms a
        # profiler capture window — the flight dump says
        # what the run's NUMBERS were around the incident, the profcap
        # says what its HOST was doing; the capture's own dedup/
        # cooldown bounds it, independent of --flight-recorder
        if self.profiler is not None:
            try:
                self.profiler.on_incident(reason, step=step,
                                          trigger=trigger)
            except Exception:
                pass
        if not self.flight_enabled:
            return
        path = self.flight.dump(reason, step=step, trigger=trigger)
        if path is not None:
            self.counters["flight_dumps"] += 1

    def _emit_rec(self, event: str, rec: dict) -> None:
        if self.emit is None:
            return
        self._emitting = True
        try:
            self.emit(event=event, **{k: v for k, v in rec.items()
                                      if k != "event"})
        except Exception:
            pass
        finally:
            self._emitting = False

    # ------------------------------------------------------- snapshot

    def _snapshot_locked(self) -> dict:
        self._lines_since_snap = 0
        self.counters["snapshots"] += 1
        snap = {"sketches": self.sketches.to_dict(),
                "counters": dict(self.counters),
                "rel_err": self.sketches.rel_err}
        self._emit_rec("monitor", snap)
        return snap

    def snapshot(self) -> dict:
        """Serialize-and-emit the current sketch state (a schema-v7
        ``"monitor"`` event payload); merge with `merge_snapshot`."""
        with self._lock:
            return self._snapshot_locked()

    def merge_snapshot(self, snap: dict) -> None:
        """Fold another process's ``"monitor"`` payload into this one
        (the fleet/gang aggregation path)."""
        with self._lock:
            self.sketches.merge_dict(snap.get("sketches") or {})

    def close(self) -> None:
        """Final snapshot so the JSONL tail carries the run's whole
        distribution for offline merging."""
        with self._lock:
            if any(sk.n for sk in self.sketches.sketches.values()):
                self._snapshot_locked()

    # --------------------------------------------------------- views

    def goodput_so_far(self) -> float | None:
        """In-flight approximation: 1 - (ledgered losses + downtime) /
        wall. The offline reducer additionally splits compile/replay
        out of the productive share; this is the monotone headline an
        operator watches, not the final accounting."""
        if self._first_wall is None or self._last_wall is None:
            return None
        wall = self._last_wall - self._first_wall
        if wall <= 0:
            return None
        return max(0.0, min(1.0, 1.0 - self._loss_s / wall))

    def availability(self) -> float | None:
        if self._first_wall is None or self._last_wall is None:
            return None
        wall = self._last_wall - self._first_wall
        if wall <= 0:
            return None
        return max(0.0, 1.0 - min(self._downtime_s, wall) / wall)

    def sketch_payload(self) -> dict:
        """The /sketches.json payload: the SERIALIZED (mergeable)
        sketches, not just their quantile summaries — what a
        FleetCollector polls so fleet quantiles are exact bucket
        unions, the same payload a schema-v8 ``"monitor"`` event
        carries."""
        with self._lock:
            return {"sketches": self.sketches.to_dict(),
                    "rel_err": self.sketches.rel_err,
                    "label": self.label,
                    "exemplars": {name: [{"value": v, "id": rid}
                                         for v, rid in ex]
                                  for name, ex in self.exemplars.items()},
                    "counters": dict(self.counters)}

    def profile_payload(self) -> dict:
        """The /profile.json payload: the attached ProfilerPlane's
        cumulative snapshot (live path), else the last "profile" event
        seen in the stream (tailer path), else a typed
        `{"enabled": False}` — an old or unprofiled replica answers
        200 with a miss, and a fleet poller treats absence as
        "no profile", never as "replica dead"."""
        if self.profiler is not None:
            return self.profiler.profile_payload()
        with self._lock:
            if self.last_profile is not None:
                snap = {k: v for k, v in self.last_profile.items()
                        if k not in ("event", "t", "wall", "mono")}
                return {"enabled": True, "source": "log", **snap}
        return {"enabled": False}

    def status(self) -> dict:
        """The /status.json payload."""
        with self._lock:
            now = self._now()
            return {
                "replica": self.label,
                "wall": round(now, 3),
                "uptime_s": (round(now - self._first_wall, 3)
                             if self._first_wall is not None else None),
                "sketches": self.sketches.summary(),
                "rel_err": self.sketches.rel_err,
                "goodput_so_far": self.goodput_so_far(),
                "availability": self.availability(),
                "health": self.health,
                "last_step": self.last_step,
                "serving": self.serving or None,
                # the numerics observatory's last-seen story (schema
                # v13): live precision, clamp fractions, shadow-parity
                # rel-errs, and the last verdicts that fired
                "numerics": self.numerics or None,
                # the memory observatory's last-seen story (schema
                # v15): per-owner decomposition, untracked residual,
                # host RSS, last recovered OOM + forensic payload
                "memory": self.memory or None,
                # the slowest finished request's per-component
                # decomposition — where ITS latency went,
                # one hop from the burning quantile
                "slowest_request": self.slowest_request,
                "last_fault": self.last_fault,
                "slo": [r.status(now) for r in self.rules],
                "alerts": sorted(self.active_alerts.values(),
                                 key=lambda a: a.get("slo", "")),
                "worst": {name: [{"value": v, "id": rid}
                                 for v, rid in ex]
                          for name, ex in self.exemplars.items()}
                or None,
                "counters": dict(self.counters),
                "flight_dumps": list(self.flight.dumps),
            }

    def prometheus(self) -> str:
        """The /metrics payload (Prometheus text exposition 0.0.4)."""
        with self._lock:
            P = "shallowspeed_"
            lines = [f"# TYPE {P}up gauge", f"{P}up 1"]
            for name, sk in sorted(self.sketches.sketches.items()):
                if not sk.n:
                    continue
                base = P + re.sub(r"[^a-zA-Z0-9_]", "_", name)
                lines.append(f"# TYPE {base} summary")
                for q in (0.5, 0.95, 0.99):
                    v = sk.quantile(q * 100)
                    lines.append(f'{base}{{quantile="{q}"}} {v:.6g}')
                lines.append(f"{base}_sum {sk.total:.6g}")
                lines.append(f"{base}_count {sk.n}")
                # ... and the NATIVE histogram alongside:
                # cumulative le buckets on the fixed ladder, so fleet
                # quantiles aggregate correctly in Prometheus instead
                # of averaging pre-computed per-replica quantiles
                lines.extend(prom_histogram_lines(base, sk))
            for name, v in (("goodput_so_far", self.goodput_so_far()),
                            ("availability", self.availability())):
                if v is not None:
                    lines.append(f"# TYPE {P}{name} gauge")
                    lines.append(f"{P}{name} {v:.6g}")
            for field in ("queue_depth", "active_slots", "free_blocks",
                          "spec_accept_rate", "prefix_hit_rate",
                          "cold_blocks", "prefix_blocks",
                          "live_blocks", "blocks_needed",
                          "headroom_blocks"):
                v = self.serving.get(field)
                if isinstance(v, (int, float)):
                    lines.append(f"# TYPE {P}{field} gauge")
                    lines.append(f"{P}{field} {v:.6g}")
            for field in ("hbm_live_mib", "hbm_untracked_mib",
                          "host_rss_mib"):
                v = self.memory.get(field)
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    lines.append(f"# TYPE {P}{field} gauge")
                    lines.append(f"{P}{field} {v:.6g}")
            for field in ("num_overflow_max", "num_underflow_max",
                          "num_scale_min", "num_amax_max",
                          "num_parity_loss_rel",
                          "num_parity_grad_relmax"):
                v = self.numerics.get(field)
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    lines.append(f"# TYPE {P}{field} gauge")
                    lines.append(f"{P}{field} {v:.6g}")
            if self.numerics.get("num_precision") in ("fp8", "bf16"):
                lines.append(f"# TYPE {P}num_precision_fp8 gauge")
                lines.append(
                    f"{P}num_precision_fp8 "
                    f"{1 if self.numerics['num_precision'] == 'fp8' else 0}")
            if self.last_step and isinstance(
                    self.last_step.get("step"), int):
                lines.append(f"# TYPE {P}last_step gauge")
                lines.append(f"{P}last_step {self.last_step['step']}")
            lines.append(f"# TYPE {P}alerts_firing gauge")
            lines.append(f"{P}alerts_firing {len(self.active_alerts)}")
            for name in ("steps", "requests", "faults", "restarts",
                         "flight_dumps"):
                lines.append(f"# TYPE {P}{name}_total counter")
                lines.append(f"{P}{name}_total {self.counters[name]}")
            lines.append(f"{P}health_ok "
                         f"{1 if self.health == 'ok' else 0}")
            return "\n".join(lines) + "\n"


# ------------------------------------------------------- HTTP server


class StatusServer:
    """stdlib status endpoint: GET /status.json and /metrics on
    127.0.0.1:`port` (port 0 picks a free one — read `.port`). Runs on
    a daemon thread; `close()` shuts it down. No auth, loopback bind —
    an operator tunnel (ssh -L) is the expected transport.

    Unknown paths answer 404 with a JSON error body — a
    TYPED miss, so a fleet poller probing /profile.json on an old
    replica can distinguish "endpoint absent" (HTTP 404 + parseable
    body) from "replica dead" (connection refused/timeout) without
    burning availability.

    Duck-typed over `monitor`: anything with `status()`/`prometheus()`
    serves (a `fleet.FleetCollector` plugs in unchanged). Objects that
    also expose `sketch_payload()` get GET /sketches.json (the
    serialized mergeable sketches a fleet poller needs); objects with
    `profile_payload()` get GET /profile.json (the continuous-profiler
    snapshot a fleet merges into its flamegraph); objects with
    `register_replica(payload)` / `deregister_replica(payload)` get
    POST /register and /deregister (a replica announcing — or, on
    clean drain, withdrawing — its status URL at a fleet collector);
    objects with `submit_request` / `poll_requests` / `drain_request`
    (a `serving.router.RequestGateway`) get POST /submit, GET
    /requests and POST /drain — the replica-side request-ingestion
    surface the fleet router drives. `extra` grafts a second target
    behind the same port (serve.py serves its Monitor AND its gateway
    on one endpoint); the first of (monitor, extra) providing a method
    wins."""

    # POST path -> duck-typed method on the served object(s)
    _POSTS = {"/register": "register_replica",
              "/deregister": "deregister_replica",
              "/submit": "submit_request",
              "/drain": "drain_request"}

    def __init__(self, monitor: Monitor, port: int = 0,
                 host: str = "127.0.0.1", extra=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        def find(name):
            for obj in (monitor, extra):
                if obj is not None and hasattr(obj, name):
                    return getattr(obj, name)
            return None

        posts = {path: find(meth) for path, meth in self._POSTS.items()
                 if find(meth) is not None}
        mon = monitor
        poll_requests = find("poll_requests")
        profile_payload = find("profile_payload")

        class _Handler(BaseHTTPRequestHandler):
            def _send(self, body: bytes, ctype: str,
                      status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _miss(self, path: str) -> None:
                # typed 404: JSON body, so a poller can tell "endpoint
                # absent on this replica" from "replica dead"
                self._send(json.dumps(
                    {"error": "not found", "path": path}).encode(),
                    "application/json", status=404)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path in ("/status.json", "/status", "/"):
                        body = json.dumps(mon.status(),
                                          default=str).encode()
                        ctype = "application/json"
                    elif path == "/sketches.json" \
                            and hasattr(mon, "sketch_payload"):
                        body = json.dumps(mon.sketch_payload(),
                                          default=str).encode()
                        ctype = "application/json"
                    elif path == "/profile.json" \
                            and profile_payload is not None:
                        body = json.dumps(profile_payload(),
                                          default=str).encode()
                        ctype = "application/json"
                    elif path == "/requests" \
                            and poll_requests is not None:
                        body = json.dumps(poll_requests(),
                                          default=str).encode()
                        ctype = "application/json"
                    elif path == "/metrics":
                        body = mon.prometheus().encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    else:
                        self._miss(path)
                        return
                except Exception as e:   # a status bug must not 500-loop
                    body = json.dumps({"error": repr(e)}).encode()
                    ctype = "application/json"
                self._send(body, ctype)

            def do_POST(self):
                path = self.path.split("?")[0]
                fn = posts.get(path)
                if fn is None:
                    self._miss(path)
                    return
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    out = fn(payload)
                except Exception as e:
                    self.send_error(400, repr(e)[:120])
                    return
                self._send(json.dumps(out, default=str).encode(),
                           "application/json")

            def log_message(self, *a):   # no per-request stderr spam
                pass

        try:
            self._srv = ThreadingHTTPServer((host, int(port)), _Handler)
        except OSError as e:
            # a busy --monitor-port must fail with the port in the
            # message, not a bare errno traceback three frames deep
            raise PortInUseError(
                f"cannot bind the monitor endpoint to {host}:{port} "
                f"({e.strerror or e}); pick another --monitor-port "
                f"(0 asks the OS for a free one)") from e
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self.host = host
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="monitor-http",
                                        daemon=True)
        self._thread.start()

    def url(self, path: str = "/status.json") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5)


# ------------------------------------------------- driver-side wiring


def from_args(args, metrics, flight_dir=None, extra=None):
    """One-call driver wiring: build the Monitor + StatusServer when
    any of --monitor-port / --slo / --flight-recorder is set, attach
    it to the MetricsLogger (every logged line flows into
    `note_line`), and return (monitor, server) — (None, None) when the
    plane is off. `extra` (serve.py's request gateway) is grafted onto
    the same endpoint (see StatusServer) and forces the plane on. The
    caller owns `close_monitor(monitor, server)` at teardown."""
    port = getattr(args, "monitor_port", None)
    slo = getattr(args, "slo", "") or ""
    flight = int(getattr(args, "flight_recorder", 0) or 0)
    if port is None and not slo and not flight and extra is None:
        return None, None
    if flight_dir is None:
        log_file = getattr(args, "log_file", "") or ""
        flight_dir = Path(log_file).parent if log_file else Path(".")
    mon = Monitor(slos=slo, flight=flight, flight_dir=flight_dir,
                  emit=metrics.log if metrics is not None else None,
                  label=getattr(args, "replica", None) or None)
    if metrics is not None:
        metrics.monitor = mon
    server = StatusServer(mon, port=port, extra=extra) \
        if port is not None else None
    return mon, server


def close_monitor(monitor, server) -> None:
    if server is not None:
        server.close()
    if monitor is not None:
        monitor.close()


# ------------------------------------------------------- live tailer


def iter_jsonl(path, pos: int = 0):
    """Parse records from `path` starting at byte `pos`; returns
    (records, new_pos). Tolerates a partial last line (the writer may
    be mid-append) by not consuming it. A file SHORTER than `pos`
    means it was truncated or rotated under us — restart from byte 0
    (re-reading a rotated file beats the old behavior of silently
    reading nothing forever)."""
    recs = []
    try:
        with open(path, "rb") as f:
            if os.fstat(f.fileno()).st_size < pos:
                pos = 0
            f.seek(pos)
            data = f.read()
    except OSError:
        return recs, pos
    if not data:
        return recs, pos
    end = data.rfind(b"\n")
    if end < 0:
        return recs, pos
    for line in data[:end].splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            recs.append(json.loads(line))
        except ValueError:
            continue
    return recs, pos + end + 1


class FileTailer(threading.Thread):
    """Daemon thread feeding a growing metrics JSONL into a Monitor —
    the elastic supervisor's aggregation path (the ledger file spans
    every child stanza, so one tailer sees the whole gang history)."""

    def __init__(self, path, monitor: Monitor, poll: float = 0.5):
        super().__init__(name="monitor-tail", daemon=True)
        self.path = str(path)
        self.monitor = monitor
        self.poll = float(poll)
        # NOT named _stop: threading.Thread owns that attribute (its
        # join machinery calls self._stop() internally)
        self._halt = threading.Event()
        self._pos = 0
        self._ino: int | None = None

    def drain(self) -> int:
        # rotation to an EQUAL-OR-LARGER file defeats iter_jsonl's
        # size check — a changed inode means a different file, restart
        # from byte 0 (shrinkage is caught either way)
        try:
            ino = os.stat(self.path).st_ino
        except OSError:
            ino = None
        if ino is not None:
            if self._ino is not None and ino != self._ino:
                self._pos = 0
            self._ino = ino
        recs, self._pos = iter_jsonl(self.path, self._pos)
        for rec in recs:
            self.monitor.note_line(rec)
        return len(recs)

    def run(self):
        while not self._halt.is_set():
            self.drain()
            self._halt.wait(self.poll)
        self.drain()

    def stop(self):
        self._halt.set()
        self.join(timeout=5)


def format_status(status: dict) -> str:
    """Human-readable rendering of one /status.json payload (the
    --live terminal view)."""
    lines = []
    up = status.get("uptime_s")
    head = [f"uptime {up:.0f}s" if up is not None else "uptime —"]
    for key in ("goodput_so_far", "availability"):
        v = status.get(key)
        if v is not None:
            head.append(f"{key.replace('_so_far', '')} {v:.1%}")
    head.append(f"health {status.get('health', '?')}")
    lines.append("  ".join(head))
    ls = status.get("last_step")
    if ls:
        bits = [f"step {ls.get('step')}"]
        if isinstance(ls.get("loss"), (int, float)):
            bits.append(f"loss {ls['loss']:.4f}")
        if isinstance(ls.get("tokens_per_sec"), (int, float)):
            bits.append(f"tok/s {ls['tokens_per_sec']:,.0f}")
        lines.append("  ".join(bits))
    for name, sk in (status.get("sketches") or {}).items():
        lines.append(
            f"  {name:<12} n={sk['count']:<7} p50 {sk.get('p50')}  "
            f"p95 {sk.get('p95')}  p99 {sk.get('p99')}  "
            f"[{sk.get('min')} .. {sk.get('max')}]")
    srv = status.get("serving")
    if srv:
        lines.append("  serving " + "  ".join(
            f"{k}={v}" for k, v in sorted(srv.items())))
    for s in status.get("slo") or []:
        lines.append(f"  slo {s['slo']:<24} {s['state']:<8} "
                     f"burn fast/slow {s['burn_fast']}/{s['burn_slow']}")
    for a in status.get("alerts") or []:
        lines.append(f"  ALERT {a.get('severity', '?').upper()} "
                     f"{a.get('slo')} burn {a.get('burn_fast')}/"
                     f"{a.get('burn_slow')}")
    lf = status.get("last_fault")
    if lf:
        lines.append(f"  last fault: {lf.get('kind')} "
                     f"(step {lf.get('step')})")
    for p in status.get("flight_dumps") or []:
        lines.append(f"  flight recorder: {p}")
    return "\n".join(lines)


def live_main(path, slos: str = "", once: bool = False,
              interval: float = 2.0, out=print, max_secs=None) -> int:
    """``python -m shallowspeed_tpu_torch.telemetry --live <jsonl>``: tail a
    growing metrics file and render the same view the /status.json
    endpoint serves — live monitoring for runs started without
    --monitor-port. `once` renders the current state and exits (the
    pre-commit smoke); otherwise polls until Ctrl-C / `max_secs`."""
    mon = Monitor(slos=slos, flight=0, derive_steps=True,
                  snapshot_every=0)
    pos = 0
    t0 = time.time()
    if not Path(path).exists() and once:
        out(f"--live: no such file {path}")
        return 1
    while True:
        recs, pos = iter_jsonl(path, pos)
        for rec in recs:
            mon.note_line(rec)
        out(f"== {path} @ {time.strftime('%H:%M:%S')} "
            f"({mon.counters['lines']} lines)")
        out(format_status(mon.status()))
        if once or (max_secs is not None
                    and time.time() - t0 >= max_secs):
            return 0
        try:
            time.sleep(interval)
        except KeyboardInterrupt:
            return 0
