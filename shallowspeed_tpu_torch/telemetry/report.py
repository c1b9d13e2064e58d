"""RunTelemetry — the driver-facing aggregator, counterpart of
`shallowspeed_tpu/telemetry/report.py`.

One object per training run. Every engine of the port exposes
`telemetry_traffic()` — the collective bytes and calls per grid axis
its last step moved, counted as they ran (`collectives.py`) — in place
of the reference's `telemetry_entrypoints()`, whose compiled programs
the reference traces for a static report. RunTelemetry turns that plus
the live process state into:

- per-log-point STEP FIELDS merged into `metrics.StepRates` lines:
  allocated device memory (`hbm_live_mib`) and its peak
  (`hbm_alloc_peak_mib`, CUDA only), the per-owner decomposition
  (`hbm_owned_mib`, `hbm_untracked_mib`), host RSS, the memory
  verdicts, and the step's counted traffic (`coll_bytes_per_step`,
  `coll_bytes_by_axis`, the implied `coll_gbps` over the closed
  window; the VM's cumulative `comm_bytes` as `coll_bytes_measured`,
  as the reference's VM reports it);
- an end-of-run summary (`telemetry.json`, written into the trace dir
  next to the spans).

At the `spans` level the step lines also carry the `attrib_*`
waterfall (`attribution.py`): the q25 of the window's fenced step
spans reconciled against the roofline of one real step (counted once,
on the first spans-level step the driver runs through `count_step`,
and cached as the reference caches its static report), the counted
collective bytes as exposed bytes (exposure 1.0, the reference's value
when it has no `exposed_comm_frac`), the bubble (`set_bubble`, from
`bubble.py`) and the window's host gap; the port adds `attrib_hbm_frac`
(the non-matmul bytes' share) and `attrib_wire` (which wire rate priced
the collective bytes). A goodput ledger the driver stamps (`ledger`)
rides the run summary.

The reference's fields the port has no quantity for stay absent, as
the reference leaves them absent when it lacks the input:
`compiles` / `recompiles` (an eager port compiles no executables),
`hbm_static_mib` / `hbm_within_bound` (no static memory walk: the
jaxpr analysis is not ported), `exposed_comm_frac` / `overlap_ratio`
(the same analysis).

The request helpers (`percentile`, `request_summary`,
`request_timeline`, `request_waterfall`) are copies of the
reference's: the serving driver and the trace stitcher reduce their
records with them.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

from shallowspeed_tpu_torch.telemetry import memory

MiB = float(1 << 20)


def percentile(vals, q: float) -> float | None:
    """Nearest-rank percentile (q in [0, 100]) without numpy dtype
    surprises — None on empty input. The ONE quantile definition the
    repo shares: the request-latency summary below, the goodput
    reducer's serving block, the attribution q25 step-time pick, and
    the streaming sketches (`sketch.LogHistogram.quantile`) all use
    this rank rule, so live and offline quantiles can only disagree by
    the sketch's documented rel_err — never by rank convention.

    Rank = floor(q/100 * (n-1) + 0.5): round-HALF-UP. Python's
    round() rounds half to even (banker's), which maps an exact .5
    rank DOWN whenever the lower rank is even — p50 of 18 samples
    would read sample 8, not 9."""
    vals = sorted(float(v) for v in vals)
    if not vals:
        return None
    k = min(len(vals) - 1,
            max(0, math.floor(q / 100.0 * (len(vals) - 1) + 0.5)))
    return vals[k]


def request_summary(recs) -> dict | None:
    """Reduce schema-v6 `"request"` records (dicts with ttft_ms /
    tpot_ms / tokens_* / preempted — the serving engine's completion
    stamps) to the SLO headline: p50/p95 time-to-first-token and
    time-per-output-token, total tokens moved, preemption count.
    Returns None when there are no request records, so training-run
    summaries stay unchanged."""
    recs = [r for r in recs if isinstance(r, dict) and "ttft_ms" in r]
    if not recs:
        return None
    ttft = [r["ttft_ms"] for r in recs
            if isinstance(r.get("ttft_ms"), (int, float))]
    tpot = [r["tpot_ms"] for r in recs
            if isinstance(r.get("tpot_ms"), (int, float))]
    rnd = lambda v: None if v is None else round(v, 3)  # noqa: E731
    return {
        "n_requests": len(recs),
        "ttft_ms_p50": rnd(percentile(ttft, 50)),
        "ttft_ms_p95": rnd(percentile(ttft, 95)),
        "tpot_ms_p50": rnd(percentile(tpot, 50)),
        "tpot_ms_p95": rnd(percentile(tpot, 95)),
        "tokens_in": sum(int(r.get("tokens_in", 0)) for r in recs),
        "tokens_out": sum(int(r.get("tokens_out", 0)) for r in recs),
        "preempted": sum(int(r.get("preempted", 0)) for r in recs),
    }


def request_timeline(source, rid: str | None = None) -> dict:
    """Reconstruct per-request phase timelines from schema-v8
    ``"lifecycle"`` events (`serving/engine.ServingEngine._lifecycle`:
    submit -> queued -> admitted -> prefill chunk k -> decoding ->
    preempted -> requeued -> finished).

    `source` is a metrics-JSONL path or an iterable of parsed records;
    `rid` filters to one request. Returns, per request id:

        {"phases": [{"phase", "wall", "ms_in_prev", ...}, ...],
         "by_phase_ms": {phase: total ms spent IN that phase},
         "complete": started with submit and ended with finished,
         "attempts": cross-engine dispatch attempts merged,
         "e2e_ms": submit -> finished wall span (None if incomplete)}

    Time spent "in" a phase is attributed by the NEXT transition's
    ms_in_prev (or wall delta when absent), so the sum of by_phase_ms
    reconciles with e2e_ms up to stamp rounding — the fleet view's
    worst-ttft exemplar resolves to which PHASE through this.

    One rid's events can span MULTIPLE engine attempts (a failover
    re-dispatch; schema v11 stamps ``attempt``, and a resumed attempt
    opens with ``submit`` carrying the ``resumed`` marker). The
    reduction is keyed on (rid, attempt): each attempt's seq counter
    restarts at 0, so a rid-only sort would interleave two attempts'
    events, and the wall-delta fallback across two PROCESSES' clocks
    would book the cross-attempt gap — arbitrary skew — into a phase.
    Attempts merge in order; no ms is attributed across an attempt
    boundary (the stitched waterfall's rq_failover_gap owns that
    interval, with skew corrected)."""
    if isinstance(source, (str, Path)):
        recs = []
        for line in Path(source).read_text().splitlines():
            if not line.strip():
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    else:
        recs = list(source)
    per: dict[str, dict[int, list]] = {}
    seen_submits: dict[str, int] = {}
    for rec in recs:
        if not isinstance(rec, dict) or rec.get("event") != "lifecycle":
            continue
        r = rec.get("id")
        if not isinstance(r, str) or (rid is not None and r != rid):
            continue
        att = rec.get("attempt")
        if not isinstance(att, int) or isinstance(att, bool):
            # pre-v11 logs: derive the attempt index from the resumed
            # markers — every "submit" after the first opens a new one
            if rec.get("phase") == "submit":
                seen_submits[r] = seen_submits.get(r, -1) + 1
            att = max(0, seen_submits.get(r, 0))
        per.setdefault(r, {}).setdefault(att, []).append(rec)
    out = {}
    for r, attempts in per.items():
        phases = []
        by_phase: dict[str, float] = {}
        # order attempts by index, then walk each attempt's events by
        # its OWN seq counter; the (prev, cur) accounting below never
        # crosses an attempt boundary
        ordered = []
        for att in sorted(attempts):
            events = attempts[att]
            events.sort(key=lambda e: (e.get("seq", 0),
                                       e.get("wall", 0.0)))
            ordered.append(events)
        for events in ordered:
            for prev, cur in zip([None] + events, events):
                entry = {k: cur[k] for k in
                         ("phase", "wall", "ms_in_prev", "prev", "slot",
                          "tick", "chunk", "tokens", "attempt",
                          "resumed", "trace", "blocks") if k in cur}
                phases.append(entry)
                if prev is None:
                    continue
                ms = cur.get("ms_in_prev")
                if not isinstance(ms, (int, float)):
                    w0, w1 = prev.get("wall"), cur.get("wall")
                    ms = ((w1 - w0) * 1e3
                          if isinstance(w0, (int, float))
                          and isinstance(w1, (int, float)) else 0.0)
                name = cur.get("prev", prev.get("phase", "?"))
                by_phase[name] = by_phase.get(name, 0.0) + float(ms)
        complete = bool(phases) and phases[0]["phase"] == "submit" \
            and phases[-1]["phase"] == "finished"
        e2e = None
        if complete and len(ordered) == 1 \
                and isinstance(phases[0].get("wall"), (int, float)) \
                and isinstance(phases[-1].get("wall"), (int, float)):
            # the single-attempt wall span; across attempts the stamps
            # come from different processes' clocks, so the honest e2e
            # is the stitcher's (router-clock) number, not a raw delta
            e2e = round((phases[-1]["wall"] - phases[0]["wall"]) * 1e3,
                        3)
        # v14: prefill the prefix cache skipped, booked EXPLICITLY (a
        # cache-hit request's rq_prefill is honestly fast — the
        # prefill_cached stamps say how many tokens never ran)
        skipped = sum(p.get("tokens", 0) for p in phases
                      if p.get("phase") == "prefill_cached"
                      and isinstance(p.get("tokens"), int))
        out[r] = {"phases": phases,
                  "by_phase_ms": {k: round(v, 3)
                                  for k, v in sorted(by_phase.items())},
                  "complete": complete,
                  "attempts": len(ordered),
                  "skipped_tokens": skipped,
                  "e2e_ms": e2e}
    return out


def request_waterfall(journey: dict) -> dict | None:
    """Reduce one stitched journey (`telemetry/tracing.build_journeys`)
    into the per-request latency waterfall: ``rq_*_ms`` components plus
    matching ``rq_*_frac`` fractions that sum to the measured e2e BY
    CONSTRUCTION — ``rq_unexplained`` is the residual between the
    named segments and the router-measured e2e, so it doubles as the
    stitching-quality alarm (clock misfit or missing streams inflate
    it). None when the journey has no usable e2e."""
    from shallowspeed_tpu_torch.telemetry.tracing import COMPONENTS

    e2e = journey.get("e2e_ms")
    if not isinstance(e2e, (int, float)) or e2e <= 0.0:
        return None
    comps = {name: 0.0 for name in COMPONENTS}
    for seg in journey.get("segments") or ():
        comps[seg["component"]] = (comps.get(seg["component"], 0.0)
                                   + float(seg["ms"]))
    out = {"e2e_ms": round(float(e2e), 3)}
    named = 0.0
    for name in COMPONENTS:
        out[f"{name}_ms"] = round(comps[name], 3)
        out[f"{name}_frac"] = round(comps[name] / e2e, 4)
        named += comps[name]
    out["rq_unexplained_ms"] = round(e2e - named, 3)
    out["rq_unexplained_frac"] = round((e2e - named) / e2e, 4)
    return out


class RunTelemetry:
    """Aggregates telemetry for one engine over one training run."""

    def __init__(self, engine, tracer=None, dtype: str = "bf16"):
        self.engine = engine
        self.tracer = tracer
        self.dtype = dtype          # the peak the waterfall prices at
        self._bubble: dict = {}
        self._roof = None           # roofline of the counted step
        self._span_mark = 0         # tracer seq at the last log point
        self._attrib_scale = None   # frozen self-calibration factor
        self._attrib_cals = 0       # windows the scale was fit on
        # a goodput.GoodputLedger the driver also stamps: its totals
        # ride the run summary
        self.ledger = None
        self.memwatch = memory.MemoryWatch()
        self._mem_windows = 0

    # ------------------------------------------------------- roofline

    def count_step(self, fn, *args, **kwargs):
        """`fn(*args, **kwargs)`, one training step: at the `spans`
        level, the first call runs it under `attribution.
        roofline_of_step` and keeps the roofline; every other call just
        runs it."""
        tr = self.tracer
        if self._roof is not None or tr is None or tr.level != "spans":
            return fn(*args, **kwargs)
        from shallowspeed_tpu_torch.telemetry import attribution, bubble

        out, self._roof = attribution.roofline_of_step(
            fn, *args, cells=len(bubble.engine_cells(self.engine)),
            **kwargs)
        return out

    @property
    def roofline(self) -> dict | None:
        """The counted step's roofline inputs (None before the count)."""
        return self._roof

    def static_report(self) -> None:
        """The reference's one-time static report (jaxpr traffic, HBM
        prediction) needs the jaxpr walk the port does not have: None,
        the reference's value for an engine without entrypoints."""
        return None

    # ---------------------------------------------------------- steps

    @property
    def bubble(self) -> dict:
        """The bubble fields currently attached to step lines."""
        return dict(self._bubble)

    def set_bubble(self, **fields) -> None:
        """Attach bubble accounting (static fraction and, when a
        calibration or an executed trace produced one, the measured
        fraction) — merged into every subsequent step line."""
        self._bubble.update(fields)

    def _traffic(self) -> dict | None:
        fn = getattr(self.engine, "telemetry_traffic", None)
        return None if fn is None else fn()

    def step_fields(self, window_secs: float | None = None,
                    steps_in_window: int | None = None) -> dict:
        """The telemetry fields a step line carries. Reads the
        allocator's counters (host-side, no device sync)."""
        out: dict = {}
        live = memory.live_hbm_high_water()
        out["hbm_live_mib"] = round(live["max_device_bytes"] / MiB, 2)
        stats = memory.device_memory_stats()
        peaks = [v.get("peak_bytes_in_use") for v in stats.values()
                 if v.get("peak_bytes_in_use")]
        if peaks:
            out["hbm_alloc_peak_mib"] = round(max(peaks) / MiB, 2)
        if memory.registered_owners():
            acct = memory.per_owner_accounting()
            out["hbm_owned_mib"] = {
                name: round(b / MiB, 2)
                for name, b in acct["owners"].items()}
            out["hbm_untracked_mib"] = round(
                acct["untracked_bytes"] / MiB, 2)
        rss = memory.host_rss_bytes()
        if rss:
            out["host_rss_mib"] = round(rss / MiB, 2)
        self._mem_windows += 1
        mem_verdicts = self.memwatch.observe(
            self._mem_windows,
            device_bytes=live["max_device_bytes"] or None,
            rss_bytes=rss or None)
        if mem_verdicts:
            out["mem_verdicts"] = [str(v) for v in mem_verdicts]
        traffic = self._traffic()
        if traffic is not None:
            out["coll_bytes_per_step"] = int(traffic["total_bytes"])
            out["coll_bytes_by_axis"] = {
                ax: v["bytes"] for ax, v in traffic["per_axis"].items()}
            if window_secs and steps_in_window:
                gbps = (traffic["total_bytes"] * steps_in_window
                        / window_secs / 1e9)
                out["coll_gbps"] = round(gbps, 6)
        measured = getattr(self.engine, "comm_bytes", None)
        if isinstance(measured, dict):
            out["coll_bytes_measured"] = dict(measured)
        out.update(self._bubble)
        # the roofline waterfall — spans level only (the step spans are
        # device-fenced there, so their durations are attributable time)
        out.update(self._attribution(window_secs, traffic))
        return out

    def _attribution(self, window_secs, traffic) -> dict:
        """attrib_* fields for the window just closed: the q25 of its
        fenced step spans reconciled against the counted step's
        roofline, the step's counted collective bytes (all exposed),
        the bubble and the window's host gap (`attribution.py`)."""
        tr = self.tracer
        if tr is None or tr.level != "spans":
            return {}
        from shallowspeed_tpu_torch.telemetry import attribution as attr
        from shallowspeed_tpu_torch.telemetry import bubble as bub

        events = tr.events_since(self._span_mark)
        self._span_mark = tr.event_count
        durs = attr.window_step_spans(events)
        if not durs or self._roof is None:
            return {}
        # lower quartile: the repeatable fast mode of the window's steps
        t_step = percentile(durs, 25)
        if t_step <= 0.0:
            return {}
        roof = self._roof
        exposed = int(traffic["total_bytes"]) if traffic else 0
        host_gap = None
        if window_secs:
            host_gap = max(0.0, window_secs - sum(durs)) / len(durs)
        bubble = self._bubble.get("bubble_measured",
                                  self._bubble.get("bubble_static"))
        devices = bub.engine_devices(self.engine)
        n_dev = max(1, len(devices))
        shared = len(bub.engine_cells(self.engine)) > n_dev
        rates = attr.device_rates(dtype=self.dtype, device=devices[0],
                                  shared=shared)
        scale = None
        if rates.get("source") == "calibrated":
            # no published peak (the CPU): the probe fixes only the
            # matmul/bytes split — self-scale the compute component over
            # the first two windows, then freeze it (the reference's rule)
            if self._attrib_cals < 2:
                secs = attr.roofline_seconds(roof, rates, n_dev)
                other = ((0.0 if bubble is None else float(bubble))
                         + (0.0 if host_gap is None
                            else host_gap / t_step)
                         + exposed / rates["ici"] / t_step)
                residual = max(0.05, 1.0 - other) * t_step
                self._attrib_scale = residual / max(
                    secs["mxu_s"] + secs["hbm_s"], 1e-12)
                self._attrib_cals += 1
            scale = self._attrib_scale
        out = attr.step_waterfall(
            t_step, roofline=roof, coll_bytes=exposed,
            bubble_fraction=bubble, host_gap=host_gap, n_devices=n_dev,
            dtype=self.dtype, rates=rates, compute_scale=scale)
        secs = attr.roofline_seconds(roof, rates, n_dev)
        out["attrib_hbm_frac"] = round(
            (1.0 if scale is None else scale) * secs["hbm_s"] / t_step, 4)
        out["attrib_wire"] = rates["wire"]
        return out

    # -------------------------------------------------------- summary

    def run_summary(self) -> dict:
        """End-of-run record: the last step's traffic, the final memory
        sample and owners, bubble, and the last health pack (written
        next to the trace)."""
        live = memory.live_hbm_high_water()
        snap = getattr(self.engine, "health_snapshot", None)
        out = {
            "engine": type(self.engine).__name__,
            "static": self.static_report(),
            "traffic": self._traffic(),
            "hbm_live_mib": round(live["max_device_bytes"] / MiB, 2),
            "bubble": self._bubble or None,
            "roofline": self._roof,
            "health": snap() if snap is not None else None,
            # the in-process goodput-ledger totals when the driver
            # stamps one (the cross-restart reduction is
            # goodput.run_goodput over the metrics JSONL)
            "goodput_ledger": (
                {"seconds": self.ledger.seconds(),
                 "counts": self.ledger.counts()}
                if self.ledger is not None else None),
        }
        if memory.registered_owners():
            out["hbm_owners"] = memory.per_owner_accounting()
        return out

    def write_summary(self, trace_dir) -> Path:
        path = Path(trace_dir) / "telemetry.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.run_summary(), indent=2,
                                   default=str))
        return path
