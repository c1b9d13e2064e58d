"""Distributed request tracing — one request, one timeline, N logs.

A copy of `shallowspeed_tpu/telemetry/tracing.py` (pure Python; the
port keeps its own copy rather than import the JAX package).

A fleet request crosses router → replica → (failover) → replica; its
schema-v8 ``"lifecycle"`` events land in per-replica JSONLs with
per-process clocks and no shared identity. This module supplies the
three missing pieces (round 16, schema v11):

- **Trace context.** `Router.submit` mints a `trace` id + root `span`
  per request; every dispatch mints a child span that rides the
  ``POST /submit`` payload into `ServingEngine.submit()` (including
  the ``generated=`` failover re-dispatch), so every lifecycle /
  route / failover / request event carries ``trace``/``span``/
  ``parent`` plus ``attempt`` — the 0-based cross-engine dispatch
  counter that makes one rid's journey joinable across the router and
  N replica logs, breaker-delayed retries and re-prefills included.
- **Stitching + skew correction.** Every metrics line carries a
  ``(wall, mono)`` clock pair (`metrics.MetricsLogger`). `stitch()`
  splits each input file into process stanzas (at ``run_start`` —
  chaos respawns restart the monotonic epoch) and fits ONE offset per
  stanza onto the router's clock from the dispatch transaction the
  trace context brackets: the router's pre-POST stamp
  (``dispatch_wall``/``dispatch_mono`` on ``route``/``failover``)
  precedes the replica's lifecycle ``submit``, the event's own stamp
  follows it, and a lifecycle ``finished`` precedes the router's
  ``request`` record — the minimum-RTT transaction's midpoint is the
  fit, NTP-style (`_fit_offsets`). The result is ONE
  Perfetto-loadable Chrome trace: per-replica phase tracks plus a
  per-request journey track (queue-wait → dispatch → prefill chunks →
  decode → failover gap → re-prefill → decode → finish).
- **Per-request waterfall.** `report.request_waterfall` reduces a
  stitched journey into named components —
  ``rq_queue / rq_dispatch / rq_prefill / rq_decode /
  rq_failover_gap / rq_breaker_wait / rq_unexplained`` — that sum to
  the measured e2e BY CONSTRUCTION (the residual is
  ``rq_unexplained``, the stitching-quality alarm). `goodput_block`
  aggregates a fleet of journeys to p50/p95 per component with
  worst-``rq_unexplained`` exemplars (the ``tracing`` block of
  ``--goodput``).

CLI::

    python -m shallowspeed_tpu_torch.telemetry --trace-stitch \\
        run/router.jsonl run/replica_r0.jsonl run/replica_r1.jsonl \\
        --out stitched.json

Pure stdlib (json/math/statistics), like `monitor` and `sketch` — the
stitcher runs anywhere the logs can be read.
"""

from __future__ import annotations

import json
import secrets
import statistics
from pathlib import Path

# engine lifecycle phase -> waterfall component: the ONE mapping the
# offline stitcher, the live Monitor's per-component sketches, and
# bench's phase accounting share. Time "in" a phase is booked to its
# component; submit/finished are instants (their in-phase time is ~0
# but maps somewhere deterministic anyway).
PHASE_COMPONENT = {
    "submit": "rq_queue",
    "queued": "rq_queue",
    "requeued": "rq_queue",
    "preempted": "rq_queue",
    "admitted": "rq_prefill",
    "prefill_cached": "rq_prefill",   # v14: prefix-cache hit at admit
    "prefill": "rq_prefill",
    "decoding": "rq_decode",
    "finished": "rq_dispatch",   # finished -> router finalize = poll
}

# the named components, in waterfall order (rq_unexplained is the
# residual request_waterfall appends)
COMPONENTS = ("rq_queue", "rq_dispatch", "rq_prefill", "rq_decode",
              "rq_failover_gap", "rq_breaker_wait")


def new_trace_id() -> str:
    """One id per fleet request (128-bit hex, W3C-trace-context
    sized)."""
    return secrets.token_hex(16)


def new_span_id() -> str:
    """One id per hop (router root span, per-dispatch span, per-engine
    attempt span)."""
    return secrets.token_hex(8)


# ------------------------------------------------------------- parsing


def _parse(path) -> list[dict]:
    from shallowspeed_tpu_torch.telemetry.schema import parse_metrics_jsonl

    return parse_metrics_jsonl(path)


def _stanzas(recs: list[dict]) -> list[list[dict]]:
    """Split one file's records at run_start lines: a respawned
    process (chaos drill, supervisor restart) appends a fresh stanza
    with a fresh monotonic epoch — each stanza gets its own offset."""
    out: list[list[dict]] = []
    for rec in recs:
        if rec.get("event") == "run_start" or not out:
            out.append([])
        out[-1].append(rec)
    return out


def _ts(rec: dict, base: str) -> float | None:
    v = rec.get(base)
    return float(v) if isinstance(v, (int, float)) else None


class _Stanza:
    """One process incarnation: a slice of one file with one clock."""

    __slots__ = ("source", "index", "name", "recs", "base", "offset",
                 "pairs", "is_router")

    def __init__(self, source: str, index: int, recs: list[dict]):
        self.source = source
        self.index = index
        self.recs = recs
        start = recs[0] if recs and recs[0].get("event") == "run_start" \
            else {}
        self.is_router = (start.get("kind") == "router"
                          or any(r.get("event") in ("route", "failover")
                                 for r in recs))
        self.name = (start.get("replica")
                     if isinstance(start.get("replica"), str)
                     else "router" if self.is_router
                     else Path(source).stem)
        # prefer the monotonic clock when the stanza stamps it (jump-
        # free within a process); wall is the pre-v11 fallback
        self.base = ("mono" if all(
            isinstance(r.get("mono"), (int, float)) for r in recs)
            else "wall")
        self.offset = 0.0
        self.pairs = {"dispatch": 0, "ack": 0}

    def t(self, rec: dict) -> float | None:
        v = _ts(rec, self.base)
        return v + self.offset if v is not None else None


def _load_stanzas(paths, first_recs=None) -> list[_Stanza]:
    """`first_recs`: already-parsed records for paths[0] (the goodput
    reducer has them in hand — no point re-reading the primary log)."""
    out = []
    for n, path in enumerate(paths):
        recs = first_recs if n == 0 and first_recs is not None \
            else _parse(path)
        for i, chunk in enumerate(_stanzas(recs)):
            if chunk:
                out.append(_Stanza(str(path), i, chunk))
    return out


# ------------------------------------------------------ skew correction


def _clock_delta(s: _Stanza) -> float:
    """This stanza's (mono - wall) epoch delta — the per-process
    clock pair, made robust with the median over every stamped
    line."""
    ds = [float(r["mono"]) - float(r["wall"]) for r in s.recs
          if isinstance(r.get("mono"), (int, float))
          and isinstance(r.get("wall"), (int, float))]
    return statistics.median(ds) if ds else 0.0


def _fit_offsets(stanzas: list[_Stanza]) -> None:
    """Fit each non-router stanza's clock onto the router's.

    Baseline: the per-stanza (wall, mono) clock pair aligns every
    process under the synchronized-wall assumption (offset = the
    router's mono-wall delta minus this stanza's). Refinement — the
    actual skew correction, from the dispatch TRANSACTION the trace
    context brackets: the router stamps a pre-POST clock pair T1
    (``dispatch_wall``/``dispatch_mono`` on the ``route``/``failover``
    event) strictly BEFORE the replica's lifecycle ``submit`` at T2,
    and emits the event itself at T4 strictly AFTER — so for the same
    (trace, attempt): T1 - T2 <= offset <= T4 - T2, and the
    transaction's own estimate is (T1 + T4)/2 - T2 with uncertainty
    (T4 - T1)/2, the POST round trip. The minimum-RTT transaction —
    NTP's filter — gives the fit, clamped into the intersection of
    every pair's bounds plus the ack bound (lifecycle ``finished``
    strictly precedes the router's ``request`` record -> offset <=
    T_r - T_p). The ack leg is NOT used as an estimate on its own:
    finish -> finalize rides the router's progress poll, a one-sided
    seconds-scale lag on a busy fleet; likewise the replica's
    engine-thread INGESTION lag sits between T2 and admission, which
    is why the fit brackets the gateway stamp, not later phases.

    Pre-v11.1 logs (no ``dispatch_*`` pre stamps — e.g. the committed
    trace_r14 artifact) fall back to the event-time heuristic: treat
    T4 - T2 as the dispatch mark and take the midpoint of max(lo) /
    min(hi) — biased late by the POST round trip, but bounded by it.
    A replica whose WALL clock is wrong still lands exactly on the
    router's timeline. Stanzas with no trace pairs (an idle respawn)
    keep the wall-aligned baseline — the best remaining guess."""
    routers = [s for s in stanzas if s.is_router]
    if not routers:
        return
    r0 = routers[0]
    router_delta = _clock_delta(r0) if r0.base == "mono" else 0.0
    # later router stanzas (one log appended across runs — each
    # run_start restarts the mono epoch) wall-align onto the FIRST
    # router stanza's clock; leaving them at offset 0 would mix two
    # mono epochs into one mark set and silently poison every fit
    # (trace ids keep the runs' journeys apart, but the marks share
    # the dicts below)
    for s in routers[1:]:
        s.offset = (router_delta - _clock_delta(s)
                    if s.base == "mono" else router_delta)
    for s in stanzas:
        if not s.is_router:
            s.offset = (router_delta - _clock_delta(s)
                        if s.base == "mono" else router_delta)
    # dispatch marks (T4 event time, T1 pre-POST time or None) / ack
    # marks on the FIRST router stanza's (offset-0) clock
    dispatch: dict[tuple, tuple] = {}
    ack: dict[str, float] = {}
    for s in routers:
        for rec in s.recs:
            ev = rec.get("event")
            tr = rec.get("trace")
            if not isinstance(tr, str):
                continue
            t = s.t(rec)
            if t is None:
                continue
            if ev in ("route", "failover"):
                att = rec.get("attempt") if ev == "failover" else 0
                if isinstance(att, int):
                    pre = rec.get(f"dispatch_{s.base}")
                    dispatch[(tr, att)] = (
                        t, float(pre) + s.offset
                        if isinstance(pre, (int, float)) else None)
            elif ev == "request":
                ack[tr] = t
    # final attempt per trace, across ALL stanzas: a timeout failover
    # abandons live work, and the old replica can stamp "finished"
    # AFTER the router already finalized via the new attempt — only
    # the FINAL attempt's finished is guaranteed to precede the
    # request record, so only it may contribute an ack bound
    final_att: dict[str, int] = {}
    for s in stanzas:
        for rec in s.recs:
            if rec.get("event") != "lifecycle":
                continue
            tr = rec.get("trace")
            if isinstance(tr, str):
                att = rec.get("attempt")
                att = att if isinstance(att, int) else 0
                if att > final_att.get(tr, -1):
                    final_att[tr] = att
    for s in stanzas:
        if s.is_router:
            continue
        lo: list[float] = []    # offset >= router_pre_post - my_submit
        hi: list[float] = []    # offset <= router_event - my_stamp
        samples: list[tuple] = []   # (rtt, est) per pre-stamped pair
        n_dispatch = n_ack = 0
        for rec in s.recs:
            if rec.get("event") != "lifecycle":
                continue
            tr = rec.get("trace")
            if not isinstance(tr, str):
                continue
            t = _ts(rec, s.base)
            if t is None:
                continue
            att = rec.get("attempt")
            att = att if isinstance(att, int) else 0
            if rec.get("phase") == "submit":
                td = dispatch.get((tr, att))
                if td is not None:
                    t4, t1 = td
                    n_dispatch += 1
                    if t1 is not None:
                        lo.append(t1 - t)
                        hi.append(t4 - t)
                        samples.append((t4 - t1,
                                        (t1 + t4) / 2.0 - t))
                    else:
                        # legacy: the event stamp is really an upper
                        # bound, but with no pre stamp the midpoint
                        # heuristic below is the best available
                        lo.append(t4 - t)
            elif rec.get("phase") == "finished" \
                    and att == final_att.get(tr, 0):
                ta = ack.get(tr)
                if ta is not None:
                    n_ack += 1
                    hi.append(ta - t)
        s.pairs = {"dispatch": n_dispatch, "ack": n_ack}
        if samples:
            est = min(samples)[1]
            if lo:
                est = max(est, max(lo))
            if hi:
                est = min(est, min(hi))
            s.offset = est
        elif lo and hi:
            s.offset = (max(lo) + min(hi)) / 2.0
        elif lo:
            s.offset = max(lo)
        elif hi:
            s.offset = min(hi)
        # else: the wall-aligned baseline set above stands


# ------------------------------------------------------------ journeys


def _breaker_open_windows(stanzas) -> list[tuple[float, float]]:
    """Corrected-time windows during which EVERY replica the router
    ever put a breaker on was simultaneously open — the only state in
    which a pending request is waiting on breakers rather than on
    failure detection. No breaker events -> no windows."""
    state: dict[str, bool] = {}
    events: list[tuple[float, str, str]] = []
    for s in stanzas:
        if not s.is_router:
            continue
        for rec in s.recs:
            if rec.get("event") == "ledger" \
                    and rec.get("kind") == "breaker" \
                    and isinstance(rec.get("replica"), str) \
                    and isinstance(rec.get("state"), str):
                t = s.t(rec)
                if t is not None:
                    events.append((t, rec["replica"], rec["state"]))
    events.sort(key=lambda e: e[0])
    windows = []
    open_since: float | None = None
    for t, rep, st in events:
        state[rep] = (st == "open")
        all_open = bool(state) and all(state.values())
        if all_open and open_since is None:
            open_since = t
        elif not all_open and open_since is not None:
            windows.append((open_since, t))
            open_since = None
    if open_since is not None:
        windows.append((open_since, float("inf")))
    return windows


def _overlap(lo: float, hi: float, windows) -> float:
    return sum(max(0.0, min(hi, w1) - max(lo, w0))
               for w0, w1 in windows if w1 > lo and w0 < hi)


def build_journeys(stanzas: list[_Stanza]) -> dict[str, dict]:
    """Join the corrected per-process streams by trace id. Returns
    {trace: journey}; a journey carries the request id, the corrected
    event list, the router marks (submit/dispatches/finish), the
    per-attempt lifecycle groups, and the segment list
    `report.request_waterfall` reduces."""
    journeys: dict[str, dict] = {}

    def j(trace: str) -> dict:
        return journeys.setdefault(trace, {
            "trace": trace, "rid": None,
            "submit_t": None, "finish_t": None, "e2e_ms": None,
            "dispatches": [],        # (t, attempt, replica, event)
            "attempts": {},          # attempt -> [(t, proc, rec)]
            "events": [],            # every correlated event
            "segments": [],
            "sources": set(),
        })

    for s in stanzas:
        for rec in s.recs:
            tr = rec.get("trace")
            if not isinstance(tr, str):
                continue
            t = s.t(rec)
            if t is None:
                continue
            ev = rec.get("event")
            jn = j(tr)
            jn["events"].append((t, s.name, rec))
            jn["sources"].add(s.name)
            rid = rec.get("id")
            if isinstance(rid, str):
                jn["rid"] = jn["rid"] or rid
            if s.is_router:
                if ev == "route":
                    jn["dispatches"].append(
                        (t, 0, rec.get("replica"), rec))
                    w = rec.get("wait_ms")
                    if isinstance(w, (int, float)):
                        jn["submit_t"] = t - float(w) / 1e3
                elif ev == "failover":
                    att = rec.get("attempt")
                    jn["dispatches"].append(
                        (t, att if isinstance(att, int) else None,
                         rec.get("replica"), rec))
                elif ev == "request":
                    e2e = rec.get("e2e_ms")
                    if isinstance(e2e, (int, float)):
                        jn["e2e_ms"] = float(e2e)
                        if jn["submit_t"] is None:
                            jn["submit_t"] = t - float(e2e) / 1e3
                    jn["finish_t"] = t
            elif ev == "lifecycle":
                att = rec.get("attempt")
                att = att if isinstance(att, int) else 0
                jn["attempts"].setdefault(att, []).append(
                    (t, s.name, rec))
    breaker_windows = _breaker_open_windows(stanzas)
    for jn in journeys.values():
        jn["events"].sort(key=lambda e: e[0])
        jn["dispatches"].sort(key=lambda d: d[0])
        for evs in jn["attempts"].values():
            evs.sort(key=lambda e: (e[2].get("seq", 0), e[0]))
        jn["sources"] = sorted(jn["sources"])
        _segment(jn, breaker_windows)
    return journeys


def _segment(jn: dict, breaker_windows) -> None:
    """Carve the journey's router-clock span into contiguous named
    segments. Standalone (router-less) journeys — a lone serve.py —
    degrade to the engine-phase components only."""
    segs: list[dict] = []

    def add(component: str, lo: float, hi: float, **extra) -> None:
        ms = max(0.0, (hi - lo)) * 1e3
        if ms <= 0.0:
            return
        segs.append({"component": component, "t0": lo, "t1": hi,
                     "ms": ms, **extra})

    attempts = sorted(jn["attempts"])
    # engine-side phases, per attempt: [event_i, event_{i+1}] is time
    # IN phase_i (the lifecycle contract). An attempt is TRUNCATED at
    # the next attempt's first event: a timeout failover abandons
    # live work, so the old replica can keep stamping (even
    # "finished") after the router moved the request elsewhere — the
    # user's stream switched at the failover, and booking the
    # abandoned tail would double-count against the real attempt's
    # work (and swallow the failover gap)
    starts = {att: jn["attempts"][att][0][0] for att in attempts}
    cutoff = {att: starts[nxt]
              for att, nxt in zip(attempts, attempts[1:])}
    attempt_bounds: dict[int, tuple[float, float]] = {}
    for att in attempts:
        evs = jn["attempts"][att]
        cut = cutoff.get(att, float("inf"))
        for (t0, proc, r0), (t1, _p1, _r1) in zip(evs, evs[1:]):
            if t0 >= cut:
                continue
            comp = PHASE_COMPONENT.get(r0.get("phase"))
            if comp and comp != "rq_dispatch":
                add(comp, t0, min(t1, cut), attempt=att, replica=proc)
        attempt_bounds[att] = (evs[0][0], min(evs[-1][0], cut))
    # router-side marks
    dispatches = {att: t for t, att, _rep, _rec in jn["dispatches"]
                  if att is not None}
    if jn["submit_t"] is not None and attempts:
        first_mark = (dispatches.get(attempts[0],
                                     attempt_bounds[attempts[0]][0]))
        add("rq_queue", jn["submit_t"], min(
            first_mark, attempt_bounds[attempts[0]][0]))
    if attempts:
        td = dispatches.get(attempts[0])
        if td is not None:
            # first dispatch -> the engine's first lifecycle stamp
            add("rq_dispatch", td, attempt_bounds[attempts[0]][0],
                attempt=attempts[0])
    # failover gaps: the whole hole in the user's stream — last event
    # of attempt k -> FIRST event of attempt k+1 (detection latency +
    # the re-dispatch + the resumed engine's ingestion all live in
    # here, which is why the gap >= the router's recorded detection ->
    # ready interval whenever the stitching is consistent); the
    # sub-span where every breaker was open books to rq_breaker_wait
    for prev, nxt in zip(attempts, attempts[1:]):
        lo = attempt_bounds[prev][1]
        hi = attempt_bounds[nxt][0]
        if hi > lo:
            bw = _overlap(lo, hi, breaker_windows)
            gap_ms = (hi - lo) * 1e3
            if bw > 0:
                segs.append({"component": "rq_breaker_wait",
                             "t0": lo, "t1": hi, "ms": bw * 1e3,
                             "attempt": nxt})
                gap_ms -= bw * 1e3
            if gap_ms > 0:
                segs.append({"component": "rq_failover_gap",
                             "t0": lo, "t1": hi, "ms": gap_ms,
                             "attempt": nxt})
    # tail: engine finished -> the router's request finalize (progress
    # poll + transport, the symmetric half of rq_dispatch)
    if attempts and jn["finish_t"] is not None:
        add("rq_dispatch", attempt_bounds[attempts[-1]][1],
            jn["finish_t"], tail=True)
    if jn["e2e_ms"] is None and attempts:
        # standalone serving: e2e is the engine-phase span
        lo = attempt_bounds[attempts[0]][0]
        hi = attempt_bounds[attempts[-1]][1]
        jn["submit_t"] = jn["submit_t"] or lo
        jn["finish_t"] = jn["finish_t"] or hi
        jn["e2e_ms"] = (hi - lo) * 1e3
    segs.sort(key=lambda s: s["t0"])
    jn["segments"] = segs


# --------------------------------------------------------- chrome trace


def _chrome(stanzas, journeys) -> dict:
    """One Perfetto-loadable Chrome trace: pid per process (router =
    pid 0), per-replica request tracks with the lifecycle phase spans,
    and a per-request journey track on the router pid showing the
    waterfall segments in timeline order."""
    events: list[dict] = []
    t0s = [s.t(r) for s in stanzas for r in s.recs
           if s.t(r) is not None]
    epoch = min(t0s) if t0s else 0.0

    def us(t: float) -> float:
        return round((t - epoch) * 1e6, 1)

    pid_of: dict[str, int] = {}
    for s in stanzas:
        if s.name in pid_of:
            continue
        pid_of[s.name] = 0 if s.is_router else len(pid_of) + 1
    router = [s.name for s in stanzas if s.is_router]
    if router and pid_of.get(router[0]) != 0:
        pid_of[router[0]] = 0
    for name, pid in sorted(pid_of.items(), key=lambda kv: kv[1]):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "ts": 0.0, "args": {"name": name}})
    # replica tracks: one tid per (rid, attempt) within a replica pid
    tids: dict[tuple, int] = {}

    def tid(pid: int, key) -> int:
        k = (pid, key)
        if k not in tids:
            tids[k] = len([1 for p, _ in tids if p == pid]) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tids[k], "ts": 0.0,
                           "args": {"name": str(key)}})
        return tids[k]

    for jn in journeys.values():
        rid = jn["rid"] or jn["trace"][:8]
        for att, evs in sorted(jn["attempts"].items()):
            for (t0, proc, r0), (t1, _p, _r) in zip(evs, evs[1:]):
                pid = pid_of.get(proc, 0)
                events.append({
                    "name": r0.get("phase", "?"), "ph": "X",
                    "pid": pid,
                    "tid": tid(pid, f"{rid}#{att}"),
                    "ts": us(t0), "dur": round((t1 - t0) * 1e6, 1),
                    "args": {"id": rid, "trace": jn["trace"],
                             "attempt": att,
                             "tick": r0.get("tick")}})
        # the journey track on the router pid
        for seg in jn["segments"]:
            events.append({
                "name": seg["component"], "ph": "X", "pid": 0,
                "tid": tid(0, f"request {rid}"),
                "ts": us(seg["t0"]),
                "dur": round(seg["ms"] * 1e3, 1),
                "args": {k: v for k, v in seg.items()
                         if k not in ("t0", "t1")}
                | {"id": rid, "trace": jn["trace"]}})
        for t, att, rep, _rec in jn["dispatches"]:
            events.append({
                "name": "failover" if att else "route", "ph": "i",
                "pid": 0, "tid": tid(0, f"request {rid}"),
                "ts": us(t), "args": {"id": rid, "attempt": att,
                                      "replica": rep}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --------------------------------------------------------------- public


def stitch(paths) -> dict:
    """Stitch N metrics JSONLs (one router log + replica logs, or a
    lone serving log) into one corrected view:

        {"processes": [...per-stanza fit report...],
         "journeys": {trace: journey},
         "chrome": {... Perfetto-loadable ...}}
    """
    stanzas = _load_stanzas(paths)
    _fit_offsets(stanzas)
    journeys = build_journeys(stanzas)
    return {
        "processes": [{"source": s.source, "stanza": s.index,
                       "name": s.name, "router": s.is_router,
                       "clock": s.base,
                       "offset_s": round(s.offset, 6),
                       "pairs": dict(s.pairs)}
                      for s in stanzas],
        "journeys": journeys,
        "chrome": _chrome(stanzas, journeys),
    }


def goodput_block(paths, first_recs=None) -> dict | None:
    """The ``--goodput`` tracing block: fleet-level aggregation of the
    per-request waterfalls — p50/p95 ms per component plus the
    worst-``rq_unexplained`` exemplars (stitching-quality forensics).
    None when no stream carries trace-context lifecycle events.
    `first_recs` forwards the caller's already-parsed paths[0]."""
    from shallowspeed_tpu_torch.telemetry.report import (percentile,
                                                   request_waterfall)

    stanzas = _load_stanzas(paths, first_recs=first_recs)
    if not any(r.get("event") == "lifecycle"
               and isinstance(r.get("trace"), str)
               for s in stanzas for r in s.recs):
        return None
    _fit_offsets(stanzas)
    journeys = build_journeys(stanzas)
    falls = []
    for jn in journeys.values():
        wf = request_waterfall(jn)
        if wf is not None:
            wf["id"] = jn["rid"]
            wf["trace"] = jn["trace"]
            falls.append(wf)
    if not falls:
        return None
    comps = {}
    for name in COMPONENTS + ("rq_unexplained",):
        vals = [wf[f"{name}_ms"] for wf in falls]
        if any(vals):
            comps[name] = {
                "p50_ms": round(percentile(vals, 50), 3),
                "p95_ms": round(percentile(vals, 95), 3)}
    worst = sorted(falls, key=lambda wf: -abs(wf["rq_unexplained_ms"]))
    return {
        "requests": len(falls),
        "components": comps,
        "e2e_p50_ms": round(percentile(
            [wf["e2e_ms"] for wf in falls], 50), 3),
        "worst_unexplained": [
            {"id": wf["id"], "trace": wf["trace"],
             "rq_unexplained_ms": round(wf["rq_unexplained_ms"], 3),
             "e2e_ms": round(wf["e2e_ms"], 3)}
            for wf in worst[:3]],
    }


def format_stitch(st: dict) -> str:
    """Human summary of one stitch (the --trace-stitch console
    surface); the Chrome JSON itself goes to --out."""
    from shallowspeed_tpu_torch.telemetry.report import request_waterfall

    lines = []
    for p in st["processes"]:
        role = "router " if p["router"] else "replica"
        lines.append(
            f"{role} {p['name']:<12} stanza {p['stanza']}  "
            f"clock {p['clock']:<4} offset {p['offset_s']:+.6f}s  "
            f"pairs d/a {p['pairs']['dispatch']}/{p['pairs']['ack']}")
    lines.append(f"{len(st['journeys'])} traced request(s)")
    for jn in sorted(st["journeys"].values(),
                     key=lambda j: -(j["e2e_ms"] or 0.0)):
        wf = request_waterfall(jn)
        if wf is None:
            continue
        parts = [f"{k[3:]} {wf[f'{k}_ms']:.0f}"
                 for k in COMPONENTS + ("rq_unexplained",)
                 if abs(wf[f"{k}_ms"]) >= 0.5]
        lines.append(
            f"  {jn['rid'] or jn['trace'][:8]:<8} "
            f"e2e {wf['e2e_ms']:8.1f} ms  "
            f"attempts {len(jn['attempts'])}  "
            f"[{', '.join(jn['sources'])}]  " + "  ".join(parts))
    return "\n".join(lines)


def stitch_main(paths, out: str | None = None,
                printer=print) -> int:
    """``--trace-stitch`` entry: stitch, write the Chrome trace, print
    the fit + per-request waterfall summary."""
    missing = [p for p in paths if not Path(p).exists()]
    if missing:
        printer(f"--trace-stitch: no such file(s): "
                f"{', '.join(missing)}")
        return 1
    st = stitch(paths)
    if out:
        Path(out).write_text(json.dumps(st["chrome"]))
        printer(f"wrote {out} "
                f"({len(st['chrome']['traceEvents'])} events — load "
                f"in Perfetto / chrome://tracing)")
    printer(format_stitch(st))
    return 0
