"""Fleet observability — N live processes, one view. Counterpart of
`shallowspeed_tpu/telemetry/fleet.py`, a copy of it on the port's own
`monitor`, `sketch` and `anomaly`.

Everything in `monitor.py` is per-process: one `Monitor`, one
`/status.json`, one metrics file. A serving fleet (the router and its
autoscaler, `serving/router.py`) and a gang of training processes
(`elastic --procs N --monitor-port`) both need the NEXT layer: merged
quantiles across replicas, fleet goodput and availability,
per-replica breakdown, SLO burn over the merged stream, and — the
scheduling-relevant signal — which replica is the straggler.
`FleetCollector` builds that from parts that already exist:

- **Replica sources.** Each replica is either a live endpoint (polled:
  ``/status.json`` for the summary view plus ``/sketches.json`` for
  the SERIALIZED mergeable sketches) or a metrics JSONL file (tailed
  through `monitor.FileTailer` into a per-replica `Monitor`,
  truncation/rotation-safe). Replicas can also self-register: the
  fleet's own endpoint accepts ``POST /register {"url", "name"}``
  (`serve --serve`'s ``--fleet-register``).
- **Merged quantiles.** Fleet p50/p95/p99 per metric are EXACT bucket
  unions of the replicas' latest cumulative sketches
  (`sketch.LogHistogram.merge` — exact counts, so the fleet quantile
  is provably within the recorded rel_err of the pooled offline
  reduction, the same contract `--goodput`'s monitor block pins
  per-process). Mixed-rel_err replicas reduce to the largest
  same-rel_err group, like the offline reducer.
- **Fleet SLOs.** The same declarative rules (`monitor.parse_slos`)
  evaluated over the merged stream: each refresh diffs every
  replica's sketch against its previous poll and feeds the DELTA
  bad/total counts (`LogHistogram.count_above` vs the rule threshold)
  into the dual-window burn evaluator — no raw values needed, the
  bucket boundary costs at most rel_err. Unreachable endpoint
  replicas feed the availability rule as downtime.
- **Straggler/skew detection.** Per refresh, each replica's quantile
  (p50 by default) of each watched metric (step_ms, ttft_ms) is
  scored against the median of its PEERS' quantiles (leave-one-out —
  a median that included the straggler itself would dilute the
  signal; with 2 replicas the self-inclusive ratio can never pass
  2x): the ratio stream runs through `anomaly.RobustEWMA` (a z-spike
  marks a replica that just CHANGED) and against an absolute
  divergence factor (a replica persistently ≥2x its peers is a
  straggler even after its own EWMA has normalized). Sustained
  divergence
  (`patience` consecutive rounds) emits a schema-v8 ``"straggler"``
  event naming the replica and dumps the flight ring; recovery emits
  the matching "resolved".
- **Exemplar linkage.** Each replica's monitor keeps the worst-K
  (ttft, request-id) pairs; the fleet view merges them with replica
  labels, so a burning ttft SLO resolves to "request r17 on replica
  b" in one hop — and `report.request_timeline` over that replica's
  JSONL reconstructs WHICH PHASE the time went to.

Serving surface: `FleetCollector.status()` / `.prometheus()` plug
into `monitor.StatusServer` unchanged (replica-labelled series, label
values escaped). Standalone:

    python -m shallowspeed_tpu_torch.telemetry --fleet \
        http://127.0.0.1:9100 http://127.0.0.1:9101   # endpoints
    python -m shallowspeed_tpu_torch.telemetry --fleet r0.jsonl r1.jsonl \
        --once                                        # files, one shot

Embedded: the elastic `GangSupervisor` grows one collector over all
children's per-member metrics files (`elastic.py`).

Pure stdlib, like `monitor` and `sketch` — a fleet collector runs on
any box that can reach the replicas.
"""

from __future__ import annotations

import json
import random
import statistics
import threading
import time
import urllib.request
from pathlib import Path

from shallowspeed_tpu_torch.telemetry.anomaly import RobustEWMA
from shallowspeed_tpu_torch.telemetry.monitor import (EXEMPLAR_K,
                                                      FileTailer,
                                                      FlightRecorder,
                                                      Monitor, parse_slos,
                                                      prom_escape,
                                                      prom_histogram_lines)
from shallowspeed_tpu_torch.telemetry.sketch import (LogHistogram,
                                                     MetricSketches)

# per-replica quantile metrics the straggler detector watches, and the
# quantile it scores (the median is robust to a replica's own tail)
STRAGGLER_METRICS = ("step_ms", "ttft_ms")
STRAGGLER_Q = 50


class Replica:
    """One fleet member: an endpoint to poll or a file to tail, plus
    the latest observed state the collector aggregates.

    Unreachable endpoints back off exponentially (seeded jitter)
    instead of re-GETting every refresh round: a dead replica used
    to cost every round a full connect-timeout, which is exactly when
    the fleet's own /status.json most needs the poll loop responsive.
    The backoff state is visible in the per-replica breakdown
    (`summary()["backoff"]`), downtime keeps feeding the availability
    rule on skipped rounds, and a successful poll (or a
    re-registration) resets the stream."""

    def __init__(self, name: str | None, url: str | None = None,
                 path=None, timeout: float = 5.0,
                 poll_backoff: float = 1.0,
                 poll_backoff_max: float = 30.0):
        assert (url is None) != (path is None), "exactly one source"
        self._label = name
        self.uid = -1            # stable collector-assigned index: the
        #                          internal key (display names can
        #                          collide — two fleets' metrics.jsonl)
        self.url = url.rstrip("/").removesuffix("/status.json") \
            if url else None
        self.path = str(path) if path is not None else None
        self.timeout = float(timeout)
        self.poll_backoff = float(poll_backoff)
        self.poll_backoff_max = float(poll_backoff_max)
        self.fail_streak = 0      # consecutive failed polls
        self.backoff_s = 0.0      # current backoff window (jittered)
        self.next_poll = 0.0      # wall before which refresh skips I/O
        self._rng = random.Random(url or str(path))
        self.alive = False
        self.last_seen: float | None = None
        self.error: str | None = None
        self._status: dict = {}
        self._profile: dict = {}    # latest profiler snapshot
        self._exemplars: dict = {}
        self._rel_err: float | None = None
        self._sketches: dict[str, LogHistogram] = {}
        self._mon: Monitor | None = None
        self._tailer: FileTailer | None = None
        if self.path is not None:
            # snapshot_every=0: the collector reads the live sketches
            # directly, re-emitting "monitor" lines would be noise
            self._mon = Monitor(flight=0, derive_steps=True,
                                snapshot_every=0)
            self._tailer = FileTailer(self.path, self)  # drained, not run

    @property
    def name(self) -> str:
        if self._label:
            return self._label
        if self.path is not None:
            return Path(self.path).stem
        return self.url or "?"

    def note_line(self, rec: dict) -> None:
        """FileTailer target: learn the replica label from the child's
        run_start stamp (--replica), forward everything to the
        per-replica Monitor."""
        if isinstance(rec, dict) and rec.get("event") == "run_start" \
                and isinstance(rec.get("replica"), str):
            self._label = self._label or rec["replica"]
        self._mon.note_line(rec)

    # ------------------------------------------------------------ poll

    def refresh(self, now: float) -> bool:
        """One observation round; returns liveness. File replicas are
        'alive' once the file has yielded any line; endpoint replicas
        are alive iff both GETs answered this round."""
        if self.path is not None:
            n = self._tailer.drain()
            # SNAPSHOT under the monitor's lock (sketch_payload), then
            # parse into private LogHistograms — status()/prometheus()
            # readers iterate these without a lock, so they must never
            # alias the live dicts the next drain mutates
            payload = self._mon.sketch_payload()
            self._sketches = {
                name: LogHistogram.from_dict(d)
                for name, d in payload["sketches"].items()}
            self._rel_err = float(payload["rel_err"])
            self._exemplars = payload["exemplars"]
            self._status = self._mon.status()
            # file-fed replicas: the latest tailed "profile" event
            # (cumulative snapshot — last wins) is this replica's
            # contribution to the fleet flamegraph
            self._profile = self._mon.last_profile or {}
            if n or self._mon.counters["lines"]:
                self.alive = True
                self.error = None
                if n:
                    self.last_seen = now
            return self.alive
        if self.fail_streak and now < self.next_poll:
            # backing off: no I/O this round (the replica stays "down"
            # and keeps burning availability; summary() shows why)
            return False
        try:
            self._status = self._get("/status.json")
            payload = self._get("/sketches.json")
        except Exception as e:
            self.alive = False
            self.error = f"{type(e).__name__}: {e}"
            self.fail_streak += 1
            base = min(self.poll_backoff * 2 ** (self.fail_streak - 1),
                       self.poll_backoff_max)
            self.backoff_s = base * (1.0 + 0.25 * self._rng.random())
            self.next_poll = now + self.backoff_s
            return False
        self.fail_streak = 0
        self.backoff_s = 0.0
        # /profile.json is best-effort and NEWER than the replicas'
        # required surface: an error here (404 JSON body on a replica
        # without it, a profiler-off run) must not mark the replica down
        try:
            prof = self._get("/profile.json")
            self._profile = prof if prof.get("enabled") else {}
        except Exception:
            self._profile = {}
        self._label = self._label or payload.get("label") \
            or self._status.get("replica")
        self._rel_err = float(payload.get("rel_err", 0.01))
        self._sketches = {
            name: LogHistogram.from_dict(d)
            for name, d in (payload.get("sketches") or {}).items()}
        self._exemplars = payload.get("exemplars") or {}
        self.alive = True
        self.last_seen = now
        self.error = None
        return True

    def _get(self, endpoint: str) -> dict:
        with urllib.request.urlopen(self.url + endpoint,
                                    timeout=self.timeout) as r:
            return json.loads(r.read())

    # ----------------------------------------------------------- views

    def sketch(self, name: str) -> LogHistogram | None:
        return self._sketches.get(name)

    def profile(self) -> dict:
        """This replica's latest profiler snapshot ({} = profiler off
        or pre-v12 replica) — the fleet flamegraph's input."""
        return {k: v for k, v in self._profile.items()
                if k not in ("event", "t", "wall", "mono", "enabled")}

    def serialized_sketches(self) -> dict:
        return {name: sk.to_dict()
                for name, sk in self._sketches.items() if sk.n}

    def summary(self) -> dict:
        """The per-replica block of the fleet /status.json."""
        st = self._status or {}
        out = {
            "source": self.url or self.path,
            "alive": self.alive,
            "last_seen": self.last_seen,
            "health": st.get("health"),
            "goodput_so_far": st.get("goodput_so_far"),
            "availability": st.get("availability"),
            "last_step": st.get("last_step"),
            "serving": st.get("serving"),
            "numerics": st.get("numerics"),
            "memory": st.get("memory"),
            "alerts": st.get("alerts") or [],
            "quantiles": {name: {"count": sk.n,
                                 "p50": sk.quantile(50),
                                 "p95": sk.quantile(95)}
                          for name, sk in sorted(self._sketches.items())
                          if sk.n},
        }
        if self.error:
            out["error"] = self.error
        if self.fail_streak:
            out["backoff"] = {"failures": self.fail_streak,
                              "backoff_s": round(self.backoff_s, 3),
                              "retry_at": round(self.next_poll, 3)}
        return out


class FleetCollector:
    """Aggregate N replicas into one live fleet view (module
    docstring). `status()`/`prometheus()` make it a drop-in
    `StatusServer` target; `refresh()` is one aggregation round
    (`start()`/`stop()` run it on a daemon thread for embedded use)."""

    def __init__(self, urls=(), paths=(), labels=None, slos: str = "",
                 straggler_metrics=STRAGGLER_METRICS,
                 straggler_q: int = STRAGGLER_Q,
                 straggler_factor: float = 2.0,
                 straggler_z: float = 6.0,
                 straggler_patience: int = 3,
                 straggler_min_count: int = 8,
                 flight: int = 0, flight_dir=None, emit=None,
                 log_file=None, clock=time.time, timeout: float = 5.0,
                 slo_kw: dict | None = None):
        self.clock = clock
        self.timeout = float(timeout)
        self._lock = threading.RLock()
        self.replicas: list[Replica] = []
        labels = list(labels) if labels else []
        for i, u in enumerate(urls):
            self.add_url(u, labels[i] if i < len(labels) else None)
        off = len(list(urls))
        for i, p in enumerate(paths):
            self.add_file(p, labels[off + i]
                          if off + i < len(labels) else None)
        self.rules = parse_slos(slos, **(slo_kw or {}))
        self.straggler_metrics = tuple(straggler_metrics)
        self.straggler_q = int(straggler_q)
        self.straggler_factor = float(straggler_factor)
        self.straggler_z = float(straggler_z)
        self.straggler_patience = int(straggler_patience)
        self.straggler_min_count = int(straggler_min_count)
        self.flight = (FlightRecorder(capacity=flight,
                                      out_dir=flight_dir)
                       if flight > 0 else None)
        self.emit = emit
        self.log_file = str(log_file) if log_file else None
        self.events: list[dict] = []     # every straggler/alert emitted
        # profiling-plane hooks — a firing straggler event
        # invokes each listener(rec) (ProfilerPlane.on_straggler arms
        # a capture window); a broken listener must not kill scoring
        self.straggler_listeners: list = []
        self.active_alerts: dict[str, dict] = {}
        self.stragglers: dict[tuple, dict] = {}
        self.counters = {"refreshes": 0, "stragglers": 0, "alerts": 0,
                         "flight_dumps": 0}
        self._ewma: dict[tuple, RobustEWMA] = {}
        self._runs: dict[tuple, int] = {}
        self._slo_prev: dict[tuple, tuple] = {}  # (spec, uid) -> (bad, tot)
        self._last_refresh: float | None = None
        # serializes replica polling only: two concurrent refresh()
        # calls (the embedded loop + a manual/HTTP-driven one) must
        # not drain the same tailer twice from one position — while
        # status()/prometheus() readers, who take only _lock, stay
        # responsive during a slow poll
        self._poll_lock = threading.Lock()
        self._halt = threading.Event()
        self._thread: threading.Thread | None = None

    # -------------------------------------------------------- members

    def add_url(self, url: str, label: str | None = None) -> Replica:
        with self._lock:
            rep = Replica(label, url=url, timeout=self.timeout)
            rep.uid = len(self.replicas)
            self.replicas.append(rep)
            return rep

    def add_file(self, path, label: str | None = None) -> Replica:
        with self._lock:
            rep = Replica(label, path=path)
            rep.uid = len(self.replicas)
            self.replicas.append(rep)
            return rep

    def _display_names(self) -> dict:
        """uid -> unique display name: a colliding name (two fleets'
        metrics.jsonl tailed without labels) gets '#uid' appended so
        the per-replica breakdown and prometheus labels stay
        one-row-per-replica; internal state is keyed by uid, never by
        the display name."""
        out, seen = {}, set()
        for rep in self.replicas:
            name = rep.name
            if name in seen:
                name = f"{name}#{rep.uid}"
            seen.add(name)
            out[rep.uid] = name
        return out

    def register_replica(self, payload: dict) -> dict:
        """POST /register body: {"url": status URL, "name": label}.
        Re-registration of a known URL refreshes its label instead of
        duplicating the replica (a restarted replica re-announces);
        re-registration of a known NAME at a new URL re-points that
        replica (a respawned process binds a fresh port — its history,
        straggler state and uid stay attached to the name). Either
        way the poller's backoff resets: a replica announcing itself
        is the strongest possible liveness signal."""
        url = payload.get("url")
        if not isinstance(url, str) or not url.startswith("http"):
            raise ValueError(f"register needs a status 'url', got "
                             f"{url!r}")
        name = payload.get("name")
        with self._lock:
            base = url.rstrip("/").removesuffix("/status.json")
            for rep in self.replicas:
                if rep.url == base or (name and rep.url is not None
                                       and rep._label == name):
                    rep._label = name or rep._label
                    rep.url = base
                    rep.fail_streak = 0
                    rep.backoff_s = 0.0
                    rep.next_poll = 0.0
                    return {"ok": True, "replicas": len(self.replicas)}
            self.add_url(url, name)
            return {"ok": True, "replicas": len(self.replicas)}

    def deregister_replica(self, payload: dict) -> dict:
        """POST /deregister body: {"url" and/or "name"} — removal on
        clean drain. Registration used to be one-way: a drained
        replica stayed in the fleet as "unreachable" and burned
        availability forever. Removes the replica AND purges its
        uid-keyed detector state (SLO deltas, straggler EWMAs) so a
        later replica re-using the name starts clean. Unknown
        replicas raise (the HTTP surface turns that into a 400)."""
        url = payload.get("url")
        name = payload.get("name")
        base = url.rstrip("/").removesuffix("/status.json") \
            if isinstance(url, str) else None
        with self._lock:
            for rep in self.replicas:
                if (base is not None and rep.url == base) \
                        or (name and rep.name == name):
                    self.replicas.remove(rep)
                    uid = rep.uid
                    self._slo_prev = {k: v for k, v
                                      in self._slo_prev.items()
                                      if k[1] != uid}
                    for d in (self._ewma, self._runs, self.stragglers):
                        for key in [k for k in d if k[0] == uid]:
                            del d[key]
                    return {"ok": True, "replicas": len(self.replicas),
                            "removed": rep.name}
            raise ValueError(
                f"deregister: no replica matches url={url!r} / "
                f"name={name!r}")

    # --------------------------------------------------------- refresh

    def refresh(self) -> dict:
        """One aggregation round: poll/drain every replica, evaluate
        fleet SLOs on the sketch deltas, score stragglers. Returns the
        fleet status payload. The blocking I/O (endpoint GETs can hang
        for `timeout` seconds on a dead replica) runs OUTSIDE the
        collector lock — the fleet's own /status.json must stay
        responsive exactly when a replica is down."""
        now = self.clock()
        with self._lock:
            dt = (now - self._last_refresh
                  if self._last_refresh is not None else None)
            self.counters["refreshes"] += 1
            reps = list(self.replicas)
        with self._poll_lock:
            polled = [(rep, rep.refresh(now)) for rep in reps]
        with self._lock:
            for rep, up in polled:
                if not up and rep.url is not None and dt:
                    # an unreachable endpoint is fleet downtime for
                    # the availability SLO
                    for rule in self.rules:
                        if rule.sketch is None:
                            rule.record_down(float(dt), now)
                if self.flight is not None:
                    self.flight.record(
                        {"event": "fleet_poll", "replica": rep.name,
                         "alive": up, "wall": round(now, 3),
                         "quantiles": rep.summary()["quantiles"]})
            self._feed_slos(now)
            self._score_stragglers(now)
            for rule in self.rules:
                rec = rule.evaluate(now)
                if rec is None:
                    continue
                self.counters["alerts"] += 1
                if rec["state"] == "firing":
                    self.active_alerts[rule.spec] = rec
                    self._flight_dump(f"slo:{rule.spec}", rec)
                else:
                    self.active_alerts.pop(rule.spec, None)
                self._emit("alert", rec, now)
            self._last_refresh = now
            return self._status_locked(now)

    def _feed_slos(self, now: float) -> None:
        """Quantile rules over the merged stream: per replica, diff
        the cumulative (bad, total) counts against the rule threshold
        since the last poll and feed the deltas. A shrunk total means
        the replica restarted — re-baseline, don't feed."""
        for rule in self.rules:
            if rule.sketch is None:
                continue
            bad_d = tot_d = 0
            for rep in self.replicas:
                sk = rep.sketch(rule.sketch)
                if sk is None or not sk.n:
                    continue
                above = sk.count_above(rule.threshold)
                bad = above if rule.op == "<" else sk.n - above
                key = (rule.spec, rep.uid)
                pb, pt = self._slo_prev.get(key, (0, 0))
                if sk.n < pt:
                    pb, pt = 0, 0
                bad_d += max(0, bad - pb)
                tot_d += sk.n - pt
                self._slo_prev[key] = (bad, sk.n)
            if tot_d > 0:
                rule.record_counts(bad_d, tot_d, now)

    def _score_stragglers(self, now: float) -> None:
        names = self._display_names()
        for metric in self.straggler_metrics:
            vals = {}
            for rep in self.replicas:
                sk = rep.sketch(metric)
                if sk is not None and sk.n >= self.straggler_min_count:
                    vals[rep.uid] = sk.quantile(self.straggler_q)
            if len(vals) < 2:
                continue
            for uid, v in vals.items():
                # leave-one-out: score against the median of the
                # PEERS — a fleet median that includes the straggler
                # itself dilutes the signal (with 2 replicas the
                # self-inclusive ratio can never exceed 2.0 however
                # bad the skew)
                med = statistics.median(
                    [x for u, x in vals.items() if u != uid])
                if med <= 0:
                    continue
                name = names[uid]
                key = (uid, metric)
                ratio = v / med
                ew = self._ewma.setdefault(
                    key, RobustEWMA(alpha=0.3,
                                    warmup=self.straggler_patience))
                z = ew.update(ratio)
                # two detectors: the absolute factor catches a replica
                # persistently far off the fleet (its OWN EWMA baseline
                # normalizes to the slow level, so z alone would go
                # quiet); the robust z catches a replica that just
                # CHANGED relative to its history
                diverged = (ratio >= self.straggler_factor
                            or (z is not None and z > self.straggler_z))
                if diverged:
                    self._runs[key] = self._runs.get(key, 0) + 1
                    if self._runs[key] >= self.straggler_patience \
                            and key not in self.stragglers:
                        rec = {"replica": name, "metric": metric,
                               "state": "firing",
                               "ratio": round(ratio, 3),
                               "q": self.straggler_q,
                               "replica_q": round(v, 3),
                               "fleet_q": round(med, 3),
                               "rounds": self._runs[key]}
                        if z is not None:
                            rec["z"] = round(z, 2)
                        self.stragglers[key] = rec
                        self.counters["stragglers"] += 1
                        self._emit("straggler", rec, now)
                        self._flight_dump(
                            f"straggler:{name}:{metric}", rec)
                        for listener in self.straggler_listeners:
                            try:
                                listener({"event": "straggler", **rec})
                            except Exception:
                                pass
                else:
                    self._runs[key] = 0
                    if key in self.stragglers:
                        self.stragglers.pop(key)
                        self._emit("straggler",
                                   {"replica": name, "metric": metric,
                                    "state": "resolved",
                                    "ratio": round(ratio, 3),
                                    "q": self.straggler_q}, now)

    def _emit(self, event: str, rec: dict, now: float) -> None:
        rec = {"event": event, **rec}
        rec.setdefault("wall", round(now, 3))
        self.events.append(rec)
        if self.log_file:
            try:
                with open(self.log_file, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass
        if self.emit is not None:
            try:
                self.emit(**rec)
            except Exception:
                pass  # a broken sink must not kill the collector

    def _flight_dump(self, reason: str, trigger) -> None:
        if self.flight is None:
            return
        if self.flight.dump(reason, trigger=trigger) is not None:
            self.counters["flight_dumps"] += 1

    # ---------------------------------------------------------- views

    def _merged(self) -> tuple[MetricSketches, float, int]:
        """(merged sketches, rel_err, skipped): exact bucket union of
        every replica's latest cumulative sketches; mixed-rel_err
        replicas reduce to the largest same-rel_err group (the
        goodput monitor-block convention)."""
        by_err: dict[float, list[Replica]] = {}
        for rep in self.replicas:
            if rep._rel_err is not None and rep._sketches:
                by_err.setdefault(rep._rel_err, []).append(rep)
        if not by_err:
            return MetricSketches(), 0.01, 0
        rel_err, group = max(by_err.items(), key=lambda kv: len(kv[1]))
        merged = MetricSketches(rel_err=rel_err)
        for rep in group:
            merged.merge_dict(rep.serialized_sketches())
        skipped = sum(len(v) for v in by_err.values()) - len(group)
        return merged, rel_err, skipped

    def worst(self, metric: str = "ttft_ms", k: int = EXEMPLAR_K) -> list:
        """The fleet's worst-`metric` exemplars, replica-labelled: the
        one-hop answer to 'WHICH request is burning the SLO, where'."""
        names = self._display_names()
        out = []
        for rep in self.replicas:
            for ex in rep._exemplars.get(metric, []):
                if isinstance(ex, dict) and "value" in ex:
                    out.append({"replica": names[rep.uid],
                                "id": ex.get("id"),
                                metric: ex["value"]})
        out.sort(key=lambda e: -e[metric])
        return out[:k]

    def status(self) -> dict:
        with self._lock:
            return self._status_locked(self.clock())

    def profile_payload(self) -> dict:
        """The fleet flamegraph: every profiling replica's
        folded stacks merged replica-prefixed (one flamegraph whose
        first level is the replica) — duck-typed onto StatusServer as
        the fleet's /profile.json, same as a single Monitor's."""
        from shallowspeed_tpu_torch.telemetry.profiler import merge_profiles

        with self._lock:
            names = self._display_names()
            snaps = {names[r.uid]: prof for r in self.replicas
                     if (prof := r.profile())}
        if not snaps:
            return {"enabled": False}
        return {"enabled": True, **merge_profiles(snaps)}

    def _status_locked(self, now: float) -> dict:
        names = self._display_names()
        merged, rel_err, skipped = self._merged()
        goodputs = [r._status.get("goodput_so_far")
                    for r in self.replicas
                    if isinstance(r._status.get("goodput_so_far"),
                                  (int, float))]
        avails = [r._status.get("availability") for r in self.replicas
                  if isinstance(r._status.get("availability"),
                                (int, float))]
        out = {
            "wall": round(now, 3),
            "fleet": {
                "replicas": len(self.replicas),
                "alive": sum(1 for r in self.replicas if r.alive),
                "sketches": merged.summary(),
                "rel_err": rel_err,
                "goodput_so_far": (round(sum(goodputs) / len(goodputs),
                                         4) if goodputs else None),
                "availability": (round(sum(avails) / len(avails), 4)
                                 if avails else None),
            },
            "replicas": {names[r.uid]: r.summary()
                         for r in self.replicas},
            "slo": [r.status(now) for r in self.rules],
            "alerts": sorted(self.active_alerts.values(),
                             key=lambda a: a.get("slo", "")),
            "stragglers": sorted(self.stragglers.values(),
                                 key=lambda s: (s["replica"],
                                                s["metric"])),
            "worst_ttft": self.worst("ttft_ms"),
            # the fleet's slowest finished request WITH its latency
            # decomposition: the worst per-replica
            # slowest_request, replica-labelled — "which request,
            # which replica, which component" in one read
            "slowest_request": self._slowest_request(names),
            "counters": dict(self.counters),
        }
        profiling = self._profiling_locked(names)
        if profiling:
            out["profiling"] = profiling
        numerics = self._numerics_locked(names)
        if numerics:
            out["numerics"] = numerics
        memory = self._memory_locked(names)
        if memory:
            out["memory"] = memory
        if skipped:
            out["fleet"]["skipped_mixed_rel_err"] = skipped
        if self.flight is not None:
            out["flight_dumps"] = list(self.flight.dumps)
        return out

    def _profiling_locked(self, names: dict) -> dict | None:
        """The status-view digest of the fleet's profiling plane:
        per-replica sample counts + the hottest frame, so "where is
        host time going, per replica" is one /status.json read (the
        full merged flamegraph lives on /profile.json)."""
        per = {}
        for rep in self.replicas:
            prof = rep.profile()
            if not prof:
                continue
            folded = prof.get("folded") or {}
            top = max(folded.items(), key=lambda kv: kv[1])[0] \
                if folded else None
            ent = {"samples": int(prof.get("samples") or 0)}
            phases = prof.get("phases") or {}
            if phases:
                ent["top_phase"] = max(phases.items(),
                                       key=lambda kv: kv[1])[0]
            if top is not None:
                # the leaf frame is the "where": the full stack is on
                # /profile.json, the status view wants one token
                ent["top_frame"] = top.rsplit(";", 1)[-1]
            per[names[rep.uid]] = ent
        return {"replicas": per} if per else None

    def _numerics_locked(self, names: dict) -> dict | None:
        """The fleet's numerics digest: worst shadow-parity
        rel-err and overflow fraction across replicas (named, so the
        bad replica is one read away) plus the roster of replicas the
        guard already dropped to bf16 — "is the fp8 rollout healthy
        fleet-wide" without opening N status pages."""
        per = {}
        for rep in self.replicas:
            num = (rep._status or {}).get("numerics")
            if isinstance(num, dict) and num:
                per[names[rep.uid]] = num
        if not per:
            return None

        def worst(field):
            best = None
            for name, num in per.items():
                v = num.get(field)
                if isinstance(v, (int, float)) \
                        and not isinstance(v, bool) \
                        and (best is None or v > best[1]):
                    best = (name, v)
            return ({"replica": best[0], "value": best[1]}
                    if best else None)

        return {
            "replicas": per,
            "worst_parity_loss_rel": worst("num_parity_loss_rel"),
            "worst_overflow": worst("num_overflow_max"),
            "fell_back_bf16": sorted(
                name for name, num in per.items()
                if num.get("num_precision") == "bf16"),
        }

    def _memory_locked(self, names: dict) -> dict | None:
        """The fleet's memory digest: worst — MINIMUM —
        admission headroom across replicas (named, so the near-OOM
        replica is one read away; the router's placement scoring reads
        the same per-replica serving views), per-replica memory
        observatory snapshots, and the roster of replicas that have
        already recovered a block-exhaustion event."""
        per = {}
        heads = {}
        for rep in self.replicas:
            st = rep._status or {}
            mem = st.get("memory")
            if isinstance(mem, dict) and mem:
                per[names[rep.uid]] = mem
            sv = st.get("serving")
            if isinstance(sv, dict):
                hb = sv.get("headroom_blocks")
                if isinstance(hb, (int, float)) \
                        and not isinstance(hb, bool):
                    heads[names[rep.uid]] = hb
        if not per and not heads:
            return None
        out: dict = {}
        if per:
            out["replicas"] = per
        if heads:
            worst = min(heads.items(), key=lambda kv: kv[1])
            out["headroom_blocks"] = heads
            out["worst_headroom"] = {"replica": worst[0],
                                     "value": worst[1]}
        oomed = sorted(name for name, mem in per.items()
                       if mem.get("last_oom"))
        if oomed:
            out["oom_recovered"] = oomed
        return out

    def _slowest_request(self, names: dict) -> dict | None:
        worst = None
        for rep in self.replicas:
            sr = (rep._status or {}).get("slowest_request")
            if isinstance(sr, dict) \
                    and isinstance(sr.get("e2e_ms"), (int, float)) \
                    and (worst is None
                         or sr["e2e_ms"] > worst["e2e_ms"]):
                worst = {**sr, "replica": names[rep.uid]}
        return worst

    def prometheus(self) -> str:
        """Replica-labelled Prometheus exposition — label values go
        through `prom_escape` (replica names are operator input)."""
        with self._lock:
            names = self._display_names()
            P = "shallowspeed_fleet_"
            lines = [f"# TYPE {P}replicas gauge",
                     f"{P}replicas {len(self.replicas)}",
                     f"# TYPE {P}up gauge"]
            for rep in self.replicas:
                lbl = f'replica="{prom_escape(names[rep.uid])}"'
                lines.append(f"{P}up{{{lbl}}} {1 if rep.alive else 0}")
            per_metric: dict[str, list] = {}
            for rep in self.replicas:
                lbl = prom_escape(names[rep.uid])
                for name, sk in sorted(rep._sketches.items()):
                    if not sk.n:
                        continue
                    per_metric.setdefault(name, []).append((lbl, sk))
            import re as _re

            for name, entries in sorted(per_metric.items()):
                base = "shallowspeed_" + _re.sub(r"[^a-zA-Z0-9_]", "_",
                                                 name)
                lines.append(f"# TYPE {base} summary")
                for lbl, sk in entries:
                    for q in (0.5, 0.95, 0.99):
                        v = sk.quantile(q * 100)
                        lines.append(f'{base}{{replica="{lbl}",'
                                     f'quantile="{q}"}} {v:.6g}')
                    lines.append(f'{base}_sum{{replica="{lbl}"}} '
                                 f'{sk.total:.6g}')
                    lines.append(f'{base}_count{{replica="{lbl}"}} '
                                 f'{sk.n}')
                # native histograms on the SHARED le ladder:
                # per-replica cumulative buckets sum — the form
                # in which Prometheus fleet quantiles are correct
                for j, (lbl, sk) in enumerate(entries):
                    lines.extend(prom_histogram_lines(
                        base, sk, label=f'replica="{lbl}",',
                        type_line=(j == 0)))
            lines.append(f"# TYPE {P}straggler gauge")
            for _key, rec in sorted(self.stragglers.items()):
                lines.append(
                    f'{P}straggler{{'
                    f'replica="{prom_escape(rec["replica"])}",'
                    f'metric="{prom_escape(rec["metric"])}"}} 1')
            if not self.stragglers:
                lines.append(f"{P}straggler 0")
            lines.append(f"# TYPE {P}alerts_firing gauge")
            lines.append(f"{P}alerts_firing {len(self.active_alerts)}")
            return "\n".join(lines) + "\n"

    # ------------------------------------------------- embedded loop

    def start(self, poll: float = 2.0) -> None:
        """Refresh on a daemon thread every `poll` seconds (the
        embedded mode — GangSupervisor)."""
        if self._thread is not None:
            return
        self._halt.clear()

        def _loop():
            while not self._halt.is_set():
                try:
                    self.refresh()
                except Exception:
                    pass  # a flaky replica must not kill the collector
                self._halt.wait(poll)

        self._thread = threading.Thread(target=_loop,
                                        name="fleet-collector",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._halt.set()
        self._thread.join(timeout=5)
        self._thread = None


# ----------------------------------------------------------- CLI view


def format_fleet_status(status: dict) -> str:
    """Human-readable rendering of one fleet status payload (the
    --fleet terminal view)."""
    fl = status.get("fleet") or {}
    lines = [f"fleet: {fl.get('alive', 0)}/{fl.get('replicas', 0)} "
             f"replicas alive"
             + (f"  goodput {fl['goodput_so_far']:.1%}"
                if fl.get("goodput_so_far") is not None else "")
             + (f"  availability {fl['availability']:.1%}"
                if fl.get("availability") is not None else "")]
    for name, sk in (fl.get("sketches") or {}).items():
        lines.append(
            f"  {name:<12} n={sk['count']:<7} p50 {sk.get('p50')}  "
            f"p95 {sk.get('p95')}  p99 {sk.get('p99')}")
    for name, rep in sorted((status.get("replicas") or {}).items()):
        state = "up" if rep.get("alive") else "DOWN"
        bits = [f"  [{name}] {state}"]
        ls = rep.get("last_step") or {}
        if ls.get("step") is not None:
            bits.append(f"step {ls['step']}")
        for metric in ("step_ms", "ttft_ms"):
            q = (rep.get("quantiles") or {}).get(metric)
            if q:
                bits.append(f"{metric} p50 {q['p50']}")
        num = rep.get("numerics") or {}
        if num.get("num_precision"):
            bits.append(f"precision {num['num_precision']}")
            if num.get("num_parity_loss_rel") is not None:
                bits.append(
                    f"parity {num['num_parity_loss_rel']:.3g}")
            if num.get("last_verdicts"):
                bits.append(
                    f"NUMERICS {','.join(num['last_verdicts'])}")
        if rep.get("error"):
            bits.append(f"error {rep['error']}")
        lines.append("  ".join(bits))
    for s in status.get("slo") or []:
        lines.append(f"  slo {s['slo']:<24} {s['state']:<8} "
                     f"burn fast/slow {s['burn_fast']}/{s['burn_slow']}")
    for a in status.get("alerts") or []:
        lines.append(f"  ALERT {a.get('severity', '?').upper()} "
                     f"{a.get('slo')}")
    for s in status.get("stragglers") or []:
        lines.append(f"  STRAGGLER {s['replica']} {s['metric']} "
                     f"p{s.get('q', STRAGGLER_Q)} {s.get('replica_q')} "
                     f"vs fleet {s.get('fleet_q')} "
                     f"({s.get('ratio')}x)")
    for e in status.get("worst_ttft") or []:
        lines.append(f"  worst ttft: {e['ttft_ms']} ms  "
                     f"request {e.get('id')} @ {e['replica']}")
    num = status.get("numerics")
    if num:
        wp = num.get("worst_parity_loss_rel")
        wo = num.get("worst_overflow")
        bits = [f"numerics: {len(num.get('replicas') or {})} fp8 "
                f"replica(s)"]
        if wp:
            bits.append(f"worst parity {wp['value']:.3g} "
                        f"@ {wp['replica']}")
        if wo:
            bits.append(f"worst overflow {wo['value']:.3g} "
                        f"@ {wo['replica']}")
        lines.append("  " + "  ".join(bits))
        if num.get("fell_back_bf16"):
            lines.append(f"  FELL BACK to bf16: "
                         f"{', '.join(num['fell_back_bf16'])}")
    mem = status.get("memory")
    if mem:
        wh = mem.get("worst_headroom")
        bits = ["memory:"]
        if wh:
            bits.append(f"worst headroom {wh['value']} blocks "
                        f"@ {wh['replica']}")
        if mem.get("oom_recovered"):
            bits.append(f"OOM recovered: "
                        f"{', '.join(mem['oom_recovered'])}")
        if len(bits) > 1:
            lines.append("  " + "  ".join(bits))
    return "\n".join(lines)


def fleet_main(targets, slos: str = "", once: bool = False,
               interval: float = 2.0, port: int | None = None,
               out=print, max_secs=None, log_file=None) -> int:
    """``python -m shallowspeed_tpu_torch.telemetry --fleet t1 t2 ...``:
    aggregate N replicas (http(s):// targets are polled endpoints,
    anything else is a metrics JSONL path) and render the fleet view;
    with --port also serve the fleet /status.json + /metrics. `once`
    renders one refresh and exits (the pre-commit smoke)."""
    urls = [t for t in targets if t.startswith(("http://", "https://"))]
    paths = [t for t in targets if not t.startswith(("http://",
                                                     "https://"))]
    missing = [p for p in paths if not Path(p).exists()]
    if missing and once:
        out(f"--fleet: no such file(s): {', '.join(missing)}")
        return 1
    fc = FleetCollector(urls=urls, paths=paths, slos=slos,
                        log_file=log_file)
    srv = None
    if port is not None:
        from shallowspeed_tpu_torch.telemetry.monitor import StatusServer

        srv = StatusServer(fc, port=port)
        out(f"fleet endpoint: {srv.url('/status.json')} (+ /metrics)")
    t0 = time.time()
    try:
        while True:
            # Ctrl-C most likely lands inside refresh() (an
            # unreachable replica blocks up to its timeout) — the
            # documented clean exit must cover the poll, not just the
            # sleep
            try:
                st = fc.refresh()
                out(f"== fleet @ {time.strftime('%H:%M:%S')} "
                    f"({st['counters']['refreshes']} refresh(es))")
                out(format_fleet_status(st))
                if once or (max_secs is not None
                            and time.time() - t0 >= max_secs):
                    return 0
                time.sleep(interval)
            except KeyboardInterrupt:
                return 0
    finally:
        if srv is not None:
            srv.close()
