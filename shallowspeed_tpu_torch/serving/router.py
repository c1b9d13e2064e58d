"""Fault-tolerant fleet front-end: SLO-aware routing over N serving
replicas, with replica failure invisible to clients. Counterpart of
`shallowspeed_tpu/serving/router.py`, a copy of it over the port's
`ServingEngine`, `elastic`, `cache`, `monitor` and `tracing`.

One `ServingEngine` serves a stream; a fleet of them needs three
things: something that *routes* requests, something that survives a
replica dying mid-decode, and something that closes the scale-up/down
loop. This module is all three, built from parts that already exist —
the FleetCollector (`telemetry/fleet.py`) is the observation surface,
`monitor.SloRule` the dual-window burn signal, `elastic.RestartPolicy`
the classified-backoff respawn machinery, and the engine's
evict-newest continuation the failover mechanism:

- **SLO-aware dispatch.** Admission is weighted by each replica's
  polled ``/status.json`` — queue depth, active slots, free blocks,
  ttft p50 — read from the FleetCollector's per-replica summaries
  (the router CONSUMES the collector, it does not re-poll), plus the
  router's own in-flight count per replica. Lowest score wins;
  deterministic tie-break by name.
- **Request resilience.** Every request carries an optional deadline
  (absolute e2e cap — typed failure past it) and a progress timeout
  (no new tokens for `request_timeout` seconds → failover). On
  replica death or timeout the request is **re-dispatched seeded and
  idempotent**: the prompt plus every token already received
  re-prefills on a fresh replica (`ServingEngine.submit(generated=)`)
  and sampling continues at token index len(generated) — because
  token i of seed s always draws from a generator seeded from (s, i)
  (`models.generate.sample_rows`), the continued stream is the solo
  engine's stream, the same mechanism as the engine's evict-newest
  requeue, now across process boundaries. Each re-dispatch stamps a
  schema-v10 ``"failover"`` event.
- **Circuit breakers + fleet-edge backpressure.** One breaker per
  replica: consecutive call failures trip it open (replica death
  force-opens it), it cools down with seeded jitter (doubling up to a
  cap), then allows jittered **half-open probes** — the progress poll
  doubles as the probe, so a recovered replica is re-admitted by the
  first successful poll and traffic returns only to ``closed``
  breakers. When every breaker is open (or every replica is down or
  draining) or the router queue exceeds its budget, `submit()` raises
  the typed `FleetOverloaded` carrying ``retry_after`` — backpressure
  at the fleet edge instead of silent queue growth.
- **Replica lifecycle.** Replicas are spawned by a caller-provided
  factory (subprocess `serve --serve` handles in production,
  in-process engines for drills and tests). Failures are classified
  with elastic.py's taxonomy (crash / hang via stale heartbeat /
  numeric via heartbeat status / clean) and respawned on
  `elastic.RestartPolicy`'s per-class jittered backoff; every
  detection→ready interval stamps a ``restart_downtime`` ledger line
  with its class AND replica, which `--goodput` reduces to
  per-replica MTTR and fleet availability. Scale-down is a graceful
  drain: stop dispatching, `drain()` the replica (it finishes
  in-flight work), then deregister it from the collector — zero
  dropped requests.
- **Burn-driven autoscaling.** The router feeds its OWN observed
  ttft (submit → first token, fleet-edge — routing and failover
  delays included, which is the number users feel) into
  `monitor.SloRule`'s dual-window evaluator; a critical burn
  sustained for `scale_hold_s` spawns a replica (schema-v10
  ``"scale"`` event), a fleet idle for `idle_drain_s` drains one,
  bounded by [min_replicas, max_replicas] with a cool-down between
  decisions.

Everything the router decides lands in its metrics JSONL: ``"route"``
per dispatch, ``"failover"`` per re-dispatch, ``"scale"`` per
autoscale decision, breaker transitions as ``"ledger"`` lines
(kind="breaker", state=open/half_open/closed), restart downtime with
replica + fail_class, and a fleet-edge ``"request"`` record per
completion — so ``python -m shallowspeed_tpu_torch.telemetry --goodput``
reduces a router log to request percentiles, per-replica MTTR, and
fleet availability in one pass (the ``fleet`` block).

`shallowspeed_tpu_torch/router.py` is the CLI driver (subprocess
replicas, each `python -m shallowspeed_tpu_torch.serve --serve` on an
explicit `--device`; per-replica chaos plans for drills).
"""

from __future__ import annotations

import http.client
import json
import os
import random
import signal
import subprocess
import time
import urllib.request
from collections import deque

import numpy as np

from shallowspeed_tpu_torch.elastic import (RestartPolicy, classify_exit,
                                            read_heartbeat_status,
                                            write_heartbeat)
from shallowspeed_tpu_torch.telemetry.monitor import parse_slos
from shallowspeed_tpu_torch.telemetry.tracing import (new_span_id,
                                                      new_trace_id)


class FleetOverloaded(RuntimeError):
    """Fleet-edge backpressure: `Router.submit` rejects because every
    breaker is open / every replica is down or draining, or the
    router's pending queue exceeds its budget. `retry_after` is the
    caller's hint (seconds) — the earliest breaker reopen / respawn,
    or one poll interval for queue pressure."""

    def __init__(self, msg: str, retry_after: float):
        super().__init__(f"{msg} (retry after ~{retry_after:.1f}s)")
        self.retry_after = float(retry_after)


class CircuitBreaker:
    """Per-replica circuit breaker: closed → (threshold consecutive
    failures, or a force-open on observed death) → open for a
    jittered, doubling cooldown → half-open admitting ONE probe →
    closed on probe success / re-open on probe failure. Transitions
    invoke `on_transition(state, now)` so the router can stamp them."""

    def __init__(self, threshold: int = 3, cooldown: float = 1.0,
                 cooldown_max: float = 30.0, jitter: float = 0.25,
                 seed: int = 0, on_transition=None):
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.cooldown_max = float(cooldown_max)
        self.jitter = float(jitter)
        self.on_transition = on_transition
        self._rng = random.Random(seed)
        self.state = "closed"
        self.failures = 0
        self.trips = 0
        self._cool = self.cooldown
        self._open_until = 0.0
        self._probe_out = False

    def _set(self, state: str, now: float) -> None:
        if state == self.state:
            return
        self.state = state
        if self.on_transition is not None:
            self.on_transition(state, now)

    def _open(self, now: float) -> None:
        # jittered cooldown, doubling per consecutive trip: a fleet of
        # routers probing one recovering replica must not thunder
        delay = self._cool * (1.0 + self.jitter * self._rng.random())
        self._cool = min(self._cool * 2.0, self.cooldown_max)
        self._open_until = now + delay
        self._probe_out = False
        self.trips += 1
        self._set("open", now)

    def force_open(self, now: float) -> None:
        """Observed replica death: no need to wait for the failure
        count — stop routing there until a probe succeeds."""
        self.failures = 0
        self._open(now)

    def allow(self, now: float) -> bool:
        """May a call go to this replica now? Open→half-open happens
        here (cooldown elapsed); half-open admits one probe at a
        time. The PROGRESS POLL is the probe in practice — dispatch
        itself waits for `closed`."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now < self._open_until:
                return False
            self._set("half_open", now)
        if self._probe_out:
            return False
        self._probe_out = True
        return True

    def note_success(self, now: float) -> None:
        self.failures = 0
        if self.state == "half_open":
            self._cool = self.cooldown
            self._probe_out = False
            self._set("closed", now)

    def note_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half_open" \
                or (self.state == "closed"
                    and self.failures >= self.threshold):
            self.failures = 0
            self._open(now)

    def retry_after(self, now: float) -> float:
        return max(0.0, self._open_until - now)


# ------------------------------------------------- replica-side gateway


def _submit_typed(engine, payload: dict) -> dict:
    """Translate one `ServingEngine.submit` into the typed dict reply
    the router understands ({"ok"} / {"ok": False, "error",
    ["retry_after"]}). Shared by the HTTP gateway and the in-process
    handle — the in-process canary stays faithful to the wire shape
    because both speak through this one function."""
    from shallowspeed_tpu_torch.serving.engine import EngineDraining

    rid = str(payload.get("id"))
    try:
        att = payload.get("attempt")
        engine.submit(np.asarray(payload["prompt"], np.int32),
                      int(payload["max_new"]),
                      temperature=float(payload.get("temperature",
                                                    0.0)),
                      seed=int(payload.get("seed", 0)), rid=rid,
                      generated=payload.get("generated") or (),
                      # schema v11 trace context: minted by the
                      # router, riding the POST /submit body — a
                      # failover re-dispatch carries the SAME trace
                      # with an incremented attempt
                      trace=payload.get("trace"),
                      parent=payload.get("parent"),
                      attempt=int(att) if isinstance(att, int)
                      and not isinstance(att, bool) else 0)
    except EngineDraining:
        return {"ok": False, "error": "EngineDraining",
                "retry_after": 1.0}
    except (KeyError, TypeError, ValueError) as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    return {"ok": True, "id": rid}


def _snapshot_requests(engine, rids) -> dict[str, dict]:
    """Per-request {"status", "tokens"} snapshots out of the engine —
    the one shape `Router._fold_progress` consumes, shared by the
    gateway's publish and the in-process handle's progress."""
    out = {}
    for rid in rids:
        if rid in engine.results:
            out[rid] = {"status": "done",
                        "tokens": [int(t) for t
                                   in engine.results[rid]]}
        else:
            try:
                p = engine.poll(rid)
                out[rid] = {"status": p["status"],
                            "tokens": [int(t) for t
                                       in p["tokens"]]}
            except KeyError:
                continue      # still in an inbox, or rejected
    return out


class RequestGateway:
    """The replica-side ingestion surface: a thread-safe inbox the
    serve loop pumps into its `ServingEngine`, plus published
    per-request snapshots the router polls. Grafted onto the replica's
    monitor endpoint by `StatusServer(extra=...)`:

    - ``POST /submit``  -> `submit_request(payload)`: queue one request
      ({"id", "prompt": [ids], "max_new", "temperature", "seed",
      "generated": [resume prefix]}); typed dict rejections
      ({"ok": False, "error": "EngineDraining"|"EngineOverloaded",
      "retry_after": s}) instead of silent queue growth.
    - ``GET /requests`` -> `poll_requests()`: every known request's
      {"status": queued|running|done|rejected, "tokens": so-far}.
    - ``POST /drain``   -> `drain_request(...)`: graceful drain — the
      serve loop stops admission (`engine.drain()`), finishes
      in-flight work, deregisters, and exits 0.

    HTTP handler threads only touch the inbox and the published
    snapshots under the lock; `pump()`/`publish()` run on the engine's
    own thread — the engine itself is never shared across threads.

    Terminal (done/rejected) snapshots are retained up to
    `done_cap` and then evicted FIFO — a long-lived replica must not
    grow one full token list per request it ever served, and the
    router re-reads a result within a poll interval of completion, so
    thousands of retained terminals are already generous."""

    def __init__(self, max_queue: int = 256, done_cap: int = 4096,
                 clock=time.time):
        import threading

        self.max_queue = int(max_queue)
        self.done_cap = int(done_cap)
        self.clock = clock
        self._lock = threading.Lock()
        self._inbox: deque = deque()
        self._known: list[str] = []
        self.published: dict[str, dict] = {}
        self.drain_requested = False

    # ---- HTTP-thread side (duck-typed into StatusServer) -----------

    def submit_request(self, payload: dict) -> dict:
        rid = str(payload.get("id"))
        with self._lock:
            if self.drain_requested:
                return {"ok": False, "error": "EngineDraining",
                        "retry_after": 1.0}
            if rid in self.published and \
                    self.published[rid]["status"] != "rejected":
                return {"ok": False,
                        "error": f"ValueError: duplicate id {rid!r}"}
            # inbox entries are already published as "queued", so the
            # published states alone are the backlog
            backlog = sum(1 for p in self.published.values()
                          if p["status"] in ("queued", "running"))
            if backlog >= self.max_queue:
                return {"ok": False, "error": "EngineOverloaded",
                        "retry_after": 0.5}
            self._inbox.append(dict(payload))
            self._known.append(rid)
            self.published[rid] = {"status": "queued", "tokens": []}
        return {"ok": True, "id": rid}

    def poll_requests(self, payload: dict | None = None) -> dict:
        with self._lock:
            return {"requests": {rid: dict(rec) for rid, rec
                                 in self.published.items()},
                    "draining": self.drain_requested}

    def drain_request(self, payload: dict | None = None) -> dict:
        with self._lock:
            self.drain_requested = True
            backlog = sum(1 for p in self.published.values()
                          if p["status"] in ("queued", "running"))
        return {"draining": True, "pending": backlog}

    def idle(self) -> bool:
        with self._lock:
            return not self._inbox

    # ---- engine-thread side ----------------------------------------

    def pump(self, engine) -> int:
        """Move inbox submissions into the engine (engine thread
        only). Bad requests publish as `rejected` with the error —
        one malformed request must not kill the replica."""
        n = 0
        while True:
            with self._lock:
                if not self._inbox:
                    return n
                payload = self._inbox.popleft()
            resp = _submit_typed(engine, payload)
            if resp.get("ok"):
                n += 1
            else:
                with self._lock:
                    self.published[str(payload.get("id"))] = {
                        "status": "rejected",
                        "error": resp["error"], "tokens": []}

    def publish(self, engine) -> None:
        """Snapshot every known NON-terminal request's state out of
        the engine (engine thread only) for the HTTP pollers; evict
        the oldest terminal snapshots beyond `done_cap`."""
        with self._lock:
            terminal = {rid for rid, rec in self.published.items()
                        if rec["status"] in ("done", "rejected")}
            known = [rid for rid in self._known
                     if rid not in terminal]
            self._known = known     # terminals never re-snapshot
        snap = _snapshot_requests(engine, known)
        with self._lock:
            for rid, rec in snap.items():
                self.published[rid] = rec
            fin = [rid for rid, rec in self.published.items()
                   if rec["status"] in ("done", "rejected")]
            for rid in fin[:max(0, len(fin) - self.done_cap)]:
                del self.published[rid]


# ------------------------------------------------------ replica handles


class InProcessReplica:
    """In-process replica handle: a real `ServingEngine` behind the
    same surface `ReplicaProc` exposes over HTTP — the router logic is
    identical, which is what makes the in-process failover drills
    (`chip_smoke.py` phase 21 (a), the CPU tests) faithful to the
    cross-process one.
    `kill()` simulates SIGKILL (the engine object — all cache state —
    is discarded; calls raise ConnectionError until `respawn()`)."""

    def __init__(self, name: str, engine_factory, clock=time.time):
        self.name = name
        self._factory = engine_factory
        self.clock = clock
        self.engine = engine_factory(name)
        self.proc_alive = True
        self._fail_class: str | None = None
        self._known: list[str] = []

    # lifecycle ------------------------------------------------------

    def check(self, now: float) -> str | None:
        """None while healthy; a FAIL_CLASSES entry once dead;
        "clean" after a completed drain exit."""
        if not self.proc_alive:
            return self._fail_class
        if self.engine.draining and self.engine.pending() == 0:
            self.proc_alive = False
            self._fail_class = "clean"
            return "clean"
        return None

    def kill(self, fail_class: str = "crash") -> None:
        self.proc_alive = False
        self._fail_class = fail_class
        self.engine = None          # cache state dies with the process

    def respawn(self) -> None:
        self.engine = self._factory(self.name)
        self.proc_alive = True
        self._fail_class = None
        self._known = []

    def ready(self, now: float) -> bool:
        return self.proc_alive

    def stop(self) -> None:
        self.proc_alive = False

    def pump(self) -> bool:
        if self.proc_alive and self.engine.pending():
            return self.engine.step()
        return False

    # request surface (ConnectionError == the process is gone) -------

    def _engine(self):
        if not self.proc_alive or self.engine is None:
            raise ConnectionError(f"replica {self.name} is down")
        return self.engine

    def submit(self, payload: dict) -> dict:
        eng = self._engine()
        resp = _submit_typed(eng, payload)
        if resp.get("ok"):
            self._known.append(str(payload.get("id")))
        return resp

    def progress(self) -> dict:
        eng = self._engine()
        out = _snapshot_requests(eng, self._known)
        # bounded history, like the gateway's done_cap: keep the
        # most recent completions only (the router consumes a result
        # within one poll interval)
        if len(self._known) > 4096:
            done = [r for r in self._known if r in eng.results]
            drop = set(done[:len(self._known) - 4096])
            self._known = [r for r in self._known if r not in drop]
        return {"requests": out, "draining": eng.draining}

    def drain(self) -> dict:
        eng = self._engine()
        done = eng.drain()
        return {"draining": True, "pending": eng.pending(),
                "done": done}

    def telemetry(self) -> dict:
        if not self.proc_alive or self.engine is None:
            return {}
        eng = self.engine
        out = {"queue_depth": len(eng.queue),
               "active_slots": sum(1 for s in eng.slots
                                   if s is not None),
               "free_blocks": eng.alloc.n_free}
        # v15 capacity plane: the live admission-headroom estimate —
        # same fields the subprocess path reads off the fleet
        # collector's serving view
        out.update(eng.headroom())
        return out


class ReplicaProc:
    """Subprocess replica handle: one `serve --serve` child with
    its own monitor+gateway endpoint, heartbeat file, and metrics
    JSONL. The child self-registers its endpoint URL at the router's
    fleet collector (``--fleet-register``), which is how the router
    learns where to submit — no stdout parsing, no fixed ports.

    `check()` implements elastic.py's failure taxonomy for a serving
    child: nonzero exit → crash/corrupt_ckpt (`classify_exit`), a
    heartbeat whose STATUS reads "dead ..." → numeric (killed), a
    heartbeat stale past `hang_timeout` → hang (killed). Exit 0 is
    "clean" — the drain path."""

    def __init__(self, name: str, argv: list[str], collector, *,
                 heartbeat_file: str | None = None,
                 hang_timeout: float | None = None,
                 startup_timeout: float | None = None,
                 term_grace: float = 5.0, timeout: float = 5.0,
                 stdout_path: str | None = None, clock=time.time):
        self.name = name
        self.argv = list(argv)
        self.collector = collector
        self.heartbeat_file = heartbeat_file
        self.hang_timeout = hang_timeout
        # a child can wedge BEFORE its first registration (frozen in
        # its imports, or its --fleet-register POST never landing) —
        # the post-registration staleness clock never arms for it, so
        # a separate, much more generous startup deadline classes it
        # as a hang instead of leaving it "warming" forever while
        # submit() counts it as routable capacity
        self.startup_timeout = (
            float(startup_timeout) if startup_timeout is not None
            else (max(60.0, 3.0 * hang_timeout)
                  if hang_timeout is not None else None))
        self.term_grace = float(term_grace)
        self.timeout = float(timeout)
        self.stdout_path = stdout_path
        self.clock = clock
        self.proc = None
        self.spawned_at = 0.0        # wall clock of the latest spawn
        self._hb_seen = 0.0
        self._beating = False        # first registration seen yet?
        self._stale_url = None       # pre-respawn URL, not the child's
        self._spawn()

    # lifecycle ------------------------------------------------------

    def _spawn(self) -> None:
        if self.heartbeat_file:
            # fresh liveness clock + fresh status per attempt (the
            # Supervisor._run_once contract: a leftover 'dead' must
            # not kill every respawn within one poll)
            try:
                write_heartbeat(self.heartbeat_file, "ok")
            except OSError:
                pass
        out = None
        if self.stdout_path:
            # per-replica console log: N children's result lines must
            # not interleave with the router's own stdout
            out = open(self.stdout_path, "ab")
        try:
            self.proc = subprocess.Popen(
                self.argv, stdout=out, stderr=out,
                stdin=subprocess.DEVNULL)
        finally:
            if out is not None:
                out.close()           # the child holds its own fd
        self._hb_seen = self.spawned_at = time.time()
        self._beating = False

    def _terminate(self) -> None:
        """SIGTERM with grace (the child's handler flushes its metrics
        tail), then SIGKILL — the Supervisor kill path."""
        if self.proc is None or self.proc.poll() is not None:
            return
        if self.term_grace > 0:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=self.term_grace)
                return
            except subprocess.TimeoutExpired:
                pass
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait()

    def check(self, now: float) -> str | None:
        code = self.proc.poll()
        if code is not None:
            return classify_exit(code) or "clean"
        if self.heartbeat_file:
            status = read_heartbeat_status(self.heartbeat_file)
            if status.startswith("dead"):
                self._terminate()
                return "numeric"
            if not self._beating:
                # the staleness clock starts at the replica's (re-)
                # registration: a child spending seconds in its imports
                # before its first beat is warming up, not hung — a
                # stale-at-spawn kill would hang-loop every replica
                # through its own startup until the budget died
                if self.ready(now):
                    self._beating = True
                    self._hb_seen = time.time()
                elif self.startup_timeout is not None \
                        and time.time() - self._hb_seen \
                        > self.startup_timeout:
                    # never registered within the (generous) startup
                    # deadline: wedged before first beat
                    self._terminate()
                    return "hang"
            elif self.hang_timeout is not None:
                try:
                    self._hb_seen = max(
                        self._hb_seen,
                        os.path.getmtime(self.heartbeat_file))
                except OSError:
                    pass
                if time.time() - self._hb_seen > self.hang_timeout:
                    self._terminate()
                    return "hang"
        return None

    def kill(self, fail_class: str = "crash") -> None:
        self._terminate()

    def respawn(self) -> None:
        # the collector still holds the DEAD process's URL until the
        # new child re-registers (by name) — remember it, so ready()
        # waits for the fresh endpoint instead of declaring the
        # respawn done against a socket nobody listens on
        self._stale_url = self.url
        self._spawn()

    def ready(self, now: float) -> bool:
        """Respawn completes when the child is running AND has
        (re-)registered its own endpoint at the collector."""
        url = self.url
        return (self.proc.poll() is None and url is not None
                and url != self._stale_url)

    def stop(self) -> None:
        self._terminate()

    def pump(self) -> bool:
        return False                # the child pumps itself

    # request surface ------------------------------------------------

    @property
    def url(self) -> str | None:
        rep = self._fleet_rep()
        return rep.url if rep is not None else None

    def _fleet_rep(self):
        if self.collector is None:
            return None
        for rep in self.collector.replicas:
            if rep.name == self.name and rep.url:
                return rep
        return None

    def _call(self, endpoint: str, payload=None):
        url = self.url
        if url is None:
            raise ConnectionError(f"replica {self.name} has not "
                                  f"registered an endpoint yet")
        req = urllib.request.Request(
            url + endpoint,
            data=(json.dumps(payload).encode()
                  if payload is not None else None),
            headers={"Content-Type": "application/json"}
            if payload is not None else {})
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout) as r:
                return json.loads(r.read())
        except (http.client.HTTPException,
                json.JSONDecodeError) as e:
            # a replica dying MID-RESPONSE raises IncompleteRead (an
            # HTTPException, not an OSError) or JSONDecodeError on
            # the truncated body — to the router both mean exactly
            # what a refused connection means: the replica is gone
            raise ConnectionError(
                f"replica {self.name}: "
                f"{type(e).__name__}: {e}") from e

    def submit(self, payload: dict) -> dict:
        return self._call("/submit", payload)

    def progress(self) -> dict:
        return self._call("/requests")

    def drain(self) -> dict:
        return self._call("/drain", {})

    def telemetry(self) -> dict:
        """Admission inputs out of the FleetCollector's last poll of
        this replica — queue depth / active slots / free blocks from
        the serving block, ttft p50 from the sketch quantiles. The
        router consumes the collector; it never re-polls."""
        rep = self._fleet_rep()
        if rep is None:
            return {}
        summary = rep.summary()
        out = dict(summary.get("serving") or {})
        q = (summary.get("quantiles") or {}).get("ttft_ms")
        if q and q.get("p50") is not None:
            out["ttft_p50_ms"] = q["p50"]
        return out


# --------------------------------------------------------------- router


class _RouterReq:
    __slots__ = ("rid", "prompt", "max_new", "temp", "seed",
                 "submit_t", "deadline", "tokens", "replica",
                 "dispatch_t", "last_progress_t", "first_tok_t",
                 "failovers", "failover_from", "failover_reason",
                 "exclude", "trace", "span", "attempt", "fp")

    def __init__(self, rid, prompt, max_new, temp, seed, now,
                 deadline):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temp = float(temp)
        self.seed = int(seed)
        self.submit_t = now
        self.deadline = deadline          # absolute wall, or None
        self.tokens: list[int] = []       # received so far (ordered)
        self.replica: str | None = None   # current assignment
        self.dispatch_t = None
        self.last_progress_t = now
        self.first_tok_t = None
        self.failovers = 0
        self.failover_from: str | None = None
        self.failover_reason: str | None = None
        self.exclude: str | None = None   # skip on the next dispatch
        # trace context (schema v11): one trace id for the request's
        # whole fleet journey, a root span for the router's custody,
        # and the 0-based cross-engine dispatch attempt counter the
        # per-replica lifecycle events echo back
        self.trace = new_trace_id()
        self.span = new_span_id()
        self.attempt = -1                 # first dispatch -> 0
        # sticky routing: chained hashes of the prompt's leading
        # aligned chunks (the same chunk identity the engines' prefix
        # index keys on) — empty when sticky is off or the prompt is
        # shorter than one chunk
        self.fp: tuple = ()


class Router:
    """The fleet front-end (module docstring). `spawn(name)` returns a
    replica handle (`ReplicaProc` in production, `InProcessReplica`
    in-process); the router owns every handle's lifecycle from then
    on. Drive it with `step()` from an event loop, or `run()` to
    drain a submitted batch."""

    def __init__(self, spawn, n_replicas: int = 2, *, collector=None,
                 metrics=None, slos: str = "", slo_kw: dict | None = None,
                 clock=time.time, seed: int = 0,
                 queue_budget: int = 256,
                 request_timeout: float | None = 30.0,
                 default_deadline_s: float | None = None,
                 progress_interval: float = 0.0,
                 breaker_kw: dict | None = None,
                 policy_kw: dict | None = None,
                 autoscale: bool = False, min_replicas: int = 1,
                 max_replicas: int = 4, scale_hold_s: float = 5.0,
                 idle_drain_s: float = 30.0,
                 scale_cooldown_s: float = 10.0,
                 sticky: bool = True, sticky_block: int = 16,
                 sticky_bonus: float = 0.5, sticky_cap: float = 1.5,
                 sticky_history: int = 2048):
        self.spawn = spawn
        self.collector = collector
        self.metrics = metrics
        self.clock = clock
        self.queue_budget = int(queue_budget)
        self.request_timeout = request_timeout
        self.default_deadline_s = default_deadline_s
        self.progress_interval = float(progress_interval)
        self.breaker_kw = dict(breaker_kw or {})
        self.policy_kw = dict(policy_kw or {})
        self.autoscale = bool(autoscale)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_hold_s = float(scale_hold_s)
        self.idle_drain_s = float(idle_drain_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        # sticky prefix-affinity routing: the router
        # fingerprints each prompt's leading aligned chunks
        # (`cache.chunk_hashes`, the SAME chunk identity the replicas'
        # prefix index keys on) and remembers, per replica, which
        # chunks its own dispatch history sent where. At rank time a
        # replica earns a bonus of `sticky_bonus` per matched leading
        # chunk, CAPPED at `sticky_cap` — one queued request outscores
        # the cap, so load/burn signals always override locality and a
        # popular prefix cannot create a hotspot. Pure dispatch-side
        # state: failover re-dispatch (`generated=`) stays correct
        # because the fallback replica simply misses its cache.
        self.sticky = bool(sticky)
        self.sticky_block = int(sticky_block)
        self.sticky_bonus = float(sticky_bonus)
        self.sticky_cap = float(sticky_cap)
        self.sticky_history = int(sticky_history)
        self._affinity: dict[str, dict[bytes, None]] = {}
        self._rng = random.Random(seed)
        # fleet-edge SLO rules: ttft fed from the router's own
        # submit→first-token observations, availability from replica
        # detection→ready downtime — monitor.SloRule's dual-window
        # burn evaluation IS the autoscale signal
        self.rules = parse_slos(slos, **(slo_kw or {}))
        self.pending: deque[_RouterReq] = deque()
        self.inflight: dict[str, _RouterReq] = {}
        self.results: dict[str, np.ndarray] = {}
        self.records: list[dict] = []
        self.events: list[dict] = []
        self.counters = {"submitted": 0, "finished": 0, "failed": 0,
                         "routes": 0, "failovers": 0, "rejected": 0,
                         "breaker_trips": 0, "respawns": 0,
                         "scale_ups": 0, "scale_downs": 0}
        self._replicas: dict[str, dict] = {}
        self._breakers: dict[str, CircuitBreaker] = {}
        self._policies: dict[str, RestartPolicy] = {}
        self._next_idx = 0
        self._crit_since: float | None = None
        self._idle_since: float | None = None
        self._last_scale_t = -1e18
        self._last_progress_poll = -1e18
        for _ in range(int(n_replicas)):
            self._add_replica(self.clock())

    # ------------------------------------------------------ membership

    def _add_replica(self, now: float) -> str:
        name = f"r{self._next_idx}"
        self._next_idx += 1
        handle = self.spawn(name)
        self._replicas[name] = {
            "handle": handle, "alive": True, "warming": True,
            "draining": False, "retired": False,
            "down_since": None, "respawn_at": None,
            "respawning": False, "fail_class": None,
        }
        self._breakers[name] = CircuitBreaker(
            seed=self._rng.randrange(1 << 30),
            on_transition=lambda st, t, n=name:
                self._on_breaker(n, st, t),
            **self.breaker_kw)
        self._policies[name] = RestartPolicy(
            seed=self._rng.randrange(1 << 30), **self.policy_kw)
        return name

    def _on_breaker(self, name: str, state: str, now: float) -> None:
        if state == "open":
            self.counters["breaker_trips"] += 1
        self._emit("ledger", kind="breaker", replica=name, state=state)

    def _emit(self, event: str, **fields) -> None:
        rec = {"event": event, **fields}
        self.events.append(rec)
        if self.metrics is not None:
            self.metrics.log(**rec)

    def replica_names(self, live_only: bool = False) -> list[str]:
        return [n for n, e in self._replicas.items()
                if not e["retired"]
                and (not live_only or (e["alive"] and not e["draining"]))]

    # --------------------------------------------------------- clients

    def submit(self, prompt, max_new: int, temperature: float = 0.0,
               seed: int = 0, rid: str | None = None,
               deadline_s: float | None = None) -> str:
        """Queue one request with the fleet. Raises the typed
        `FleetOverloaded` (with retry_after) when the fleet cannot
        accept work right now — every breaker open / replica down or
        draining, or the router queue past its budget."""
        now = self.clock()
        rid = rid if rid is not None else f"q{self.counters['submitted']}"
        if rid in self.inflight or rid in self.results \
                or any(r.rid == rid for r in self.pending):
            raise ValueError(f"duplicate request id {rid!r}")
        # warming replicas count as routable capacity (they are about
        # to register) — work queues for them instead of rejecting
        routable = [n for n in self.replica_names(live_only=True)
                    if self._breakers[n].state != "open"]
        if not routable:
            self.counters["rejected"] += 1
            raise FleetOverloaded(
                "no routable replica (breakers open or replicas "
                "down/draining)", self._min_retry_after(now))
        if len(self.pending) >= self.queue_budget:
            self.counters["rejected"] += 1
            raise FleetOverloaded(
                f"router queue at budget ({self.queue_budget})", 1.0)
        dl = deadline_s if deadline_s is not None \
            else self.default_deadline_s
        req = _RouterReq(rid, prompt, max_new, temperature, seed, now,
                         now + dl if dl is not None else None)
        if self.sticky:
            # imported here: `serving.cache` imports the model, which
            # imports the kernels, which import `serving.cache`
            from shallowspeed_tpu_torch.serving.cache import chunk_hashes

            req.fp = tuple(chunk_hashes(req.prompt, self.sticky_block))
        self.pending.append(req)
        self.counters["submitted"] += 1
        return rid

    def _min_retry_after(self, now: float) -> float:
        waits = [self._breakers[n].retry_after(now)
                 for n, e in self._replicas.items()
                 if not e["retired"]
                 and self._breakers[n].state == "open"]
        waits += [max(0.0, e["respawn_at"] - now)
                  for e in self._replicas.values()
                  if e["respawn_at"] is not None and not e["alive"]]
        return min(waits) if waits else 1.0

    def unfinished(self) -> int:
        return len(self.pending) + len(self.inflight)

    def fail_unfinished(self, reason: str) -> int:
        """Terminally fail every pending and in-flight request (a
        `records` entry with status "failed" each) — the driver's
        last act when the fleet dies for good, so no submitted id
        ever vanishes without a result or error record."""
        now = self.clock()
        n = 0
        while self.pending:
            self._finalize(self.pending.popleft(), now,
                           status="failed", error=reason)
            n += 1
        for req in list(self.inflight.values()):
            self._finalize(req, now, status="failed", error=reason)
            n += 1
        return n

    # ------------------------------------------------------------ step

    def step(self, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        did = False
        self._supervise(now)
        for name, entry in self._replicas.items():
            if entry["alive"] and not entry["retired"]:
                did = entry["handle"].pump() or did
        did = self._poll_progress(now) or did
        self._check_timeouts(now)
        did = self._dispatch(now) or did
        self._drain_progress(now)
        self._evaluate_rules(now)
        self._autoscale(now)
        return did

    def run(self, max_wall: float = 600.0, poll: float = 0.02) -> dict:
        """Drain: step until every submitted request finished or
        failed (bounded by `max_wall` REAL seconds)."""
        t0 = time.monotonic()
        while self.unfinished():
            if time.monotonic() - t0 > max_wall:
                raise RuntimeError(
                    f"router did not drain within {max_wall}s "
                    f"(pending={len(self.pending)}, "
                    f"inflight={len(self.inflight)})")
            if not self.step():
                time.sleep(poll)
        return dict(self.results)

    def shutdown(self) -> None:
        """Stop every replica (SIGTERM/SIGKILL for processes). The
        router object is done after this."""
        for entry in self._replicas.values():
            try:
                entry["handle"].stop()
            except Exception:
                pass

    # ------------------------------------------------------ supervision

    def _supervise(self, now: float) -> None:
        for name, entry in list(self._replicas.items()):
            if entry["retired"]:
                continue
            h = entry["handle"]
            if entry["alive"]:
                if entry["warming"] and h.ready(now):
                    entry["warming"] = False
                try:
                    fail = h.check(now)
                except Exception:
                    fail = "crash"
                if fail == "clean":
                    if entry["draining"]:
                        self._finish_drain(name, now)
                    else:
                        # a serving replica has no clean exit outside
                        # a drain — treat it as a crash
                        self._on_replica_down(name, "crash", now)
                elif fail is not None:
                    self._on_replica_down(name, fail, now)
            elif entry["respawning"]:
                if h.ready(now):
                    entry["alive"] = True
                    entry["respawning"] = False
                    entry["warming"] = False
                    self.counters["respawns"] += 1
                    downtime = now - entry["down_since"]
                    self._note_downtime(downtime, now)
                    self._emit("ledger", kind="restart_downtime",
                               seconds=round(downtime, 3),
                               fail_class=entry["fail_class"],
                               replica=name)
                    entry["down_since"] = None
            elif entry["respawn_at"] is not None \
                    and now >= entry["respawn_at"]:
                try:
                    h.respawn()
                    entry["respawning"] = True
                except Exception:
                    entry["respawn_at"] = now + 1.0

    def _on_replica_down(self, name: str, fail_class: str,
                         now: float) -> None:
        entry = self._replicas[name]
        entry["alive"] = False
        entry["down_since"] = now
        entry["fail_class"] = fail_class
        self._breakers[name].force_open(now)
        # a dead replica's prefix cache died with it — its affinity
        # history must not attract the respawned (cold) successor
        self._affinity.pop(name, None)
        # in-flight work fails over: back to the FRONT of the queue,
        # carrying every token already received — the re-dispatch
        # re-prefills prompt + prefix on another replica and the
        # stream continues token-identically (seeded sampling)
        moved = [r for r in self.inflight.values()
                 if r.replica == name]
        for req in moved:
            req.failover_from = name
            req.failover_reason = "death"
            req.exclude = name
            req.replica = None
            del self.inflight[req.rid]
            self.pending.appendleft(req)
        if entry["draining"]:
            # it died mid-drain; what it had is failing over anyway —
            # complete the scale-down instead of respawning
            self._finish_drain(name, now)
            return
        delay = self._policies[name].next_restart(fail_class)
        if delay is None:
            entry["retired"] = True
            self._emit("ledger", kind="replica_retired", replica=name,
                       fail_class=fail_class)
        else:
            entry["respawn_at"] = now + delay

    # ------------------------------------------------------- progress

    def _poll_progress(self, now: float) -> bool:
        if self.progress_interval and \
                now - self._last_progress_poll < self.progress_interval:
            return False
        self._last_progress_poll = now
        did = False
        for name, entry in self._replicas.items():
            if not entry["alive"] or entry["retired"] \
                    or entry["warming"]:
                # a warming replica (spawned, not yet registered) has
                # no endpoint to poll — failing its breaker for that
                # would reject traffic the fleet is about to gain
                continue
            br = self._breakers[name]
            # a non-closed breaker gates the poll through allow():
            # this IS the jittered half-open probe — one successful
            # poll re-closes the breaker and traffic returns
            if br.state != "closed" and not br.allow(now):
                continue
            h = entry["handle"]
            try:
                prog = h.progress()
            except (OSError, ConnectionError):
                br.note_failure(now)
                continue
            br.note_success(now)
            did = self._fold_progress(name, prog.get("requests") or {},
                                      now) or did
        return did

    def _fold_progress(self, name: str, snap: dict,
                       now: float) -> bool:
        did = False
        for rid, rec in snap.items():
            req = self.inflight.get(rid)
            if req is None or req.replica != name:
                continue            # stale duplicate from a failover
            status = rec.get("status")
            toks = rec.get("tokens") or []
            if status == "rejected":
                self._finalize(req, now, status="rejected",
                               error=rec.get("error"))
                continue
            if len(toks) > len(req.tokens):
                req.tokens = [int(t) for t in toks]
                req.last_progress_t = now
                did = True
                if req.first_tok_t is None:
                    req.first_tok_t = now
                    ttft_ms = (now - req.submit_t) * 1e3
                    for rule in self.rules:
                        if rule.sketch == "ttft_ms":
                            rule.record(ttft_ms, now)
            if status == "done" and len(req.tokens) >= req.max_new:
                self._finalize(req, now, status="done")
        return did

    def _finalize(self, req: _RouterReq, now: float, status: str,
                  error: str | None = None) -> None:
        self.inflight.pop(req.rid, None)
        # e2e from a FRESH clock read, not the step-loop `now`: the
        # request record's log stamp is the stitcher's finish mark,
        # and a stale `now` (captured before this step's polls or an
        # in-process engine's compile) would make the record's e2e
        # disagree with its own stamp by that lag — which the
        # waterfall would book as rq_unexplained
        rec = {"id": req.rid, "status": status,
               "replica": req.replica, "failovers": req.failovers,
               "trace": req.trace, "span": req.span,
               "tokens_in": int(req.prompt.shape[0]),
               "tokens_out": len(req.tokens),
               "e2e_ms": round(
                   (self.clock() - req.submit_t) * 1e3, 3)}
        if req.first_tok_t is not None:
            rec["ttft_ms"] = round(
                (req.first_tok_t - req.submit_t) * 1e3, 3)
        if error:
            rec["error"] = str(error)
        self.records.append(rec)
        if status == "done":
            self.results[req.rid] = np.asarray(req.tokens, np.int32)
            self.counters["finished"] += 1
            if self.metrics is not None and "ttft_ms" in rec:
                # the fleet-edge request record (schema v6 shape +
                # v10 replica/failovers fields): --goodput over the
                # ROUTER log alone yields user-felt percentiles
                self.metrics.log(event="request", **{
                    k: v for k, v in rec.items() if k != "status"})
        else:
            self.counters["failed"] += 1
            self._emit("ledger", kind=f"request_{status}", count=1,
                       replica=req.replica or "?")

    def _check_timeouts(self, now: float) -> None:
        for req in list(self.inflight.values()):
            if req.deadline is not None and now > req.deadline:
                self._finalize(req, now, status="deadline_exceeded")
                continue
            if self.request_timeout is not None \
                    and now - req.last_progress_t > self.request_timeout:
                # stalled: penalize the replica, fail the request over
                self._breakers[req.replica].note_failure(now)
                req.failover_from = req.replica
                req.failover_reason = "timeout"
                req.exclude = req.replica
                req.replica = None
                req.last_progress_t = now
                del self.inflight[req.rid]
                self.pending.appendleft(req)
        for req in list(self.pending):
            if req.deadline is not None and now > req.deadline:
                self.pending.remove(req)
                self._finalize(req, now, status="deadline_exceeded")

    # -------------------------------------------------------- dispatch

    def _score(self, name: str, now: float) -> float:
        """Admission weight: the router's own in-flight count plus the
        replica's polled queue/slot pressure, minus free headroom,
        plus a tail-latency penalty when its ttft p50 is elevated —
        the /status.json-weighted dispatch the FleetCollector feeds."""
        entry = self._replicas[name]
        t = {}
        try:
            t = entry["handle"].telemetry() or {}
        except Exception:
            pass
        s = float(sum(1 for r in self.inflight.values()
                      if r.replica == name))
        s += float(t.get("queue_depth") or 0)
        s += 0.5 * float(t.get("active_slots") or 0)
        fb = t.get("free_blocks")
        if isinstance(fb, (int, float)):
            s -= 0.001 * min(float(fb), 1000.0)
        # v15 capacity plane: NEGATIVE admission headroom means the
        # replica's accepted max-token budgets already overcommit its
        # block pool — placing more work there buys evictions, not
        # throughput. One overcommitted block outweighs one queued
        # request so a near-OOM replica sheds load BEFORE it evicts;
        # capped like the ttft penalty so a deeply-overcommitted
        # replica still ranks (it may be the only one alive).
        hb = t.get("headroom_blocks")
        if isinstance(hb, (int, float)) and hb < 0:
            s += min(-float(hb), 20.0)
        ttft = t.get("ttft_p50_ms")
        if isinstance(ttft, (int, float)) and ttft > 0:
            s += min(float(ttft) / 1e3, 10.0)    # seconds of p50 ttft
        return s

    def _affinity_bonus(self, name: str, req) -> float:
        """Sticky prefix-affinity bonus: `sticky_bonus` per LEADING
        fingerprint chunk this replica has already served (contiguous
        from the front — a mid-prompt match is useless to the prefix
        cache), capped at `sticky_cap` so one unit of queue pressure
        always outranks locality."""
        if not req.fp:
            return 0.0
        seen = self._affinity.get(name)
        if not seen:
            return 0.0
        n = 0
        for h in req.fp:
            if h not in seen:
                break
            n += 1
        return min(self.sticky_cap, self.sticky_bonus * n)

    def _note_affinity(self, name: str, req) -> None:
        """Record the dispatched prompt's chunks in `name`'s affinity
        history (LRU, bounded at sticky_history)."""
        if not req.fp:
            return
        seen = self._affinity.setdefault(name, {})
        for h in req.fp:
            seen.pop(h, None)          # re-insert at the MRU end
            seen[h] = None
        while len(seen) > self.sticky_history:
            seen.pop(next(iter(seen)))

    def _dispatch(self, now: float) -> bool:
        if not self.pending:
            return False        # nothing to place — don't pay the
                                # per-replica telemetry reads at all
        did = False
        # score each dispatchable replica ONCE per dispatch round (a
        # telemetry/summary read per candidate per pending request
        # would make the hot path O(pending x replicas) lock+quantile
        # work); the in-flight component advances incrementally as
        # requests land
        scores = {n: self._score(n, now)
                  for n, e in self._replicas.items()
                  if e["alive"] and not e["draining"]
                  and not e["retired"] and not e["warming"]
                  and self._breakers[n].state == "closed"}
        while self.pending:
            req = self.pending[0]
            # sticky: fold the bounded prefix-affinity bonus into the
            # per-request ranking (scores themselves stay load-only —
            # the +1.0 landing bump below keeps overriding locality)
            ranked = sorted((n for n in scores if n != req.exclude),
                            key=lambda n: (scores[n]
                                           - self._affinity_bonus(n, req),
                                           n))
            if not ranked and req.exclude is not None:
                # nowhere else to go. If this is a TIMEOUT failover
                # and its old replica is still up, the work is still
                # running there (same rid) — re-attach instead of
                # re-submitting a duplicate; a death failover's old
                # engine is gone, so re-submission is safe
                name = req.exclude
                if req.failover_reason == "timeout" and name in scores:
                    self.pending.popleft()
                    self._reattach(req, name, now)
                    did = True
                    continue
                ranked = sorted(scores, key=lambda n: (scores[n], n))
            sent = False
            # one dispatch span per dispatch round; the engine's
            # lifecycle spans parent to it, so a failover's re-prefill
            # hangs off the RE-dispatch, not the original
            span_k = new_span_id()
            attempt_next = req.attempt + 1
            payload = {"id": req.rid,
                       "prompt": [int(t) for t in req.prompt],
                       "max_new": req.max_new,
                       "temperature": req.temp, "seed": req.seed,
                       "generated": list(req.tokens),
                       "trace": req.trace, "parent": span_k,
                       "attempt": attempt_next}
            for name in ranked:
                # pre-POST clock pair: the ONLY router stamp that
                # happens-before the replica's lifecycle "submit"
                # (the route/failover event itself is emitted AFTER
                # the gateway accepted, i.e. after that stamp) — the
                # stitcher's skew fit needs this lower bound, and
                # pre->event brackets one dispatch transaction
                # (telemetry/tracing._fit_offsets)
                pre_wall, pre_mono = time.time(), time.monotonic()
                try:
                    resp = self._replicas[name]["handle"].submit(
                        payload)
                except (OSError, ConnectionError):
                    self._breakers[name].note_failure(now)
                    continue
                self._breakers[name].note_success(now)
                err = (resp or {}).get("error")
                if err:
                    if "duplicate" in str(err):
                        # the replica already holds this rid: a prior
                        # failover left live work there (it survived
                        # while the request bounced elsewhere) —
                        # re-attach to it rather than terminally
                        # rejecting a request another engine is about
                        # to finish
                        self.pending.popleft()
                        self._reattach(req, name, now)
                        sent = did = True
                        break
                    if str(err).startswith(("ValueError", "KeyError",
                                            "TypeError")):
                        self.pending.popleft()
                        self._finalize(req, now, status="rejected",
                                       error=err)
                        sent = True     # consumed (terminally)
                        break
                    continue    # draining/overloaded: try the next
                self.pending.popleft()
                req.replica = name
                req.dispatch_t = now
                req.last_progress_t = now
                req.attempt = attempt_next
                self.inflight[req.rid] = req
                scores[name] = scores.get(name, 0.0) + 1.0
                # snapshot the bonus that influenced THIS ranking
                # before the landing itself is recorded into history
                aff = self._affinity_bonus(name, req)
                if self.sticky:
                    self._note_affinity(name, req)
                if req.failover_from is not None:
                    req.failovers += 1
                    self.counters["failovers"] += 1
                    self._emit("failover", id=req.rid, replica=name,
                               reason=req.failover_reason or "?",
                               tokens_done=len(req.tokens),
                               attempt=req.attempt,
                               trace=req.trace, span=span_k,
                               parent=req.span,
                               dispatch_wall=round(pre_wall, 6),
                               dispatch_mono=round(pre_mono, 6),
                               **{"from": req.failover_from})
                    req.failover_from = None
                    req.failover_reason = None
                else:
                    self.counters["routes"] += 1
                    extra_route = {}
                    if self.sticky:
                        extra_route["affinity"] = round(aff, 3)
                    self._emit("route", id=req.rid, replica=name,
                               queue_depth=len(self.pending),
                               score=round(scores[name] - 1.0, 3),
                               **extra_route,
                               trace=req.trace, span=span_k,
                               parent=req.span,
                               dispatch_wall=round(pre_wall, 6),
                               dispatch_mono=round(pre_mono, 6),
                               # fresh clock, not the step-loop
                               # `now`: the stitcher derives the
                               # fleet-edge submit time as (this
                               # line's log stamp - wait_ms), so
                               # wait_ms must be measured AT emission
                               # or the dispatch lag (an in-process
                               # engine compile) lands in rq_queue
                               wait_ms=round(
                                   (self.clock() - req.submit_t)
                                   * 1e3, 3))
                sent = did = True
                break
            if not sent:
                break               # no capacity now; retry next step
        return did

    def _reattach(self, req: _RouterReq, name: str,
                  now: float) -> None:
        """Bind a failed-over request back onto a replica that is
        still (or already) running it — timeout failovers with
        nowhere else to go, and duplicate-id replies from a replica a
        previous failover left the work on."""
        req.replica = name
        req.last_progress_t = now
        req.failover_from = None
        req.failover_reason = None
        self.inflight[req.rid] = req

    # ----------------------------------------------------- scale down

    def _start_drain(self, name: str, now: float,
                     reason: str) -> None:
        entry = self._replicas[name]
        entry["draining"] = True
        self._emit("scale", action="drain", replica=name,
                   reason=reason,
                   n_replicas=len(self.replica_names()))
        try:
            entry["handle"].drain()
        except (OSError, ConnectionError):
            pass                     # re-asked in _drain_progress

    def _drain_progress(self, now: float) -> None:
        for name, entry in list(self._replicas.items()):
            if not entry["draining"] or entry["retired"] \
                    or not entry["alive"]:
                continue
            if any(r.replica == name for r in self.inflight.values()):
                continue             # router-tracked work still there
            try:
                resp = entry["handle"].drain()
            except (OSError, ConnectionError):
                continue
            if resp.get("done") or resp.get("pending") == 0:
                # in-process handles report drained synchronously;
                # subprocess replicas exit 0 instead and land in
                # _supervise's "clean" branch
                self._finish_drain(name, now)

    def _finish_drain(self, name: str, now: float) -> None:
        entry = self._replicas[name]
        entry["retired"] = True
        entry["alive"] = False
        try:
            entry["handle"].stop()
        except Exception:
            pass
        if self.collector is not None:
            try:
                self.collector.deregister_replica({"name": name})
            except Exception:
                pass
        self.counters["scale_downs"] += 1
        self._emit("scale", action="down", replica=name,
                   reason="drained",
                   n_replicas=len(self.replica_names()))

    # ------------------------------------------------------- SLO/scale

    def _evaluate_rules(self, now: float) -> None:
        for rule in self.rules:
            rec = rule.evaluate(now)
            if rec is not None:
                self._emit("alert", **rec)

    def _autoscale(self, now: float) -> None:
        if not self.autoscale:
            return
        critical = any(r.state == "critical" for r in self.rules)
        if critical:
            self._idle_since = None
            if self._crit_since is None:
                self._crit_since = now
            elif (now - self._crit_since >= self.scale_hold_s
                  and now - self._last_scale_t >= self.scale_cooldown_s
                  and len(self.replica_names()) < self.max_replicas):
                burn = max((r.burn(r.fast_s, now) for r in self.rules
                            if r.sketch is not None), default=0.0)
                name = self._add_replica(now)
                self._last_scale_t = now
                self._crit_since = None
                self.counters["scale_ups"] += 1
                self._emit("scale", action="up", replica=name,
                           reason="burn", burn=round(burn, 3),
                           n_replicas=len(self.replica_names()))
            return
        self._crit_since = None
        busy = bool(self.unfinished())
        if busy:
            self._idle_since = None
            return
        if self._idle_since is None:
            self._idle_since = now
            return
        if (now - self._idle_since >= self.idle_drain_s
                and now - self._last_scale_t >= self.scale_cooldown_s
                and len(self.replica_names()) > self.min_replicas):
            live = [n for n in self.replica_names(live_only=True)]
            if not live:
                return
            # newest replica drains first (LIFO scale) — by spawn
            # index, not name string ("r9" > "r10" lexically)
            victim = max(live, key=lambda n: (int(n[1:])
                                              if n[1:].isdigit()
                                              else -1, n))
            self._last_scale_t = now
            self._idle_since = None
            self._start_drain(victim, now, reason="idle")

    # availability feed: called by _supervise at respawn-ready with
    # the measured downtime — split out so the stamp and the rule can
    # never disagree
    def _note_downtime(self, seconds: float, now: float) -> None:
        for rule in self.rules:
            if rule.sketch is None:
                rule.record_down(float(seconds), now)
