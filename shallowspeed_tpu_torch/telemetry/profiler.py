"""Continuous profiling plane — the fourth observability pillar.

The port's copy of `shallowspeed_tpu/telemetry/profiler.py`: the host
sampler, phase tags, capture windows and reductions are the
reference's; the device trace (`device_trace_ctx`) is a
`torch.profiler` capture of the CPU and CUDA activity instead of a
`jax.profiler` trace.

The waterfall (`telemetry/attribution.py`) prices every fenced step
into compute/comm/bubble/host fractions, but `attrib_host_frac` is an
opaque blob: when host time grows — the exact failure mode host-driven
pipeline schedules suffer at scale (PipeDream, arXiv 1806.03377) —
nothing says *where* it went. Four parts close that:

- **Always-on host sampler** (`SamplingProfiler`): a daemon thread
  reads the MAIN thread's Python stack via `sys._current_frames()` at
  ~67 Hz (default off; ``--profile {off,host,host+device}``), folds it
  root->leaf into a `frame;frame;...` string, and aggregates exact
  counts per folded stack. Periodic schema-v12 ``"profile"`` events
  carry the CUMULATIVE top-K + an exact `(other)` remainder — like the
  v7 sketch snapshots, the last event per process stanza is the whole
  story and events MERGE across replicas by summing counts. Reduce to
  a d3-flamegraph-shaped JSON with ``python -m shallowspeed_tpu_torch
  .telemetry --profile <log> --out flame.json``.
- **Span-tagged attribution** (`tag` + the tracer phase hook): every
  sample is labelled with the innermost active phase — tracer spans
  (step/grads/update) auto-push via `trace.PHASE_HOOKS`; the serving
  engine brackets its scheduler phases (data-load, block-alloc,
  prefill-chunk, sampling, decode-tick, logging, gateway) with
  `tag(...)`, which costs one module-global check when no profiler
  runs (the `_NULL_SPAN` pattern). `phases` decomposes the host blob
  into named buckets; `step_samples` (stack contains a step/batch
  span) is the sampler's own estimate of in-step time, cross-checked
  against the waterfall's `attrib_host_frac` in tests.
- **Trigger-driven capture windows** (`CaptureWindow`): a critical SLO
  burn, an anomaly verdict, a chaos fault, or a fleet straggler
  verdict arms ONE bounded high-rate window (~200 Hz for ~0.5 s) via
  the existing `Monitor.alert_listeners` / `chaos.add_observer` /
  flight-recorder plumbing — deduped by (reason, step), capped like
  flight dumps, plus a cooldown so a fault and the SLO burn it causes
  yield one capture, not two. Dumps land as ``profcap_<step>.json``
  next to ``flightrec_*``, naming the dominant tagged phase. At
  ``host+device`` the window also wraps a `torch.profiler` device
  trace (skipped when a ``--profile-dir`` trace is already live —
  profiler sessions do not nest).
- **Fleet surface**: `Monitor.profile_payload` serves GET
  /profile.json on the duck-typed StatusServer; `fleet.FleetCollector`
  polls it per replica and merges the folded stacks into one
  replica-prefixed fleet flamegraph; `--goodput` grows a `profiling`
  block naming the top host-time frames per replica.

Safety contract: the sampler never touches torch (pure stdlib), so a
profiled run launches the SAME kernels as an unprofiled one; reading
frames under
the GIL is O(stack depth), so the sampler cannot block the main thread
beyond a bounded beat — `max_gap_ms` records the worst inter-sample
gap and the test suite asserts it stays bounded.
"""

from __future__ import annotations

import contextlib
import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path

MODES = ("off", "host", "host+device")

DEFAULT_HZ = 67.0          # off the 50/100 round numbers: a sampler
                           # phase-locked to a 10 ms scheduler beat
                           # aliases; 67 Hz keeps ~15 ms spacing
DEFAULT_TOP_K = 40
OTHER_KEY = "(other)"
UNTAGGED = "(untagged)"
# tag names whose presence ANYWHERE in the stack marks a sample as
# inside a fenced step span (attribution.window_step_spans' names)
STEP_TAGS = ("step", "batch")

# ------------------------------------------------------------- tagging
#
# Module-level registry (thread ident -> stack of phase names) instead
# of the tracer's threading.local span stacks: the SAMPLER thread must
# read the MAIN thread's innermost phase, and threading.local is by
# design invisible cross-thread. Mutated only by the owning thread;
# the sampler reads racily under the GIL (a torn read costs one
# mislabelled sample, never a crash).

_TAGS: dict[int, list] = {}
_ACTIVE = 0     # number of running SamplingProfilers; tag() gates on it


class _NullTag:
    """Shared no-op: the `tag()` fast path when no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_TAG = _NullTag()


class _Tag:
    __slots__ = ("name", "_ident")

    def __init__(self, name: str):
        self.name = name
        self._ident = None

    def __enter__(self):
        self._ident = threading.get_ident()
        _TAGS.setdefault(self._ident, []).append(self.name)
        return self

    def __exit__(self, *exc):
        stack = _TAGS.get(self._ident)
        if stack:
            if stack and stack[-1] == self.name:
                stack.pop()
            else:
                # a profiler started/stopped mid-span can leave the
                # stack misaligned once — recover instead of corrupting
                try:
                    stack.remove(self.name)
                except ValueError:
                    pass
        return False


def tag(name: str):
    """Phase-tag context manager for host-attribution buckets. Returns
    a shared no-op unless a profiler is running, so engine hot loops
    may call it unconditionally."""
    if not _ACTIVE:
        return _NULL_TAG
    return _Tag(name)


# package-level re-export alias (`telemetry.profiler_tag`): `tag` is
# too generic a name to surface at the package root unqualified
profiler_tag = tag


def _push_phase(name: str) -> None:
    _TAGS.setdefault(threading.get_ident(), []).append(name)


def _pop_phase(name: str) -> None:
    stack = _TAGS.get(threading.get_ident())
    if stack:
        if stack[-1] == name:
            stack.pop()
        else:
            try:
                stack.remove(name)
            except ValueError:
                pass


def _install_hooks() -> None:
    """Tracer spans feed the phase registry while any profiler runs —
    a `step` span tags its samples without the drivers changing."""
    global _ACTIVE
    _ACTIVE += 1
    if _ACTIVE == 1:
        from shallowspeed_tpu_torch.telemetry import trace

        trace.PHASE_HOOKS = (_push_phase, _pop_phase)


def _uninstall_hooks() -> None:
    global _ACTIVE
    _ACTIVE = max(0, _ACTIVE - 1)
    if _ACTIVE == 0:
        from shallowspeed_tpu_torch.telemetry import trace

        trace.PHASE_HOOKS = None
        _TAGS.clear()


# ------------------------------------------------------------ sampling


def _fold(frame, max_depth: int = 48) -> str:
    """One thread's stack as a root->leaf folded string. Frames render
    as `module:function`; the profiler's own frames never appear (it
    samples other threads only)."""
    parts = []
    f = frame
    while f is not None and len(parts) < max_depth:
        co = f.f_code
        mod = Path(co.co_filename).stem
        parts.append(f"{mod}:{co.co_name}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


def _tags_of(ident: int) -> tuple[str, bool]:
    """(innermost phase, in-step?) for one thread — racy-read safe."""
    stack = _TAGS.get(ident)
    if not stack:
        return UNTAGGED, False
    try:
        snap = list(stack)
    except RuntimeError:  # pragma: no cover — resize during copy
        return UNTAGGED, False
    if not snap:
        return UNTAGGED, False
    return (str(snap[-1]),
            any(t in STEP_TAGS for t in snap))


class SamplingProfiler:
    """Daemon-thread stack sampler over the process MAIN thread.

    Main thread only, deliberately: `attrib_host_frac` measures the
    driver/scheduler thread's wall time outside fenced step spans, and
    a monitor HTTP thread parked in `select` would swamp the phase
    buckets with sleep frames. (`all_threads=True` exists for
    forensics; the attribution cross-check assumes the default.)

    All counters are CUMULATIVE; `snapshot()` bounds the payload to
    `top_k` folded stacks plus an exact `(other)` remainder, so
    snapshots merge across processes by summing counts — the reducer
    takes the LAST "profile" event per stanza, like "monitor" events.
    """

    def __init__(self, hz: float = DEFAULT_HZ,
                 top_k: int = DEFAULT_TOP_K, emit=None,
                 emit_every_s: float = 5.0, max_depth: int = 48,
                 all_threads: bool = False,
                 clock=time.perf_counter):
        self.hz = float(hz)
        self.top_k = int(top_k)
        self.emit = emit
        self.emit_every_s = float(emit_every_s)
        self.max_depth = int(max_depth)
        self.all_threads = bool(all_threads)
        self._clock = clock
        self.folded: Counter = Counter()
        self.phases: Counter = Counter()
        self.samples = 0
        self.step_samples = 0
        self._other = 0            # counts compacted out of `folded`
        self.max_gap_ms = 0.0
        self._t_start = None
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._thread: threading.Thread | None = None
        # RAM bound: compact the folded table back to 4*top_k uniques
        # whenever it doubles past that (exact counts for survivors,
        # the remainder lands in `(other)`)
        self._compact_at = max(64, 8 * self.top_k)

    # --------------------------------------------------------- control

    def start(self) -> "SamplingProfiler":
        if self._thread is not None:
            return self
        _install_hooks()
        self._t_start = self._clock()
        self._thread = threading.Thread(target=self._run,
                                        name="profiler-sampler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._halt.set()
        self._thread.join(timeout=5)
        self._thread = None
        if self.emit is not None and self.samples:
            self._emit_snapshot()
        _uninstall_hooks()

    # -------------------------------------------------------- sampling

    def _run(self) -> None:
        period = 1.0 / max(self.hz, 1e-3)
        last = self._clock()
        next_emit = last + self.emit_every_s
        while not self._halt.wait(period):
            now = self._clock()
            gap_ms = (now - last) * 1e3
            last = now
            with self._lock:
                if self.samples:
                    self.max_gap_ms = max(self.max_gap_ms, gap_ms)
            self.sample_once()
            if self.emit is not None and now >= next_emit:
                next_emit = now + self.emit_every_s
                self._emit_snapshot()

    def sample_once(self) -> None:
        """One sampling beat (public so tests can drive it without the
        thread/clock)."""
        me = threading.get_ident()
        main = threading.main_thread().ident
        frames = sys._current_frames()
        for ident, frame in frames.items():
            if ident == me:
                continue
            if not self.all_threads and ident != main:
                continue
            folded = _fold(frame, self.max_depth)
            phase, in_step = _tags_of(ident)
            with self._lock:
                self.samples += 1
                self.folded[folded] += 1
                self.phases[phase] += 1
                if in_step:
                    self.step_samples += 1
                if len(self.folded) > 2 * self._compact_at:
                    self._compact_locked()

    def _compact_locked(self) -> None:
        keep = dict(self.folded.most_common(self._compact_at))
        dropped = sum(self.folded.values()) - sum(keep.values())
        self._other += dropped
        self.folded = Counter(keep)

    # -------------------------------------------------------- snapshot

    def snapshot(self) -> dict:
        """The cumulative "profile" event payload (schema v12)."""
        with self._lock:
            top = dict(self.folded.most_common(self.top_k))
            other = (self.samples - sum(top.values()))
            snap = {
                "samples": int(self.samples),
                "step_samples": int(self.step_samples),
                "hz": round(self.hz, 3),
                "top_k": int(self.top_k),
                "folded": {k: int(v) for k, v in top.items()},
                "other": max(0, int(other)),
                "phases": {str(k): int(v)
                           for k, v in self.phases.items()},
                "max_gap_ms": round(self.max_gap_ms, 3),
            }
            if self._t_start is not None:
                snap["window_s"] = round(self._clock() - self._t_start,
                                         3)
            return snap

    def _emit_snapshot(self) -> None:
        try:
            self.emit(event="profile", **self.snapshot())
        except Exception:
            pass  # a telemetry sink bug must not kill the sampler


# ----------------------------------------------------- capture windows


class CaptureWindow:
    """Burn/fault/straggler-armed high-rate capture, bounded like the
    flight recorder: dedup by (reason, step), `max_captures` per run,
    plus `cooldown_s` — a stall fault and the SLO alert it trips ~one
    second later must produce ONE profcap, not a pair. `arm()` is
    non-blocking: the window samples on its own short-lived thread
    while the triggering thread (often the one about to stall) keeps
    going — which is exactly what puts the stalled phase in the
    capture."""

    def __init__(self, out_dir=None, duration_s: float = 0.5,
                 hz: float = 200.0, max_captures: int = 16,
                 cooldown_s: float = 30.0, device_trace: bool = False,
                 max_depth: int = 48, clock=time.time):
        self.out_dir = Path(out_dir) if out_dir else Path(".")
        self.duration_s = float(duration_s)
        self.hz = float(hz)
        self.max_captures = int(max_captures)
        self.cooldown_s = float(cooldown_s)
        self.device_trace = bool(device_trace)
        self.max_depth = int(max_depth)
        self._clock = clock
        self.captures: list[str] = []
        self._seen: set = set()
        self._last_arm: float | None = None
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    def arm(self, reason: str, step=None, trigger=None) -> bool:
        """Start one capture window; False when deduped/capped/cooling
        down."""
        with self._lock:
            key = (reason, step)
            now = self._clock()
            if key in self._seen:
                return False
            if len(self._seen) >= self.max_captures:
                return False
            if self._last_arm is not None \
                    and now - self._last_arm < self.cooldown_s:
                return False
            self._seen.add(key)
            self._last_arm = now
        th = threading.Thread(
            target=self._capture, name="profiler-capture",
            args=(reason, step, trigger), daemon=True)
        self._threads.append(th)
        th.start()
        return True

    def wait(self, timeout: float = 10.0) -> None:
        """Join outstanding capture threads (driver teardown + tests —
        a profcap from a fault on the final tick must hit disk before
        the process exits)."""
        for th in self._threads:
            th.join(timeout=timeout)

    def _capture(self, reason: str, step, trigger) -> None:
        folded: Counter = Counter()
        phases: Counter = Counter()
        main = threading.main_thread().ident
        me = threading.get_ident()
        period = 1.0 / max(self.hz, 1e-3)
        deadline = time.perf_counter() + self.duration_s
        dev_dir = None
        ctx = contextlib.nullcontext()
        if self.device_trace and not _device_trace_active():
            tag_ = step if step is not None else len(self.captures)
            dev_dir = self.out_dir / f"profcap_dev_{tag_}"
            ctx = device_trace_ctx(dev_dir)
        n = 0
        try:
            with ctx:
                while time.perf_counter() < deadline:
                    frames = sys._current_frames()
                    frame = frames.get(main)
                    if frame is not None and main != me:
                        folded[_fold(frame, self.max_depth)] += 1
                        phase, _ = _tags_of(main)
                        phases[phase] += 1
                        n += 1
                    time.sleep(period)
        except Exception:
            pass  # best effort, like flight dumps
        dominant = phases.most_common(1)[0][0] if phases else None
        payload = {"reason": reason, "step": step,
                   "wall": round(time.time(), 3), "trigger": trigger,
                   "duration_s": self.duration_s, "hz": self.hz,
                   "samples": n,
                   "dominant_phase": dominant,
                   "phases": {k: int(v) for k, v in phases.items()},
                   "folded": dict(folded.most_common(200))}
        if dev_dir is not None:
            payload["device_trace"] = str(dev_dir)
        tag_ = step if step is not None else f"n{len(self.captures)}"
        path = self.out_dir / f"profcap_{tag_}.json"
        k = 0
        while path.exists():
            k += 1
            path = self.out_dir / f"profcap_{tag_}_{k}.json"
        try:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
        except OSError:
            return
        self.captures.append(str(path))


# ----------------------------------------------- device-trace plumbing
#
# Exactly ONE torch.profiler entry point for the whole port: the
# drivers' --profile-dir capture, the host+device mode, and the capture
# windows all come through here, and the depth counter keeps a capture
# from trying to nest a second profiler session inside a live one.

_DEVICE_TRACE_DEPTH = 0


def _device_trace_active() -> bool:
    return _DEVICE_TRACE_DEPTH > 0


def trace_file(trace_dir) -> Path:
    """Where `device_trace_ctx` writes this process's Chrome trace:
    one file per process, named with `distributed.process_index()`."""
    from shallowspeed_tpu_torch import distributed

    return Path(trace_dir) / f"trace_p{distributed.process_index()}.json"


@contextlib.contextmanager
def device_trace_ctx(trace_dir):
    """A `torch.profiler.profile` capture of the CPU and CUDA activity
    (CUDA when a card is present) written as a Chrome trace into
    `trace_dir` (`trace_file`); a falsy `trace_dir` is a no-op (so
    drivers pass --profile-dir through unconditionally). Failures of
    the profiler raise."""
    global _DEVICE_TRACE_DEPTH
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = trace_file(trace_dir)
    path.parent.mkdir(parents=True, exist_ok=True)
    _DEVICE_TRACE_DEPTH += 1
    try:
        with profile(activities=activities) as prof:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()   # the window's kernels ended
        prof.export_chrome_trace(str(path))
    finally:
        _DEVICE_TRACE_DEPTH -= 1


# -------------------------------------------------------------- plane


class ProfilerPlane:
    """One process's profiling plane: the always-on sampler + the
    trigger-armed capture windows, with the listener endpoints the
    drivers wire (`on_alert` -> Monitor.alert_listeners, `on_fault` ->
    chaos.add_observer, `on_straggler` -> FleetCollector) and the
    /profile.json payload the StatusServer duck-types."""

    def __init__(self, mode: str = "host", metrics=None, out_dir=None,
                 hz: float = DEFAULT_HZ, top_k: int = DEFAULT_TOP_K,
                 emit_every_s: float = 5.0, capture_s: float = 0.5,
                 capture_hz: float = 200.0, cooldown_s: float = 30.0,
                 max_captures: int = 16):
        assert mode in MODES and mode != "off", mode
        self.mode = mode
        self.sampler = SamplingProfiler(
            hz=hz, top_k=top_k,
            emit=metrics.log if metrics is not None else None,
            emit_every_s=emit_every_s)
        self.capture = CaptureWindow(
            out_dir=out_dir, duration_s=capture_s, hz=capture_hz,
            cooldown_s=cooldown_s, max_captures=max_captures,
            device_trace=(mode == "host+device"))
        self._closed = False

    def start(self) -> "ProfilerPlane":
        self.sampler.start()
        return self

    # ------------------------------------------------------- triggers

    def on_alert(self, rec: dict) -> None:
        """Monitor.alert_listeners endpoint: critical burns arm a
        capture (warn-level flapping must not churn windows)."""
        try:
            if rec.get("state") == "firing" \
                    and rec.get("severity") == "critical":
                self.capture.arm(f"slo:{rec.get('slo')}",
                                 step=rec.get("step"), trigger=rec)
        except Exception:
            pass

    def on_fault(self, rec: dict) -> None:
        """chaos.add_observer endpoint: fires BEFORE the fault body
        (the stall sleep), so the window samples the stalled phase."""
        try:
            if rec.get("event") == "fault":
                self.capture.arm(f"fault:{rec.get('kind')}",
                                 step=rec.get("step"), trigger=rec)
        except Exception:
            pass

    def on_straggler(self, rec: dict) -> None:
        """FleetCollector straggler endpoint (router-side plane)."""
        try:
            if rec.get("state", "firing") == "firing":
                self.capture.arm(
                    f"straggler:{rec.get('replica')}:"
                    f"{rec.get('metric')}", trigger=rec)
        except Exception:
            pass

    def on_incident(self, reason: str, step=None, trigger=None) -> None:
        """Generic trigger — the Monitor's flight-dump path (anomaly
        verdicts) arms through this."""
        try:
            self.capture.arm(reason, step=step, trigger=trigger)
        except Exception:
            pass

    # -------------------------------------------------------- surface

    def profile_payload(self) -> dict:
        return {"enabled": True, "mode": self.mode,
                **self.sampler.snapshot(),
                "captures": list(self.capture.captures)}

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.capture.wait(timeout=self.capture.duration_s + 5.0)
        self.sampler.stop()


def from_args(args, metrics=None, out_dir=None):
    """Driver wiring, mirroring `monitor.from_args`: build-and-start a
    ProfilerPlane from ``--profile`` (plus optional ``--profile-hz``),
    or None when off. Captures land next to the metrics log (where
    flightrec_* go) unless `out_dir` says otherwise."""
    mode = getattr(args, "profile", "off") or "off"
    if mode not in MODES:
        raise SystemExit(f"--profile {mode!r} not in {MODES}")
    if mode == "off":
        return None
    if out_dir is None:
        log_file = getattr(args, "log_file", "") or ""
        out_dir = Path(log_file).parent if log_file else Path(".")
    plane = ProfilerPlane(
        mode, metrics=metrics, out_dir=out_dir,
        hz=float(getattr(args, "profile_hz", 0) or DEFAULT_HZ))
    return plane.start()


# ---------------------------------------------------------- reduction


def merge_profiles(snaps: dict[str, dict]) -> dict:
    """Fold {label: profile-payload} into one fleet view: folded
    stacks prefixed with their replica label (one flamegraph with a
    per-replica first level), phases and counters summed."""
    folded: Counter = Counter()
    phases: Counter = Counter()
    samples = step = other = 0
    for label, snap in sorted(snaps.items()):
        for stack, n in (snap.get("folded") or {}).items():
            folded[f"{label};{stack}"] += int(n)
        oth = int(snap.get("other") or 0)
        if oth:
            folded[f"{label};{OTHER_KEY}"] += oth
            other += oth
        for ph, n in (snap.get("phases") or {}).items():
            phases[ph] += int(n)
        samples += int(snap.get("samples") or 0)
        step += int(snap.get("step_samples") or 0)
    return {"samples": samples, "step_samples": step, "other": other,
            "folded": dict(folded), "phases": dict(phases),
            "replicas": sorted(snaps)}


def flame_tree(folded: dict) -> dict:
    """Folded counts -> hierarchical {name, value, children} JSON (the
    d3-flamegraph shape; Perfetto imports collapsed stacks too, so the
    folded dict itself is also an artifact)."""
    root = {"name": "root", "value": 0, "children": {}}
    for stack, n in folded.items():
        n = int(n)
        root["value"] += n
        node = root
        for part in stack.split(";"):
            child = node["children"].get(part)
            if child is None:
                child = node["children"][part] = {
                    "name": part, "value": 0, "children": {}}
            child["value"] += n
            node = child

    def _materialize(node):
        kids = [_materialize(c) for c in node["children"].values()]
        out = {"name": node["name"], "value": node["value"]}
        if kids:
            out["children"] = sorted(kids, key=lambda c: -c["value"])
        return out

    return _materialize(root)


def last_profiles(paths) -> dict[str, dict]:
    """{label: last "profile" event} across metrics JSONLs. Events are
    cumulative, so the LAST one per process stanza (a run_start opens a
    stanza) is that stanza's whole story; labels come from the
    run_start `replica` field, else the file stem (suffixed on
    collision so two unlabelled stanzas never silently merge)."""
    from shallowspeed_tpu_torch.telemetry.schema import parse_metrics_jsonl

    out: dict[str, dict] = {}
    for path in paths:
        stem = Path(path).stem
        label, last = stem, None

        def _flush():
            if last is None:
                return
            key, k = label, 1
            while key in out:
                k += 1
                key = f"{label}#{k}"
            out[key] = last

        for rec in parse_metrics_jsonl(path):
            ev = rec.get("event")
            if ev == "run_start":
                _flush()
                label, last = rec.get("replica") or stem, None
            elif ev == "profile":
                last = rec
        _flush()
    return out


def profile_main(paths, out=None, top: int = 10, echo=print) -> int:
    """``python -m shallowspeed_tpu_torch.telemetry --profile <log> [--out
    flame.json]``: reduce the "profile" events of one or more metrics
    JSONLs to a flamegraph JSON + a printed top-frames/phases summary.
    Exit 1 when no profile events exist (a profiled artifact that
    lost its events should fail the smoke, not print an empty tree)."""
    snaps = last_profiles(paths)
    if not snaps:
        echo(f"--profile: no 'profile' events in "
             f"{', '.join(str(p) for p in paths)}")
        return 1
    if len(snaps) == 1:
        merged = dict(next(iter(snaps.values())))
        merged.setdefault("folded", {})
        if merged.get("other"):
            merged["folded"] = dict(merged["folded"])
            merged["folded"][OTHER_KEY] = int(merged["other"])
    else:
        merged = merge_profiles(snaps)
    folded = merged.get("folded") or {}
    samples = int(merged.get("samples") or 0)
    echo(f"profile: {samples} samples over {len(snaps)} "
         f"stanza(s) [{', '.join(sorted(snaps))}]")
    phases = merged.get("phases") or {}
    tot = sum(phases.values()) or 1
    for ph, n in sorted(phases.items(), key=lambda kv: -kv[1]):
        echo(f"  phase {ph:<16} {n:>8}  {n / tot:6.1%}")
    for stack, n in sorted(folded.items(),
                           key=lambda kv: -kv[1])[:top]:
        leaf = stack.rsplit(";", 1)[-1]
        echo(f"  {n:>8}  {leaf}  [{stack[:90]}]")
    if out:
        tree = flame_tree(folded)
        tree["phases"] = {str(k): int(v) for k, v in phases.items()}
        tree["samples"] = samples
        Path(out).write_text(json.dumps(tree))
        echo(f"flamegraph JSON -> {out}")
    return 0
