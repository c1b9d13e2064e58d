"""The span tracer — low-overhead runtime tracing for the engines.

The port's copy of `shallowspeed_tpu/telemetry/trace.py`: the same
levels, events and files; the `spans` fence is a CUDA device
synchronize instead of `jax.block_until_ready`.

Design constraints, in order:

1. `off` must cost nothing: engines call `tracer().span(...)` on every
   step (the VM on every instruction), so the disabled path is one
   module-global read returning a shared no-op span. No buffers, no
   timestamps, and — critically — **no device fences**: the async
   dispatch pipeline the engines are built around is untouched
   (pinned by tests/test_torch_telemetry.py's fence tests).
2. `steps` records host wall-clock only. Spans are real (buffered,
   exported) but `Span.fence()` is a no-op, so queued device work is
   never drained — timestamps measure *dispatch*, and only log-point
   spans (which the drivers already synchronize) measure compute.
3. `spans` synchronizes, at span exit, every CUDA device that holds
   one of the tensors handed to `Span.fence()` (`torch.cuda.
   synchronize(dev)`: every stream of the device, so the side-stream
   buckets of `parallel/overlap.py` are inside the span too; an event
   on the current stream would not bracket them), so a span's duration
   brackets the DEVICE time of the work dispatched inside it. CPU
   tensors need no fence. This serializes dispatch at every phase
   boundary — the honest cost of attributable time; the README
   documents it as the measurement mode.

Export: one `spans.jsonl` line per closed span (append-streamed, so a
killed run keeps its trace) and a Chrome-trace `trace.json`
(`ph: "X"` complete events, microsecond timebase) written by `close()`
— loadable in Perfetto / chrome://tracing with no GPU tooling.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path

LEVELS = ("off", "steps", "spans")

# in-memory event buffer cap: the VM emits one span per pipeline
# instruction, so a long spans-level run would otherwise grow the
# buffer without bound — spans.jsonl streams EVERY event to disk and
# is the source of truth for trace.json; the buffer only serves
# same-process consumers (the bubble replay reads the last batch via
# `events_since`, far below this cap)
_BUF_CAP = 200_000


class _NullSpan:
    """Shared do-nothing span: the `off` fast path and the object
    returned for spans opened while tracing is disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, *arrays):
        return None

    def set(self, **attrs):
        return None


_NULL_SPAN = _NullSpan()

# phase hooks (round 17, telemetry/profiler.py): when a sampling
# profiler runs it installs a (push, pop) pair here and every span
# enter/exit feeds its NAME into the profiler's cross-thread phase
# registry — so samples landing inside a `step` span are attributable
# without the drivers changing. None when no profiler runs: the cost
# on the hot path is one module-global read per span.
PHASE_HOOKS = None


class Span:
    """One timed region. Duration covers enter -> exit; `fence(arrs)`
    marks arrays whose device completion the exit waits on (at the
    `spans` level only)."""

    __slots__ = ("_tr", "name", "attrs", "_t0", "_fences")

    def __init__(self, tr: "Tracer", name: str, attrs: dict):
        self._tr = tr
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._fences: tuple = ()

    def fence(self, *arrays) -> None:
        """Block the span exit on these arrays' device completion
        (`spans` level; no-op at `steps`). Call with the step's outputs
        so the span measures compute, not dispatch."""
        if self._tr.level == "spans":
            self._fences += arrays

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self._t0 = self._tr._clock()
        self._tr._thread_stack().append(self)
        if PHASE_HOOKS is not None:
            PHASE_HOOKS[0](self.name)
        return self

    def __exit__(self, *exc):
        tr = self._tr
        if PHASE_HOOKS is not None:
            PHASE_HOOKS[1](self.name)
        if tr.level == "spans" and self._fences:
            _block(self._fences)
        t1 = tr._clock()
        stack = tr._thread_stack()
        assert stack and stack[-1] is self, (
            "span nesting violated: exiting a span that is not the "
            "innermost open span")
        stack.pop()
        tr._record(self, self._t0, t1, depth=len(stack))
        return False


def _block(arrays):
    """Wait for the device work behind `arrays` (tensors, or trees of
    them: dicts, lists, tuples): one `torch.cuda.synchronize` per CUDA
    device among them. A failing synchronize raises."""
    import torch

    from shallowspeed_tpu_torch.weights import leaves

    devices = []
    for t in leaves(arrays):
        dev = getattr(t, "device", None)
        if isinstance(dev, torch.device) and dev.type == "cuda" \
                and dev not in devices:
            devices.append(dev)
    for dev in devices:
        torch.cuda.synchronize(dev)


class Tracer:
    """Buffering span recorder with streaming JSONL + Chrome export.

    Single-threaded by design (the engines dispatch from one Python
    thread); the lock only guards the JSONL append so background
    threads (prefetch, async save) may also emit spans.
    """

    def __init__(self, trace_dir=None, level: str = "off",
                 clock=time.perf_counter):
        assert level in LEVELS, f"level {level!r} not in {LEVELS}"
        self.level = level
        self.dir = Path(trace_dir) if trace_dir else None
        self._clock = clock
        self._epoch = clock()
        self._local = threading.local()  # per-thread span stacks
        self._events: deque = deque(maxlen=_BUF_CAP)
        self._seq = 0                    # total events ever emitted
        self._counters: dict[str, float] = {}
        # named tracks (round 13): explicit Chrome tids above the span
        # nesting depths, one per serving request — depth-tids stay
        # single digits, so the offset can never collide
        self._next_tid = 1000
        self._lock = threading.Lock()
        self._jsonl = None
        # span-event subscribers (round 12): the live monitor's
        # flight recorder rides here so the incident ring holds the
        # phase spans next to the metrics lines. Called under the
        # emit lock — keep them O(ring append) cheap.
        self.subscribers: list = []
        if self.dir is not None and level != "off":
            self.dir.mkdir(parents=True, exist_ok=True)
            # "w", not "a": each run owns its trace dir (appending a
            # second run would mix two ts epochs into one garbled
            # Perfetto timeline); per-line flushes still mean a killed
            # run keeps everything it emitted
            self._jsonl = (self.dir / "spans.jsonl").open("w")

    def _thread_stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ------------------------------------------------------------ spans

    def span(self, name: str, **attrs):
        """Open a span; use as a context manager. At `off` this returns
        a shared no-op object (zero allocation beyond the call)."""
        if self.level == "off":
            return _NULL_SPAN
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Zero-duration instant event (e.g. 'recompile', 'ckpt')."""
        if self.level == "off":
            return
        self._emit({"name": name, "ph": "i",
                    "ts": round((self._clock() - self._epoch) * 1e6, 1),
                    "args": attrs})

    def now(self) -> float:
        """This tracer's clock (perf_counter by default) — callers that
        record phase boundaries host-side and export them later via
        `complete` must stamp on THIS clock, not time.time."""
        return self._clock()

    def track(self, name: str) -> int:
        """Allocate a named Chrome-trace track and return its tid —
        one per serving request, so each request renders as its own
        named row in Perfetto next to the engine tick spans. Emits the
        thread_name metadata line; returns 0 (the shared depth track)
        when tracing is off."""
        if self.level == "off":
            return 0
        with self._lock:
            tid = self._next_tid
            self._next_tid += 1
        self._emit({"name": "thread_name", "ph": "M", "ts": 0.0,
                    "tid": tid, "args": {"name": name}})
        return tid

    def complete(self, name: str, t0: float, t1: float,
                 tid: int | None = None, **attrs) -> None:
        """Emit an already-closed span (ph "X") directly — the
        lifecycle path, where phase boundaries are recorded host-side
        as they happen and exported when the phase ENDS. `t0`/`t1` are
        on this tracer's clock (`now()`); `tid` targets a named track
        from `track()`."""
        if self.level == "off":
            return
        ev = {"name": name, "ph": "X",
              "ts": round((t0 - self._epoch) * 1e6, 1),
              "dur": round(max(0.0, t1 - t0) * 1e6, 1),
              "args": attrs}
        if tid is not None:
            ev["tid"] = tid
        self._emit(ev)

    def counter(self, name: str, value) -> None:
        """Monotonic/telemetry counter sample (recompiles, HBM bytes)."""
        if self.level == "off":
            return
        self._counters[name] = value
        self._emit({"name": name, "ph": "C",
                    "ts": round((self._clock() - self._epoch) * 1e6, 1),
                    "args": {"value": value}})

    def _record(self, span: Span, t0: float, t1: float, depth: int):
        self._emit({
            "name": span.name, "ph": "X",
            "ts": round((t0 - self._epoch) * 1e6, 1),
            "dur": round((t1 - t0) * 1e6, 1),
            "depth": depth,
            "args": span.attrs,
        })

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)
            self._seq += 1
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(ev) + "\n")
                self._jsonl.flush()
            for fn in self.subscribers:
                try:
                    fn(ev)
                except Exception:
                    pass  # a monitor bug must not kill the traced run

    # ----------------------------------------------------------- export

    @property
    def event_count(self) -> int:
        """Total events emitted so far (monotonic; survives buffer
        eviction — pair with `events_since` to read a window)."""
        return self._seq

    @property
    def events(self) -> list[dict]:
        """The buffered events (the most recent `_BUF_CAP`; the full
        stream lives in spans.jsonl). Snapshotted under the lock —
        background threads (prefetch, async save) may emit
        concurrently, and iterating a mutating deque raises."""
        with self._lock:
            return list(self._events)

    def events_since(self, seq: int) -> list[dict]:
        """Events emitted at or after sequence number `seq` (from
        `event_count`) that are still buffered — the O(window) way to
        read e.g. one batch's spans without rescanning the run."""
        with self._lock:
            buf = list(self._events)
            n_evicted = self._seq - len(buf)
        skip = max(0, seq - n_evicted)
        return buf[skip:] if skip else buf

    def spans_named(self, name: str) -> list[dict]:
        return [e for e in self.events
                if e.get("ph") == "X" and e["name"] == name]

    @staticmethod
    def _chrome_event(e: dict) -> dict:
        # explicit tid (a named lifecycle track) wins over the span
        # nesting depth
        ev = {"name": e["name"], "ph": e["ph"], "ts": e["ts"],
              "pid": 0, "tid": e.get("tid", e.get("depth", 0)),
              "args": e.get("args", {})}
        if e["ph"] == "X":
            ev["dur"] = e["dur"]
        return ev

    def chrome_trace(self) -> dict:
        """The trace in Chrome format (Perfetto-loadable). Sourced from
        the streamed spans.jsonl when a trace dir is configured (the
        COMPLETE stream — the RAM buffer is bounded), else from the
        buffer. Span depth maps to tid so nesting renders as the usual
        flame layout; attrs ride in `args`."""
        src: list = self.events
        if self.dir is not None:
            path = self.dir / "spans.jsonl"
            if path.exists():
                with self._lock:
                    if self._jsonl is not None:
                        self._jsonl.flush()
                src = [json.loads(line)
                       for line in path.read_text().splitlines()
                       if line.strip()]
        return {"traceEvents": [self._chrome_event(e) for e in src],
                "displayTimeUnit": "ms"}

    def close(self) -> None:
        """Flush the JSONL stream and write `trace.json` (Chrome)."""
        trace = (self.chrome_trace()
                 if self.dir is not None and self.level != "off"
                 else None)
        if self._jsonl is not None:
            with self._lock:
                self._jsonl.close()
                self._jsonl = None
        if trace is not None:
            (self.dir / "trace.json").write_text(json.dumps(trace))


# ------------------------------------------------------- global tracer

_TRACER = Tracer(level="off")


def configure(trace_dir=None, level: str = "off") -> Tracer:
    """Install (and return) the process-global tracer the engines emit
    into. Drivers call this once from the CLI flags; tests swap it
    freely (the previous tracer is closed)."""
    global _TRACER
    _TRACER.close()
    _TRACER = Tracer(trace_dir=trace_dir, level=level)
    return _TRACER


def tracer() -> Tracer:
    """The active process-global tracer (default: level 'off')."""
    return _TRACER
