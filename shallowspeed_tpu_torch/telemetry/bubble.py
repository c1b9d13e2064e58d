"""Pipeline bubble accounting — measured idle vs the verified schedule.

A copy of `shallowspeed_tpu/telemetry/bubble.py` over the port's own
`parallel/verify.py` and `parallel/schedules.py`;
`calibrate_compiled` fences its `eval_loss` calls with
`torch.cuda.synchronize` on the engine's cards instead of
`jax.block_until_ready`, and runs them under `torch.no_grad()`, drawing
no randomness that training draws, so the training trajectory is
unchanged bit for bit.

On one card every pipeline stage shares the card, which runs the
stages' work one after another: `trace_bubble` and `two_point_bubble`
then read that serialization, not a pipeline's fill and drain (on one
card `two_point_bubble`'s ramp sits near 0). The reported
`bubble_measured` is the costed replay's, as in the reference: the
measured per-op costs laid on the verified tables.

`parallel/verify.py` *proves* each schedule and measures its unit-cost
makespan; this module closes the loop at runtime:

- `static_bubble(schedule, n_mu, pp, vpp)` reads the bubble fraction
  off the SAME simulators the engines' tables come from (what the
  schedule promises under the unit-cost model).
- `replay_trace(ops)` REPLAYS an executed trace — per-op measured
  durations in per-stage executed order (the VM's fenced spans via
  `span_replay_ops`) — under dedicated-processor semantics honoring
  the pipeline dataflow dependencies, and reads the bubble off the
  replayed timeline. This is the executed-schedule-vs-makespan-tables
  comparison: wall-clock gaps are meaningless when a shared-core CPU
  host serializes "device" work, but the measured durations laid on
  the verified dependency structure are comparable to the unit-cost
  static fraction on any host.
- `costed_replay(...)` prices the verified placement (the SAME tables
  the compiled engines execute) with measured per-op costs;
  `calibrate_compiled` derives those costs from two fenced
  observations of the live engine (step spans + the pure-F eval
  program) without touching its training state.
- `trace_bubble(events)` is the raw wall-clock variant (busy vs
  window per stage) — honest only where stages own real devices.
- `two_point_bubble(t1, t2)` is the model-free hardware measurement:
  step time at n_mu and at 2x n_mu with the same per-microbatch shape
  (`make_calibration_twin`); the ramp 2*t1 - t2 is the fill/drain
  cost. Exact for any F:B ratio on dedicated devices; the driver uses
  the costed replay and leaves this one for on-chip benches.

The bubble FRACTION definition is shared throughout: idle device-
rounds inside the step window over total device-rounds,
`1 - work / (makespan * n_stages)` — so measured and static numbers
are directly comparable (the acceptance gate: within 5 points).
"""

from __future__ import annotations

import numpy as np


def static_bubble(schedule: str, n_mu: int, pp: int,
                  vpp: int = 1) -> dict:
    """The unit-cost bubble fraction of a verified schedule instance.

    schedule: 'gpipe' | '1f1b' | 'zb' (vpp > 1 selects the interleaved
    1F1B tables, matching PipelineLMEngine's routing). Returns
    {schedule, n_mu, pp, vpp, makespan, work_rounds, bubble_fraction}.
    Work is per-stage compute rounds: 2*n_mu for gpipe/1f1b (F=B=1 in
    `verify.simulate`'s round model), 2*n_mu*vpp chunk-rounds
    interleaved, 3*n_mu for zb (F=B=W=1).
    """
    from shallowspeed_tpu_torch.parallel import verify

    assert pp >= 1 and n_mu >= 1 and vpp >= 1
    if pp == 1:
        # no pipeline, no bubble — the degenerate anchor the pp=1
        # drivers report
        return {"schedule": schedule, "n_mu": n_mu, "pp": 1, "vpp": vpp,
                "makespan": 2 * n_mu, "work_rounds": 2 * n_mu,
                "bubble_fraction": 0.0}
    if schedule == "zb":
        # the compiled zb engine executes zb_tables verbatim, whose
        # round count IS simulate_zb's verified makespan
        rep = verify.simulate_zb(n_mu, pp)
        makespan, work = rep.makespan, 3 * n_mu
    elif vpp > 1:
        # ditto: the interleaved engine follows interleaved_tables
        rep = verify.simulate_interleaved(n_mu, pp, vpp)
        makespan, work = rep.makespan, 2 * n_mu * vpp
    elif schedule in ("gpipe", "1f1b", "pipedream"):
        # the compiled engines run 2*(n_mu + pp - 1) compute ticks
        # (pipeline_lm's fwd/bwd tick scans; the 1F1B slot algebra has
        # the same span) — the closed form `verify.simulate`'s round
        # model documents. The simulator itself is still run as the
        # schedule PROOF, but its literal round count defers each
        # zero-cost send to the next round (+~1 bookkeeping round per
        # hop no engine executes), so the tick count is the honest
        # makespan for measured-vs-static comparison; the simulator's
        # is reported alongside as `sim_makespan`.
        from shallowspeed_tpu_torch.parallel import schedules

        cls = {"gpipe": schedules.GPipeSchedule,
               "1f1b": schedules.PipeDreamSchedule,
               "pipedream": schedules.PipeDreamSchedule}[schedule]
        rep = verify.simulate(cls, n_mu, pp)  # raises if not sound
        makespan, work = 2 * (n_mu + pp - 1), 2 * n_mu
        return {"schedule": schedule, "n_mu": n_mu, "pp": pp,
                "vpp": vpp, "makespan": makespan,
                "sim_makespan": rep.makespan, "work_rounds": work,
                "bubble_fraction": round(1.0 - work / makespan, 4)}
    elif schedule == "naive":
        from shallowspeed_tpu_torch.parallel import schedules

        rep = verify.simulate(schedules.NaiveParallelSchedule, n_mu, pp)
        makespan, work = rep.makespan, 2 * n_mu
    else:
        raise AssertionError(f"unknown schedule {schedule!r}")
    return {"schedule": schedule, "n_mu": n_mu, "pp": pp, "vpp": vpp,
            "makespan": makespan, "work_rounds": work,
            "bubble_fraction": round(1.0 - work / (makespan * 1.0), 4)}


def trace_bubble(events) -> dict:
    """Measured bubble fraction from an executed schedule trace.

    events: iterable of dicts with at least {"stage", "ts", "dur"}
    (the pipeline VM's per-op spans: ts/dur in any consistent unit) —
    or (stage, ts, dur) tuples. The step window is [min ts, max ts+dur]
    over ALL stages (the pipeline drains as a unit); each stage's idle
    time inside that window is window - sum(dur). Returns
    {window, busy, per_stage_busy, bubble_fraction}.
    """
    per_stage: dict[int, float] = {}
    t_lo, t_hi = float("inf"), float("-inf")
    for ev in events:
        if isinstance(ev, dict):
            s, ts, dur = ev["stage"], ev["ts"], ev["dur"]
        else:
            s, ts, dur = ev
        per_stage[s] = per_stage.get(s, 0.0) + dur
        t_lo = min(t_lo, ts)
        t_hi = max(t_hi, ts + dur)
    assert per_stage, "trace_bubble needs at least one op event"
    window = t_hi - t_lo
    n_stages = len(per_stage)
    busy = sum(per_stage.values())
    frac = (0.0 if window <= 0.0
            else max(0.0, 1.0 - busy / (window * n_stages)))
    return {"window": window, "busy": busy,
            "per_stage_busy": dict(sorted(per_stage.items())),
            "n_stages": n_stages,
            "bubble_fraction": round(frac, 4)}


# ---------------------------------------------------- executed replay


def replay_trace(ops, pp: int | None = None) -> dict:
    """Replay an executed schedule trace under dedicated-processor
    semantics and report its measured bubble fraction.

    ops: (kind, stage, mu, dur[, proc]) tuples in per-processor
    executed order, kind in "F"/"B"/"W" — measured durations (the VM's
    fenced per-op spans, or a costed static placement from
    `costed_replay`). `stage` is the DATAFLOW stage (logical stage for
    interleaved schedules); `proc` is the executing device and
    defaults to the stage (they differ only under vpp, where device d
    hosts logical stages {d, d+pp, ...} and serializes their chunks in
    the greedy table's round order). The replay honors each
    processor's executed op ORDER plus the pipeline dataflow
    dependencies (F(s,m) after F(s-1,m); B(s,m) after F(s,m) and
    B(s+1,m); W(s,m) after B(s,m)) and gives every processor its own
    timeline — which is exactly what "replaying against verify.py's
    makespan model" means: the measured per-op times are laid out on
    the schedule's dependency structure, so the bubble read off the
    replayed timeline is comparable to the unit-cost static fraction
    even when the host serializes execution (a shared-core CPU mesh
    can never show the fill/drain ramp in wall-clock).

    `pp` is the pipeline's processor count when known: a trace with
    MORE processors than that is rejected (mislabeled ops), and one
    with fewer — a partial capture — counts the missing processors as
    fully idle instead of silently reporting a shallower pipeline.
    Duplicate (kind, stage, mu) ops are rejected outright: a sound
    single-batch trace executes each op once, and a duplicate means
    the caller mixed batches/epochs into one window.
    """
    per_proc: dict[int, list] = {}
    stages: set = set()
    seen_ops: set = set()
    for op in ops:
        kind, s, m, dur = op[:4]
        if (kind, s, m) in seen_ops:
            raise ValueError(
                f"duplicate op {(kind, s, m)} in trace — the window "
                f"mixes more than one batch/epoch of spans")
        seen_ops.add((kind, s, m))
        proc = op[4] if len(op) > 4 else s
        stages.add(s)
        per_proc.setdefault(proc, []).append((kind, s, m, float(dur)))
    n_procs = len(per_proc)
    assert n_procs >= 1, "replay_trace needs at least one op"
    if pp is not None:
        if n_procs > pp:
            raise ValueError(
                f"trace names {n_procs} processors but the pipeline "
                f"has {pp} — op attribution is mislabeled")
        n_procs = pp  # absent processors were idle the whole window
    pcs = {p: 0 for p in per_proc}
    free = {p: 0.0 for p in per_proc}
    done: dict[tuple, float] = {}
    busy = {p: 0.0 for p in per_proc}
    remaining = sum(len(v) for v in per_proc.values())

    def deps(kind, s, m):
        if kind == "F":
            return [("F", s - 1, m)] if (s - 1) in stages else []
        if kind == "B":
            out = [("F", s, m)]
            if (s + 1) in stages:
                out.append(("B", s + 1, m))
            return out
        return [("B", s, m)]  # W

    while remaining:
        progressed = False
        for p, prog in per_proc.items():
            while pcs[p] < len(prog):
                kind, s, m, dur = prog[pcs[p]]
                need = deps(kind, s, m)
                if any(d not in done for d in need):
                    break
                start = max([free[p]] + [done[d] for d in need])
                done[(kind, s, m)] = start + dur
                free[p] = start + dur
                busy[p] += dur
                pcs[p] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            stuck = {p: per_proc[p][pcs[p]] for p in per_proc
                     if pcs[p] < len(per_proc[p])}
            raise ValueError(
                f"executed trace violates pipeline dataflow (missing "
                f"producers for {stuck}) — not a sound schedule trace")
    makespan = max(done.values())
    total_busy = sum(busy.values())
    frac = max(0.0, 1.0 - total_busy / (makespan * n_procs))
    return {"makespan": makespan, "busy": total_busy,
            "per_stage_busy": {p: round(b, 6)
                               for p, b in sorted(busy.items())},
            "n_stages": n_procs, "bubble_fraction": round(frac, 4)}


def _placement(schedule: str, n_mu: int, pp: int, vpp: int = 1) -> list:
    """The verified schedule's op placement as per-processor-ordered
    (kind, stage, mu[, proc]) tuples — the same tables the compiled
    engines execute (verify.py's greedy/zb tables for vpp/zb; the tick
    algebra pipeline_lm compiles for gpipe/1f1b). The proc column
    appears only for vpp, where devices host several logical stages."""
    from shallowspeed_tpu_torch.parallel import verify

    ops: list = []
    if schedule == "zb":
        starts = verify.simulate_zb(n_mu, pp).op_rounds
        for (kind, l, m), r in sorted(starts.items(),
                                      key=lambda kv: kv[1]):
            ops.append((kind, l, m))
    elif vpp > 1:
        placed, _, _, _, _ = verify._greedy_interleaved(n_mu, pp, vpp)
        # dataflow deps run over LOGICAL stages; device d executes its
        # vpp chunks serially in the greedy table's round order — the
        # explicit proc column models that contention in the replay
        for (r, d), (kind, ls, m) in sorted(placed.items()):
            ops.append((kind, ls, m, d))
    elif schedule in ("gpipe", "naive"):
        for s in range(pp):
            for m in range(n_mu):
                ops.append(("F", s, m))
            for m in reversed(range(n_mu)):
                ops.append(("B", s, m))
    elif schedule in ("1f1b", "pipedream"):
        for s in range(pp):
            warm = min(pp - s - 1, n_mu)
            seq = [("F", s, m) for m in range(warm)]
            for i in range(n_mu - warm):
                seq.append(("F", s, warm + i))
                seq.append(("B", s, i))
            seq += [("B", s, m) for m in range(n_mu - warm, n_mu)]
            ops.extend(seq)
    else:
        raise AssertionError(f"unknown schedule {schedule!r}")
    return ops


def costed_replay(schedule: str, n_mu: int, pp: int, vpp: int = 1,
                  c_f: float = 1.0, c_b: float = 1.0,
                  c_w: float = 1.0) -> dict:
    """Replay the verified placement with MEASURED per-op costs: the
    bubble fraction of the executed tables priced at what F/B/W
    actually cost on this hardware (equals `static_bubble` at unit
    costs; moves with the real F:B ratio for the slot-scheduled
    1f1b/vpp/zb families)."""
    cost = {"F": c_f, "B": c_b, "W": c_w}
    ops = [(it[0], it[1], it[2], cost[it[0]], *it[3:])
           for it in _placement(schedule, n_mu, pp, vpp)]
    return replay_trace(ops, pp)


def span_ops(events, names=("Forward", "BackwardGradAcc",
                            "BackwardGradAllReduce"),
             batch=None) -> list:
    """Tracer span events -> (stage, ts, dur) op tuples for
    `trace_bubble` (the pipeline VM's executed-schedule trace; filter
    to one batch with `batch=`)."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e["name"] not in names:
            continue
        args = e.get("args", {})
        if "stage" not in args:
            continue
        if batch is not None and args.get("batch") != batch:
            continue
        out.append((args["stage"], e["ts"], e["dur"]))
    return out


_KIND_OF = {"Forward": "F", "BackwardGradAcc": "B",
            "BackwardGradAllReduce": "B"}


def span_replay_ops(events, batch=None) -> list:
    """Tracer span events -> (kind, stage, mu, dur_us) tuples in
    executed order for `replay_trace` (the VM's fenced per-op spans;
    filter to one batch with `batch=`)."""
    out = []
    for e in events:
        kind = _KIND_OF.get(e.get("name"))
        if e.get("ph") != "X" or kind is None:
            continue
        args = e.get("args", {})
        if "stage" not in args or "mu" not in args:
            continue
        if batch is not None and args.get("batch") != batch:
            continue
        out.append((kind, args["stage"], args["mu"], e["dur"]))
    return out


def calibrate_compiled(engine, tracer, tokens, targets,
                       reps: int = 3) -> dict | None:
    """Measured-bubble calibration for a pipeline engine whose per-op
    timing the step span does not split (`PipelineLMEngine`: one "step"
    span over the whole schedule).

    Measured inputs (training trajectory untouched):
    - t_step: median of the live engine's already-recorded fenced
      "step" spans (the `spans` level fences each step);
    - t_eval: a few fenced `eval_loss` calls — the eval is the pure-F
      pipeline, so c_F = t_eval / (n_mu + pp - 1) fwd ticks. They run
      under `torch.no_grad()` and draw no randomness (no dropout in
      eval), and `eval_loss` updates nothing.

    For gpipe/1f1b, c_B is the residual per-tick cost
    (t_step / ticks - c_F, each engine running 2*(n_mu + pp - 1)
    one-op ticks per device); zb and interleaved vpp replay at uniform
    per-round cost t_step / makespan (zb's F≈B≈W is the schedule's own
    design assumption). The verified placement — the SAME tables the
    engine executes — is then replayed at those costs
    (`costed_replay`), and the replayed timeline's idle fraction is
    the measured bubble. For gpipe the fraction is F:B-ratio-invariant
    (fill and drain scale together), so measured≈static certifies the
    executed structure; for the slot-scheduled families the measured
    ratio genuinely moves the number.

    Returns {bubble_static, bubble_measured, bubble_detail} or None
    when fewer than 2 step spans after the first (which holds the
    kernels' first-use build) exist yet (call again at a later log
    point).
    """
    import time

    import numpy as np
    import torch

    info = engine.schedule_info()
    schedule, n_mu, pp, vpp = (info["schedule"], info["n_mu"],
                               info["pp"], info["vpp"])
    static = static_bubble(schedule, n_mu, pp, vpp)
    spans = tracer.spans_named("step")[1:]  # [0] includes the build
    if len(spans) < 2:
        return None
    t_step = float(np.median([s["dur"] for s in spans])) / 1e6
    cards = [d for d in engine_devices(engine) if d.type == "cuda"]

    def fence():
        for d in cards:
            torch.cuda.synchronize(d)

    with tracer.span("bubble_calibration", schedule=schedule), \
            torch.no_grad():
        engine.eval_loss(tokens, targets)  # warm-up (excluded)
        evals = []
        for _ in range(max(reps, 2)):
            fence()
            t0 = time.perf_counter()
            engine.eval_loss(tokens, targets)
            fence()
            evals.append(time.perf_counter() - t0)
    t_eval = float(np.median(evals))

    ticks = n_mu + pp - 1
    if schedule in ("gpipe", "1f1b") and vpp == 1:
        # both engines run `ticks` F-ticks + `ticks` B-ticks per device:
        # t_step = ticks * (c_f + c_b), with c_f measured off the eval
        # (pure-F) pass — c_b is the residual
        c_f = t_eval / ticks
        c_b = max(t_step / ticks - c_f, c_f * 0.1)
        rep = costed_replay(schedule, n_mu, pp, vpp, c_f=c_f, c_b=c_b)
    else:
        c = t_step / static["makespan"]
        c_f = c_b = c
        rep = costed_replay(schedule, n_mu, pp, vpp, c_f=c, c_b=c,
                            c_w=c)
    return {
        "bubble_static": static["bubble_fraction"],
        "bubble_measured": rep["bubble_fraction"],
        "bubble_detail": {**static,
                          "measured_makespan_s": round(rep["makespan"],
                                                       6),
                          "t_step": round(t_step, 6),
                          "t_eval": round(t_eval, 6),
                          "c_f": round(c_f, 6), "c_b": round(c_b, 6)},
    }


def engine_cells(engine) -> list:
    """This process's cells of the engine's grid, one entry a cell
    (`engine.mesh`: an object array of devices or a named `Grid`;
    another process's cells are left out; `engine.devices` or
    `engine.device` for an engine without a grid)."""
    import torch

    mesh = getattr(engine, "mesh", None)
    if mesh is None:
        cells = getattr(engine, "devices", None) or [engine.device]
    else:
        cells = getattr(mesh, "devices", mesh)
    return [d for d in np.asarray(cells, dtype=object).ravel()
            if isinstance(d, torch.device)]


def engine_devices(engine) -> list:
    """The distinct torch devices of `engine_cells(engine)`."""
    out: list = []
    for d in engine_cells(engine):
        if d not in out:
            out.append(d)
    return out


def two_point_bubble(t1: float, t2: float) -> dict:
    """Measured bubble fraction from two fenced step timings: t1 = the
    live engine at n_mu, t2 = the calibration twin at 2*n_mu with the
    SAME per-microbatch shape (global batch doubled). The ideal step
    time at n_mu is t2 - t1; the ramp (fill + drain) is 2*t1 - t2.
    Negative ramp (timing noise on a bubble-free engine) clamps to 0.
    """
    assert t1 > 0 and t2 > 0, (t1, t2)
    ideal = t2 - t1
    ramp = 2.0 * t1 - t2
    frac = min(1.0, max(0.0, ramp / t1))
    return {"t_step": t1, "t_step_2x": t2, "t_ideal": max(ideal, 0.0),
            "t_ramp": max(ramp, 0.0), "bubble_fraction": round(frac, 6)}
