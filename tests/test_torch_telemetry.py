"""The port's telemetry core (`shallowspeed_tpu_torch/telemetry/`)
against the JAX package's on the CPU: the copied pure modules (schema,
sketch, regress, tracing) are the reference's text and answer as it
does; the profiler's reductions, `MemoryWatch`'s verdicts and the
request helpers equal the reference's on the same inputs; the tracer's
levels, events and files; the memory registry's per-storage accounting;
the run-time collective counters; `RunTelemetry`'s fields; the CLI and
the package's lazy names. The reference's walker-importing modules
(`report`, `tracing`) come in through the `ref_telemetry` fixture
(tests/torch_parity.py), and none of their walker outputs is an
oracle."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from shallowspeed_tpu.telemetry import memory as JM
from shallowspeed_tpu.telemetry import profiler as JP
from shallowspeed_tpu.telemetry import regress as JR
from shallowspeed_tpu.telemetry import schema as JS
from shallowspeed_tpu.telemetry import sketch as JK
from shallowspeed_tpu_torch import telemetry as PT
from shallowspeed_tpu_torch.telemetry import __main__ as cli
from shallowspeed_tpu_torch.telemetry import collectives as C
from shallowspeed_tpu_torch.telemetry import memory as M
from shallowspeed_tpu_torch.telemetry import profiler as P
from shallowspeed_tpu_torch.telemetry import regress as R
from shallowspeed_tpu_torch.telemetry import report as REP
from shallowspeed_tpu_torch.telemetry import schema as S
from shallowspeed_tpu_torch.telemetry import sketch as K
from shallowspeed_tpu_torch.telemetry import trace as TR
from shallowspeed_tpu_torch.telemetry import tracing as TC
from tests.torch_parity import ref_telemetry  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts and ends with the tracer off and no owners."""
    TR.configure()
    M.clear_owners()
    yield
    TR.configure()
    M.clear_owners()


# ------------------------------------------------------------ the copies


# the copies' one rewording: the schema's version history names its
# first dialect without the reference's change number
REWORDED = {"schema": [("1 = PR-2 (spans +", "1 = the first (spans +"),
                       ("2 = PR-2 plus", "2 = v1 plus")]}


@pytest.mark.parametrize("name", ["schema", "sketch", "regress", "tracing"])
def test_pure_modules_are_the_references_text(name):
    """The copied modules are the reference's source but for the package
    name, the note that says they are copies, and `REWORDED`."""
    port = (ROOT / "shallowspeed_tpu_torch/telemetry" / f"{name}.py"
            ).read_text()
    ref = (ROOT / "shallowspeed_tpu/telemetry" / f"{name}.py").read_text()
    for old, new in REWORDED.get(name, []):
        assert old in ref
        ref = ref.replace(old, new)
    note = (f"\n\nA copy of `shallowspeed_tpu/telemetry/{name}.py` (pure "
            "Python; the\nport keeps its own copy rather than import the JAX "
            "package).")
    assert note in port
    assert port.replace(note, "", 1) == ref.replace(
        "shallowspeed_tpu.telemetry", "shallowspeed_tpu_torch.telemetry")


LINES = [
    {"event": "run_start", "schema_version": 15},
    {"event": "run_start", "schema_version": 0},
    {"event": "step", "step": 3, "loss": 1.5, "tokens_per_sec": 10.0,
     "hbm_owned_mib": {"train.params": 1.0}, "coll_bytes_per_step": 8},
    {"event": "step", "step": 3, "loss": 1.5, "tokens_per_sec": 10.0,
     "coll_bytes_per_step": 8.5},
    {"event": "step", "step": "3", "loss": 1.5},
    {"event": "profile", "samples": 4, "folded": {"a;b": 4}},
    {"event": "nope"},
    {"name": "step", "ph": "X", "ts": 1.0, "dur": 2.0, "args": {}},
    {"name": "step", "ph": "X", "ts": 1.0},
    {"name": "thread_name", "ph": "M", "ts": 0.0, "args": {"name": "r"}},
    {"neither": 1},
]


@pytest.mark.parametrize("i", range(len(LINES)))
def test_schema_lines_as_the_reference_judges_them(i):
    assert S.SCHEMA_VERSION == JS.SCHEMA_VERSION == 15
    assert S.validate_line(LINES[i]) == JS.validate_line(LINES[i])


def test_sketch_quantiles_merges_and_events_equal_the_references():
    rng = np.random.default_rng(3)
    a, b = rng.lognormal(2, 1, 500), rng.lognormal(1, 2, 300)
    hp, hj = K.LogHistogram(), JK.LogHistogram()
    for x in a:
        hp.add(float(x))
        hj.add(float(x))
    hp2, hj2 = K.LogHistogram(), JK.LogHistogram()
    for x in b:
        hp2.add(float(x))
        hj2.add(float(x))
    hp.merge(hp2)
    hj.merge(hj2)
    for q in (0, 1, 25, 50, 90, 95, 99, 100):
        assert hp.quantile(q) == hj.quantile(q)
    assert hp.to_dict() == hj.to_dict()
    mp, mj = K.MetricSketches(), JK.MetricSketches()
    for x in a[:50]:
        mp.observe("step_ms", float(x))
        mj.observe("step_ms", float(x))
    mp.observe("ttft_ms", 3.0, count=4)
    mj.observe("ttft_ms", 3.0, count=4)
    assert mp.to_dict() == mj.to_dict() and mp.summary() == mj.summary()
    merged = K.MetricSketches().merge_dict(mp.to_dict()).merge_dict(
        mp.to_dict())
    jmerged = JK.MetricSketches().merge_dict(mj.to_dict()).merge_dict(
        mj.to_dict())
    assert merged.to_dict() == jmerged.to_dict()
    assert merged.quantile("step_ms", 95) == mp.quantile("step_ms", 95)


def _bench(tmp_path, values):
    for i, v in enumerate(values, 1):
        (tmp_path / f"BENCH_r{i:02d}.json").write_text(json.dumps(
            {"samples_per_sec": v, "transformer_mfu": v / 1e5}))
    return sorted(tmp_path.glob("BENCH_r*.json"))


@pytest.mark.parametrize("values", [[100.0, 101.0, 99.0, 100.5],
                                    [100.0, 101.0, 99.0, 60.0],
                                    [100.0]])
def test_regress_verdicts_equal_the_references(tmp_path, values):
    paths = _bench(tmp_path, values)
    mine, ref = R.load_trajectory(paths), JR.load_trajectory(paths)
    assert mine == ref
    assert R.check_trajectory(mine) == JR.check_trajectory(ref)
    assert R.main(paths) == JR.main(paths)


# --------------------------------------------------------- the stitcher

T2 = "b" * 32
TR_ID = "c" * 32
APPENDED = {
    "router": [
        {"event": "run_start", "kind": "router", "schema_version": 11,
         "wall": 1000.0, "mono": 5000.0},
        {"event": "route", "id": "a", "trace": "a" * 32, "span": "s1",
         "parent": "p1", "replica": "r1", "wall": 1000.1, "mono": 5000.1,
         "dispatch_wall": 1000.09, "dispatch_mono": 5000.09,
         "wait_ms": 100.0},
        {"event": "request", "id": "a", "trace": "a" * 32, "span": "p1",
         "tokens_in": 4, "tokens_out": 4, "e2e_ms": 500.0,
         "ttft_ms": 250.0, "wall": 1000.6, "mono": 5000.6},
        {"event": "run_start", "kind": "router", "schema_version": 11,
         "wall": 2000.0, "mono": 100.0},
        {"event": "route", "id": "b", "trace": T2, "span": "s2",
         "parent": "p2", "replica": "r1", "wall": 2000.1, "mono": 100.1,
         "dispatch_wall": 2000.09, "dispatch_mono": 100.09,
         "wait_ms": 100.0},
        {"event": "request", "id": "b", "trace": T2, "span": "p2",
         "tokens_in": 4, "tokens_out": 4, "e2e_ms": 700.0,
         "ttft_ms": 300.0, "wall": 2000.7, "mono": 100.7}],
    "replica_r1": [
        {"event": "run_start", "replica": "r1", "schema_version": 11,
         "wall": 2000.0, "mono": 30.0},
        {"event": "lifecycle", "id": "b", "trace": T2, "span": "e1",
         "attempt": 0, "phase": "submit", "seq": 0, "wall": 2000.095,
         "mono": 30.095},
        {"event": "lifecycle", "id": "b", "trace": T2, "span": "e1",
         "attempt": 0, "phase": "decoding", "seq": 1, "prev": "submit",
         "ms_in_prev": 205.0, "wall": 2000.3, "mono": 30.3},
        {"event": "lifecycle", "id": "b", "trace": T2, "span": "e1",
         "attempt": 0, "phase": "finished", "seq": 2, "prev": "decoding",
         "ms_in_prev": 300.0, "wall": 2000.6, "mono": 30.6}],
}
FAILOVER = {
    "router": [
        {"event": "run_start", "kind": "router", "schema_version": 11,
         "wall": 100.0, "mono": 100.0},
        {"event": "route", "id": "q", "trace": TR_ID, "span": "s0",
         "parent": "p0", "replica": "rA", "wall": 100.1, "mono": 100.1,
         "dispatch_wall": 100.09, "dispatch_mono": 100.09,
         "wait_ms": 100.0},
        {"event": "failover", "id": "q", "trace": TR_ID, "span": "s1",
         "parent": "p0", "replica": "rB", "attempt": 1,
         "reason": "timeout", "from": "rA", "tokens_done": 1,
         "wall": 102.0, "mono": 102.0, "dispatch_wall": 101.99,
         "dispatch_mono": 101.99},
        {"event": "request", "id": "q", "trace": TR_ID, "span": "p0",
         "tokens_in": 4, "tokens_out": 4, "e2e_ms": 3000.0,
         "ttft_ms": 500.0, "wall": 103.0, "mono": 103.0}],
    "rep_a": [
        {"event": "run_start", "replica": "rA", "schema_version": 11,
         "wall": 100.0, "mono": 100.0},
        {"event": "lifecycle", "id": "q", "trace": TR_ID, "attempt": 0,
         "phase": "submit", "seq": 0, "wall": 100.095, "mono": 100.095},
        {"event": "lifecycle", "id": "q", "trace": TR_ID, "attempt": 0,
         "phase": "decoding", "seq": 1, "prev": "submit",
         "ms_in_prev": 205.0, "wall": 100.3, "mono": 100.3},
        {"event": "lifecycle", "id": "q", "trace": TR_ID, "attempt": 0,
         "phase": "finished", "seq": 2, "prev": "decoding",
         "ms_in_prev": 3200.0, "wall": 103.5, "mono": 103.5}],
    "rep_b": [
        {"event": "run_start", "replica": "rB", "schema_version": 11,
         "wall": 100.0, "mono": 100.0},
        {"event": "lifecycle", "id": "q", "trace": TR_ID, "attempt": 1,
         "phase": "submit", "seq": 0, "resumed": 1, "wall": 101.995,
         "mono": 101.995},
        {"event": "lifecycle", "id": "q", "trace": TR_ID, "attempt": 1,
         "phase": "decoding", "seq": 1, "prev": "submit",
         "ms_in_prev": 205.0, "wall": 102.2, "mono": 102.2},
        {"event": "lifecycle", "id": "q", "trace": TR_ID, "attempt": 1,
         "phase": "finished", "seq": 2, "prev": "decoding",
         "ms_in_prev": 700.0, "wall": 102.9, "mono": 102.9}],
}


def _write_logs(tmp_path, logs) -> list:
    paths = []
    for name, recs in logs.items():
        p = tmp_path / f"{name}.jsonl"
        p.write_text("".join(json.dumps(r) + "\n" for r in recs))
        paths.append(p)
    return paths


@pytest.mark.parametrize("logs", [APPENDED, FAILOVER],
                         ids=["appended", "failover"])
def test_stitch_equals_the_references(tmp_path, ref_telemetry, logs):
    """`stitch`, its journeys' waterfalls, `goodput_block` and the CLI's
    Chrome trace on logs the test writes: the reference's, value for
    value."""
    import importlib

    jtc = importlib.import_module("shallowspeed_tpu.telemetry.tracing")
    jrep = importlib.import_module("shallowspeed_tpu.telemetry.report")
    paths = _write_logs(tmp_path, logs)
    mine, ref = TC.stitch(paths), jtc.stitch(paths)
    assert json.loads(json.dumps(mine, default=str)) == json.loads(
        json.dumps(ref, default=str))
    for tid, jn in mine["journeys"].items():
        assert REP.request_waterfall(jn) == jrep.request_waterfall(
            ref["journeys"][tid])
    assert TC.goodput_block(paths) == jtc.goodput_block(paths)
    assert TC.format_stitch(mine) == jtc.format_stitch(ref)
    if logs is FAILOVER:
        wf = REP.request_waterfall(mine["journeys"][TR_ID])
        assert wf["rq_unexplained_ms"] == pytest.approx(0.0, abs=1.0)
        assert wf["rq_decode_ms"] == pytest.approx(2395.0, abs=2.0)
    out = tmp_path / "st.json"
    assert cli.main(["--stitch", *map(str, paths), "--out", str(out)]) == 0
    assert json.loads(out.read_text())["traceEvents"]


def test_request_helpers_equal_the_references(tmp_path, ref_telemetry):
    import importlib

    jrep = importlib.import_module("shallowspeed_tpu.telemetry.report")
    for n in (0, 1, 18, 31):
        for q in (0, 50, 95, 100):
            assert REP.percentile(range(n), q) == jrep.percentile(range(n), q)
    recs = [{"ttft_ms": float(i), "tpot_ms": i / 3, "tokens_in": i,
             "tokens_out": 2 * i, "preempted": i % 2} for i in range(9)]
    assert REP.request_summary(recs) == jrep.request_summary(recs)
    assert REP.request_summary([]) is None
    path = _write_logs(tmp_path, {"r": FAILOVER["rep_a"] + FAILOVER["rep_b"]})
    assert REP.request_timeline(path[0]) == jrep.request_timeline(path[0])


# ---------------------------------------------------------- the profiler

SNAPS = {"r0": {"samples": 10, "step_samples": 6, "other": 2,
                "folded": {"a;b": 5, "a;c": 3},
                "phases": {"step": 6, "(untagged)": 4}},
         "r1": {"samples": 4, "step_samples": 1,
                "folded": {"a;b": 4}, "phases": {"grads": 1, "x": 3}}}


def test_profile_reductions_equal_the_references(tmp_path, capsys):
    assert P.merge_profiles(SNAPS) == JP.merge_profiles(SNAPS)
    folded = P.merge_profiles(SNAPS)["folded"]
    assert P.flame_tree(folded) == JP.flame_tree(folded)
    log = tmp_path / "m.jsonl"
    log.write_text("\n".join(json.dumps(r) for r in [
        {"event": "run_start", "replica": "r0"},
        {"event": "profile", **SNAPS["r0"]},
        {"event": "run_start"},
        {"event": "profile", **SNAPS["r1"]}]))
    assert P.last_profiles([log]) == JP.last_profiles([log])
    outs = []
    for fn in (P.profile_main, JP.profile_main):
        lines = []
        out = tmp_path / f"flame_{len(outs)}.json"
        assert fn([log], out=str(out), echo=lines.append) == 0
        outs.append((lines[:-1], json.loads(out.read_text())))
    assert outs[0] == outs[1]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert P.profile_main([empty], echo=lambda s: None) == 1
    assert cli.main(["--profile", str(log)]) == 0
    assert "profile: 14 samples" in capsys.readouterr().out


def test_sampler_attributes_samples_to_the_tracers_spans():
    """While a profiler runs, the port tracer's spans feed its phase
    registry (`trace.PHASE_HOOKS`): a sample taken inside "grads" inside
    "step" is tagged "grads" and counted in-step; the hooks go with the
    last profiler."""
    prof = P.SamplingProfiler(hz=1.0)
    prof.start()
    try:
        assert TR.PHASE_HOOKS is not None
        tr = TR.configure(level="steps")
        seen = {}
        with tr.span("step", step=0):
            with tr.span("grads", step=0):
                t = threading.Thread(target=prof.sample_once)
                t.start()
                t.join()
                seen["tag"] = P._tags_of(threading.get_ident())
        snap = prof.snapshot()
    finally:
        prof.stop()
    assert seen["tag"] == ("grads", True)
    assert snap["phases"].get("grads") == 1 and snap["step_samples"] == 1
    assert TR.PHASE_HOOKS is None


def test_capture_window_writes_its_dump(tmp_path):
    win = P.CaptureWindow(out_dir=tmp_path, duration_s=0.05, hz=200.0,
                          cooldown_s=0.0)
    assert win.arm("fault:stall", step=3)
    assert not win.arm("fault:stall", step=3)          # deduped
    win.wait()
    rec = json.loads((tmp_path / "profcap_3.json").read_text())
    assert rec["reason"] == "fault:stall" and rec["samples"] >= 1


def test_device_trace_ctx_writes_a_chrome_trace_per_process(tmp_path):
    with P.device_trace_ctx(tmp_path / "prof"):
        assert P._device_trace_active()
        torch.ones(8) @ torch.ones(8)
    assert not P._device_trace_active()
    path = P.trace_file(tmp_path / "prof")
    assert path.name == "trace_p0.json"
    assert json.loads(path.read_text())["traceEvents"]
    with P.device_trace_ctx(""):
        pass                                        # falsy dir: no-op


# ---------------------------------------------------------------- memory


def test_memory_watch_verdicts_equal_the_references():
    mine, ref = M.MemoryWatch(patience=3), JM.MemoryWatch(patience=3)
    series = [100.0 + i % 3 for i in range(10)] + [1e4] + [
        1e4 * 1.05 ** i for i in range(8)]
    kinds = []
    for step, x in enumerate(series):
        a = [str(v) for v in mine.observe(step, device_bytes=x,
                                          rss_bytes=2 * x)]
        b = [str(v) for v in ref.observe(step, device_bytes=x,
                                         rss_bytes=2 * x)]
        assert a == b
        kinds += a
    assert any("mem_drift" in k for k in kinds)
    assert any("mem_leak" in k for k in kinds)


def test_owner_accounting_counts_each_storage_once():
    """Owners' bytes by storage: a view of an owned tensor costs
    nothing more, two owners of one tensor count it once (the first),
    and a tree's bytes are its storages' bytes."""
    params = {"w": torch.zeros(64, 32), "b": [torch.zeros(32)]}
    view = params["w"][:8]
    M.register_owner("train.params", lambda: params)
    M.register_owner("views", lambda: {"v": view, "again": params["b"]})
    M.register_owner("empty", lambda: None)
    acct = M.per_owner_accounting()
    assert acct["owners"] == {"train.params": (64 * 32 + 32) * 4,
                              "views": 0, "empty": 0}
    assert acct["tracked_bytes"] == (64 * 32 + 32) * 4
    assert acct["untracked_bytes"] == 0 and acct["n_live_arrays"] == 2
    with pytest.raises(TypeError):
        M.register_owner("bad", params)
    assert M.registered_owners() == ("train.params", "views", "empty")
    M.unregister_owner("views")
    assert "views" not in M.registered_owners()


def test_cpu_memory_views_are_empty_and_forensics_host_side():
    if torch.cuda.is_available():
        pytest.skip("the CPU-only view")
    assert M.device_memory_stats() == {}
    live = M.live_hbm_high_water()
    assert live["max_device_bytes"] == 0 and live["per_device"] == {}
    keep = torch.zeros(1 << 18)                    # 1 MiB, the largest
    M.register_owner("big", lambda: keep)
    top = M.top_live_arrays(3)
    assert top[0]["nbytes"] >= keep.numel() * 4
    assert any(r["owner"] == "big" for r in top)
    f = M.forensics(2)
    assert set(f) == {"accounting", "top_arrays", "device_stats",
                      "host_rss_bytes"}
    assert M.host_rss_bytes() > 0


# ----------------------------------------------------------- collectives


def test_counters_give_the_references_shape():
    m = C.mark()
    C.count("dp", 100)
    C.count_tensors("pp", [torch.zeros(3, dtype=torch.bfloat16),
                           {"x": torch.zeros(2)}])
    got = C.since(m)
    assert got == {"per_axis": {"dp": {"bytes": 100, "calls": 1},
                                "pp": {"bytes": 14, "calls": 1}},
                   "total_bytes": 114, "approximate": False}
    assert C.since(C.mark()) == C.empty()


def test_tap_counts_the_operand_and_its_transpose():
    x = torch.randn(4, 3, requires_grad=True)
    m = C.mark()
    y = C.tap(x * 2.0, "sp")
    assert torch.equal(y, x * 2.0)
    y.sum().backward()
    assert C.since(m)["per_axis"] == {"sp": {"bytes": 96, "calls": 2}}
    m = C.mark()
    with torch.no_grad():
        C.tap(x, "sp", forward=False)
    assert C.since(m) == C.empty()


# ----------------------------------------------------------------- trace


def test_off_is_the_shared_null_span_and_records_nothing(tmp_path):
    tr = TR.configure(trace_dir=tmp_path, level="off")
    sp = tr.span("step", step=0)
    assert sp is TR._NULL_SPAN
    with sp as s:
        s.fence(torch.zeros(2))
        s.set(x=1)
    tr.event("e")
    tr.counter("c", 1)
    tr.complete("x", 0.0, 1.0)
    assert tr.track("r") == 0
    assert tr.events == [] and not (tmp_path / "spans.jsonl").exists()


def test_trace_files_are_chrome_and_valid_under_both_schemas(tmp_path):
    tr = TR.configure(trace_dir=tmp_path, level="spans")
    with tr.span("step", step=0) as sp:
        with tr.span("grads", step=0) as g:
            g.fence(torch.zeros(2))
        sp.set(extra=1)
    tid = tr.track("request r0")
    tr.complete("rq_decode", tr.now(), tr.now() + 0.001, tid=tid, rid="r0")
    tr.event("ckpt", step=0)
    tr.counter("hbm", 5)
    assert [e["name"] for e in tr.spans_named("step")] == ["step"]
    assert tr.event_count == 6 and len(tr.events_since(4)) == 2
    TR.configure()                                      # closes it
    lines = (tmp_path / "spans.jsonl").read_text().splitlines()
    assert [json.loads(x)["name"] for x in lines] == [
        "grads", "step", "thread_name", "rq_decode", "ckpt", "hbm"]
    assert json.loads(lines[1])["args"] == {"step": 0, "extra": 1}
    assert S.validate_file(tmp_path / "spans.jsonl") == []
    assert JS.validate_file(tmp_path / "spans.jsonl") == []
    chrome = json.loads((tmp_path / "trace.json").read_text())
    ev = chrome["traceEvents"]
    assert chrome["displayTimeUnit"] == "ms" and len(ev) == 6
    assert {e["tid"] for e in ev if e["name"] in ("grads", "step")} == {0, 1}
    assert ev[3]["tid"] == tid == 1000


def test_span_nesting_is_checked():
    tr = TR.configure(level="steps")
    outer = tr.span("step")
    inner = tr.span("grads")
    outer.__enter__()
    inner.__enter__()
    with pytest.raises(AssertionError, match="nesting"):
        outer.__exit__(None, None, None)


def test_the_fence_skips_cpu_tensors_and_walks_trees(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    TR._block(({"a": torch.zeros(1), "b": [torch.zeros(2)]}, 3, None))
    assert calls == []
    cuda = torch.device("cuda", 0)

    class Fake:             # a CUDA tensor's stand-in: only `device`
        device = cuda

    TR._block(([Fake(), Fake()], {"x": Fake()}))
    assert calls == [cuda]


# ----------------------------------------------------------- RunTelemetry


class _Engine:
    comm_bytes = {"dp_psum": 8}

    def telemetry_traffic(self):
        return {"per_axis": {"dp": {"bytes": 64, "calls": 1},
                             "pp": {"bytes": 16, "calls": 2}},
                "total_bytes": 80, "approximate": False}

    def health_snapshot(self):
        return None


def test_step_fields_carry_the_references_names(tmp_path):
    tele = REP.RunTelemetry(_Engine())
    M.register_owner("train.params", lambda: [torch.zeros(256)])
    tele.set_bubble(bubble_static=0.25)
    f = tele.step_fields(window_secs=2.0, steps_in_window=4)
    assert f["coll_bytes_per_step"] == 80
    assert f["coll_bytes_by_axis"] == {"dp": 64, "pp": 16}
    assert f["coll_gbps"] == round(80 * 4 / 2.0 / 1e9, 6)
    assert f["coll_bytes_measured"] == {"dp_psum": 8}
    assert f["hbm_owned_mib"] == {"train.params": round(1024 / 2**20, 2)}
    assert f["bubble_static"] == 0.25 and "host_rss_mib" in f
    assert set(f) <= set(JS._STEP_TELEMETRY)
    assert not {"compiles", "recompiles", "hbm_static_mib",
                "hbm_within_bound", "exposed_comm_frac"} & set(f)
    line = {"event": "step", "step": 1, "loss": 1.0, "tokens_per_sec": 1.0,
            **f}
    assert JS.validate_line(line) == [] == S.validate_line(line)
    assert tele.static_report() is None
    summ = json.loads(tele.write_summary(tmp_path).read_text())
    assert summ["engine"] == "_Engine" and summ["traffic"]["total_bytes"] == 80
    assert summ["hbm_owners"]["owners"] == {"train.params": 1024}


# ------------------------------------------------------ CLI and the names


def test_cli_validate_and_refusals(tmp_path, capsys):
    good = tmp_path / "good.jsonl"
    good.write_text(json.dumps(LINES[0]) + "\n" + json.dumps(LINES[7]))
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(LINES[4]) + "\nnot json\n")
    assert cli.main(["--validate", str(good)]) == 0
    assert cli.main(["--validate", str(tmp_path)]) == 1
    err = capsys.readouterr().err
    assert "bad.jsonl:1" in err and "bad.jsonl:2: not JSON" in err
    assert cli.main(["--validate", str(tmp_path / "missing.jsonl")]) == 1
    assert cli.main(["--regress", *map(str, _bench(tmp_path, [1.0, 1.0]))]
                    ) == 0
    # --fleet over a metrics file: one refresh, the status table printed
    assert cli.main(["--fleet", str(good), "--once"]) == 0
    out = capsys.readouterr().out
    assert "fleet: 1/1 replicas alive" in out and "[good] up" in out
    assert cli.main(["--fleet", str(tmp_path / "missing.jsonl"),
                     "--once"]) == 1


def test_lazy_names_resolve_or_name_their_item():
    for name, mod in PT._LAZY.items():
        assert getattr(PT, name) is getattr(__import__(
            f"shallowspeed_tpu_torch.telemetry.{mod}", fromlist=["x"]), name)
    from shallowspeed_tpu_torch.telemetry import fleet

    for name in ("FleetCollector", "Replica", "format_fleet_status",
                 "fleet_main"):
        assert getattr(PT, name) is getattr(fleet, name)
    with pytest.raises(AttributeError):
        PT.no_such_name
    assert PT.tracer() is TR.tracer()
