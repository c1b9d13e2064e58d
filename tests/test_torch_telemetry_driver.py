"""The telemetry flags of the port's drivers on the CPU: `train_lm` and
`train` with `--telemetry` / `--trace-dir` write `spans.jsonl`,
`trace.json` and `telemetry.json`, their files and metrics lines pass
the reference's own `schema.validate_file`, the step lines carry the
reference's telemetry field names but for the quantities the port does
not have (compile counters, the static HBM bound, exposure), the
`spans` level's waterfall on the CPU's calibrated rates, and the losses
are the `off` run's bit for bit; `--profile-dir` writes a Chrome trace,
`--profile host` the sampler's "profile" events (train_lm and serve);
the live-monitoring flags build the monitor plane; the flags still
refused name their ROADMAP item."""

import json
import re

import pytest

from shallowspeed_tpu.telemetry import schema as JS
from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch import serve as sdriver
from shallowspeed_tpu_torch import train as mdriver
from shallowspeed_tpu_torch import train_lm as tdriver
from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.telemetry import driver as TD
from shallowspeed_tpu_torch.telemetry import memory as M
from shallowspeed_tpu_torch.telemetry import trace as TR

LM = ["--device", "cpu", "--steps", "4", "--seq-len", "32", "--d-model",
      "32", "--n-layers", "2", "--batch-size", "4", "--log-every", "2"]

# the reference's step-line telemetry fields the port writes on the CPU,
# and those it leaves absent (no quantity: no compiled executables, no
# jaxpr analysis; no bubble off the pipeline)
PRESENT = {"hbm_live_mib", "hbm_owned_mib", "hbm_untracked_mib",
           "host_rss_mib", "coll_bytes_per_step", "coll_bytes_by_axis",
           "coll_gbps"}
ABSENT = {"compiles", "recompiles", "hbm_static_mib", "hbm_within_bound",
          "exposed_comm_frac", "overlap_ratio", "overlap",
          "bubble_static", "bubble_measured"}
WATERFALL = {"attrib_t_step_ms", "attrib_compute_frac", "attrib_mxu_frac",
             "attrib_comm_exposed_frac", "attrib_host_frac",
             "attrib_unexplained_frac", "attrib_compute_scale",
             "attrib_hbm_frac", "attrib_wire"}


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_telemetry_driver")
    prepare_mnist(d, synthetic=True, n_samples=1024)
    return d


@pytest.fixture(autouse=True)
def _off():
    yield
    TR.configure()
    M.clear_owners()


def _events(path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines()
            if x.strip()]


def _steps(path) -> list:
    return [e for e in _events(path) if e.get("event") == "step"]


def test_train_lm_spans_and_files(tmp_path):
    d = tmp_path / "tr"
    log = tmp_path / "m.jsonl"
    loss = tdriver.train(tdriver.parse_args(
        LM + ["--dp", "2", "--zero1", "--telemetry", "spans",
              "--trace-dir", str(d), "--log-file", str(log)]))
    for name in ("spans.jsonl", "trace.json", "telemetry.json"):
        assert (d / name).exists(), name
    assert JS.validate_file(d / "spans.jsonl") == []
    assert JS.validate_file(log) == []
    spans = _events(d / "spans.jsonl")
    assert [e["name"] for e in spans[:3]] == ["grads", "update", "step"]
    assert len(spans) == 4 * 3
    chrome = json.loads((d / "trace.json").read_text())
    assert len(chrome["traceEvents"]) == 12
    steps = _steps(log)
    assert [s["step"] for s in steps] == [0, 2, 3]
    for s in steps:
        assert PRESENT <= set(s), PRESENT - set(s)
        assert not ABSENT & set(s)
        # the waterfall at `spans`, on the CPU's calibrated rates
        assert WATERFALL <= set(s), WATERFALL - set(s)
        assert s["attrib_rates_source"] == "calibrated"
        assert set(s["hbm_owned_mib"]) == {"train.params",
                                           "train.opt_state"}
        assert set(s["coll_bytes_by_axis"]) == {"dp"}
    summ = json.loads((d / "telemetry.json").read_text())
    assert summ["engine"] == "ContextParallelEngine"
    assert summ["traffic"]["per_axis"]["dp"]["calls"] == 2
    assert TR.tracer().level == "off" and M.registered_owners() == ()
    # the same run at `off` and at `steps`: the same losses, bit for bit
    for level in ("off", "steps"):
        log2 = tmp_path / f"{level}.jsonl"
        assert tdriver.train(tdriver.parse_args(
            LM + ["--dp", "2", "--zero1", "--telemetry", level,
                  "--log-file", str(log2)])) == loss
        assert [s["loss"] for s in _steps(log2)] == [
            s["loss"] for s in steps]
        fields = set().union(*map(set, _steps(log2)))
        assert bool(PRESENT & fields) == (level == "steps")


def test_trace_dir_implies_steps_and_the_profile_dir_capture(tmp_path):
    d, prof = tmp_path / "tr", tmp_path / "prof"
    args = tdriver.parse_args(LM + ["--trace-dir", str(d), "--profile-dir",
                                    str(prof)])
    tdriver.train(args)
    assert args.telemetry == "steps"
    assert [e["name"] for e in _events(d / "spans.jsonl")] == ["step"] * 4
    trace = json.loads((prof / "trace_p0.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("aten::" in str(n) for n in names)


def test_train_lm_host_profile_tags_the_steps(tmp_path):
    log = tmp_path / "m.jsonl"
    tdriver.train(tdriver.parse_args(
        LM + ["--steps", "8", "--telemetry", "steps", "--profile", "host",
              "--profile-hz", "400", "--log-file", str(log)]))
    prof = [e for e in _events(log) if e["event"] == "profile"]
    assert prof and JS.validate_file(log) == []
    snap = prof[-1]
    assert snap["samples"] >= 1 and sum(snap["phases"].values()) == \
        snap["samples"]


def test_each_process_writes_its_own_trace_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "process_index", lambda: 1)
    args = tdriver.parse_args(LM + ["--trace-dir", str(tmp_path)])
    telem, plane = TD.start_telemetry(args, object(), None, {})
    assert TR.tracer().dir == tmp_path / "p1" and args.trace_dir == str(
        tmp_path / "p1")
    assert telem is not None and plane is None


@pytest.mark.parametrize("argv,engine", [
    (["--dp", "2"], "FusedDPEngine"),
    (["--pp", "2", "--schedule", "pipedream"], "PipelineExecutor"),
    (["--dp", "2", "--pp", "2", "--schedule", "gpipe"],
     "SPMDPipelineEngine")], ids=["fused", "vm", "spmd"])
def test_train_writes_telemetry_events_and_files(tmp_path, mnist, argv,
                                                 engine):
    d, log = tmp_path / "tr", tmp_path / "m.jsonl"
    mdriver.train(mdriver.parse_args(
        ["--device", "cpu", "--epochs", "1", "--max-batches", "2",
         "--data-dir", str(mnist), "--telemetry", "steps",
         "--trace-dir", str(d), "--log-file", str(log), *argv]))
    assert JS.validate_file(d / "spans.jsonl") == []
    assert JS.validate_file(log) == []
    tel = [e for e in _events(log) if e["event"] == "telemetry"]
    assert len(tel) == 1 and "hbm_owned_mib" in tel[0]
    assert ("coll_bytes_measured" in tel[0]) == (engine == "PipelineExecutor")
    assert json.loads((d / "telemetry.json").read_text())["engine"] == engine


def test_fp8_refuses_telemetry(tmp_path):
    with pytest.raises(SystemExit, match="--telemetry is not supported"):
        mdriver.train(mdriver.parse_args(
            ["--device", "cpu", "--engine", "fp8", "--telemetry", "steps",
             "--data-dir", str(tmp_path)]))


def test_serve_host_profile(tmp_path, capsys):
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("\n".join(json.dumps(
        {"id": f"r{i}", "prompt_len": 12, "prompt_seed": i, "max_new": 6})
        for i in range(4)))
    log = tmp_path / "m.jsonl"
    assert sdriver.main(["--device", "cpu", "--requests", str(reqs),
                         "--profile", "host", "--profile-hz", "500",
                         "--log-file", str(log)]) == 0
    assert JS.validate_file(log) == []
    off = capsys.readouterr().out
    assert sdriver.main(["--device", "cpu", "--requests", str(reqs)]) == 0
    streams = [ln for ln in off.splitlines() if '"result"' in ln]
    assert len(streams) == 4
    assert [json.loads(x)["tokens"] for x in streams] == [
        json.loads(x)["tokens"] for x in capsys.readouterr().out.splitlines()
        if '"result"' in x]


@pytest.mark.parametrize("module,flag,item", [
    (tdriver, "--platform", "--device"), (tdriver, "--host-devices",
                                           "--device"),
    (mdriver, "--platform", "--device"), (sdriver, "--heartbeat-file",
                                          "item 7"),
    (sdriver, "--replica", "item 7"), (sdriver, "--max-queue", "item 7"),
    (sdriver, "--shed-load", "item 7")],
    ids=lambda x: x if isinstance(x, str) else x.__name__.split(".")[-1])
def test_still_refused_flags_name_their_item(module, flag, item):
    parse = getattr(module, "parse_args")
    with pytest.raises(NotPorted, match=re.escape(item)):
        parse(["--device", "cpu", flag, "1"])


@pytest.mark.parametrize("module,flag,value", [
    (tdriver, "--flight-recorder", "8"), (tdriver, "--monitor-port", "0"),
    (tdriver, "--slo", "step_p95_ms<500"),
    (mdriver, "--flight-recorder", "8"), (mdriver, "--monitor-port", "0"),
    (mdriver, "--slo", "step_p95_ms<500"),
    (sdriver, "--slo", "ttft_p95_ms<500,availability>0.99"),
    (sdriver, "--monitor-port", "0"), (sdriver, "--flight-recorder", "8")],
    ids=lambda x: x if isinstance(x, str) else x.__name__.split(".")[-1])
def test_monitor_flags_build_the_plane(module, flag, value, tmp_path):
    """Each live-monitoring flag parses and turns the monitor plane on:
    `monitor.from_args` builds a Monitor (its SLO rules, its flight
    recorder next to --log-file) and, with --monitor-port, a bound
    endpoint."""
    from shallowspeed_tpu_torch.metrics import MetricsLogger
    from shallowspeed_tpu_torch.telemetry import monitor as MON

    args = module.parse_args(["--device", "cpu", "--log-file",
                              str(tmp_path / "m.jsonl"), flag, value])
    metrics = MetricsLogger(args.log_file)
    mon, srv = MON.from_args(args, metrics)
    try:
        assert mon is not None and metrics.monitor is mon
        assert (srv is not None) == (flag == "--monitor-port")
        if flag == "--slo":
            assert [r.spec for r in mon.rules] == value.split(",")
        if flag == "--flight-recorder":
            assert mon.flight_enabled and mon.flight.ring.maxlen == 8
            assert mon.flight.out_dir == tmp_path
        if srv is not None:
            assert srv.port > 0
    finally:
        MON.close_monitor(mon, srv)
        metrics.close()
