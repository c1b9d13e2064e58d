"""The live monitor and the goodput ledger in the port's drivers on the
CPU: `train_lm`, `train` (the VM at pp 2 and the fp8 trainer) and
`serve` with `--monitor-port 0 --slo ... --flight-recorder N` write
`"monitor"`, `"alert"` and `"ledger"` lines the port's `--validate`
accepts and a flight dump next to the log, serve /status.json while
they run, and train and serve exactly as without those flags (losses,
model hash, streams); `python -m shallowspeed_tpu_torch.telemetry
--goodput` and `--live --once` read those logs."""

import json
import re
import threading
import urllib.request

import pytest

from shallowspeed_tpu_torch import serve as sdriver
from shallowspeed_tpu_torch import train as mdriver
from shallowspeed_tpu_torch import train_lm as tdriver
from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.telemetry import __main__ as cli
from shallowspeed_tpu_torch.telemetry import driver as TD
from shallowspeed_tpu_torch.telemetry import memory as M
from shallowspeed_tpu_torch.telemetry import trace as TR
from shallowspeed_tpu_torch.telemetry.schema import validate_file

LM = ["--device", "cpu", "--steps", "5", "--seq-len", "32", "--d-model",
      "32", "--n-layers", "2", "--batch-size", "4", "--log-every", "1"]
# an SLO no step or request can meet: it fires once min_count lands
NEVER = {"step": "step_p95_ms<0.001", "ttft": "ttft_p95_ms<0.001"}


@pytest.fixture(autouse=True)
def _off():
    yield
    TR.configure()
    M.clear_owners()


@pytest.fixture
def fetched(monkeypatch):
    """Every endpoint the drivers start, polled from a thread while the
    run is live, as an operator would: /status.json and /metrics (the
    fetches that answered, in order)."""
    got, threads = [], []
    start, stop = TD.start_monitor, TD.stop_monitor

    def poll(srv, halt):
        while not halt.is_set():
            try:
                for path in ("/status.json", "/metrics"):
                    with urllib.request.urlopen(srv.url(path),
                                                timeout=10) as r:
                        got.append((path, r.read().decode()))
            except OSError:
                pass
            halt.wait(0.02)

    def spy_start(args, metrics, plane=None):
        mon, srv = start(args, metrics, plane)
        if srv is not None:
            halt = threading.Event()
            th = threading.Thread(target=poll, args=(srv, halt),
                                  daemon=True)
            th.start()
            threads.append((mon, halt, th))
        return mon, srv

    def spy_stop(mon, srv):
        for m, halt, th in threads:
            if m is mon:
                halt.set()
                th.join(timeout=30)
        stop(mon, srv)

    for mod in (TD, tdriver, mdriver):
        monkeypatch.setattr(mod, "start_monitor", spy_start)
        monkeypatch.setattr(mod, "stop_monitor", spy_stop)
    yield got
    for _, halt, th in threads:
        halt.set()
        th.join(timeout=30)


def _events(path) -> list:
    return [json.loads(x) for x in path.read_text().splitlines() if x]


def _kinds(path) -> set:
    return {e["event"] for e in _events(path)}


def _check_log(log, dumps_dir) -> None:
    assert validate_file(log) == []
    assert {"monitor", "alert", "ledger"} <= _kinds(log), _kinds(log)
    alert = next(e for e in _events(log) if e["event"] == "alert")
    assert alert["state"] == "firing"
    assert sorted(dumps_dir.glob("flightrec_*.json"))
    assert cli.main(["--validate", str(log)]) == 0


def _cli_reads(log, capsys) -> None:
    capsys.readouterr()
    assert cli.main(["--goodput", str(log)]) == 0
    out = capsys.readouterr().out
    assert "goodput" in out and "accounted" in out
    assert cli.main(["--live", str(log), "--once"]) == 0
    out = capsys.readouterr().out
    assert "uptime" in out and "ALERT" in out


def test_train_lm_monitor_ledger_and_losses(tmp_path, fetched, capsys):
    log = tmp_path / "m.jsonl"
    argv = LM + ["--pp", "2", "--n-mubatches", "2", "--telemetry", "spans",
                 "--log-file", str(log)]
    loss = tdriver.train(tdriver.parse_args(
        argv + ["--monitor-port", "0", "--slo", NEVER["step"],
                "--flight-recorder", "16"]))
    out = capsys.readouterr().out
    assert re.search(r"monitor: http://127\.0\.0\.1:\d+/status\.json", out)
    assert "bubble measured" in out and "waterfall" in out
    _check_log(log, tmp_path)
    kinds = {e.get("kind") for e in _events(log) if e["event"] == "ledger"}
    assert {"init", "calibration", "telemetry"} <= kinds, kinds
    assert any(e["event"] == "bubble" for e in _events(log))
    status = [json.loads(b) for p, b in fetched if p == "/status.json"]
    assert status and all(s["replica"] is None for s in status)
    assert any("step_ms" in s["sketches"] for s in status)
    assert any(p == "/metrics" and "shallowspeed_up 1" in b
               for p, b in fetched)
    steps = [e["loss"] for e in _events(log) if e["event"] == "step"]
    log2 = tmp_path / "off.jsonl"
    assert tdriver.train(tdriver.parse_args(
        [*argv[:-1], str(log2)])) == loss
    assert [e["loss"] for e in _events(log2) if e["event"] == "step"] == \
        steps
    _cli_reads(log, capsys)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_monitor_driver")
    prepare_mnist(d, synthetic=True, n_samples=1024)
    return d


MLP = ["--device", "cpu", "--epochs", "2", "--max-batches", "6"]


def test_train_vm_monitor_bubble_and_hash(tmp_path, mnist, fetched,
                                          capsys):
    log = tmp_path / "m.jsonl"
    argv = MLP + ["--data-dir", str(mnist), "--engine", "vm", "--pp", "2",
                  "--schedule", "gpipe", "--telemetry", "spans",
                  "--log-file", str(log)]
    acc, eng = mdriver.train(mdriver.parse_args(
        argv + ["--monitor-port", "0", "--slo", NEVER["step"],
                "--flight-recorder", "8"]))
    out = capsys.readouterr().out
    assert "telemetry: bubble measured" in out
    _check_log(log, tmp_path)
    tel = [e for e in _events(log) if e["event"] == "telemetry"]
    assert tel[-1]["bubble_static"] == 0.2
    assert 0.0 <= tel[-1]["bubble_measured"] < 1.0
    assert any(p == "/status.json" for p, _ in fetched)
    hash_on = re.search(r"model hash: (\w+)", out).group(1)
    acc2, _ = mdriver.train(mdriver.parse_args(argv))
    assert acc2 == acc
    assert re.search(r"model hash: (\w+)", capsys.readouterr().out).group(
        1) == hash_on


def test_train_fp8_monitor_and_ledger(tmp_path, mnist, capsys):
    log = tmp_path / "m.jsonl"
    argv = ["--device", "cpu", "--engine", "fp8", "--epochs", "1",
            "--max-batches", "8", "--shadow-every", "3", "--log-every",
            "2", "--data-dir", str(mnist), "--log-file", str(log)]
    final, _ = mdriver.train(mdriver.parse_args(
        argv + ["--slo", NEVER["step"], "--flight-recorder", "8"]))
    _check_log(log, tmp_path)
    kinds = {e.get("kind") for e in _events(log) if e["event"] == "ledger"}
    assert {"init", "shadow_parity", "val"} <= kinds, kinds
    final2, _ = mdriver.train(mdriver.parse_args(argv))
    assert final2 == final
    _cli_reads(log, capsys)


def test_serve_monitor_alert_and_streams(tmp_path, capsys):
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("\n".join(json.dumps(
        {"id": f"r{i}", "prompt_len": 12, "prompt_seed": i, "max_new": 20})
        for i in range(6)))
    log = tmp_path / "m.jsonl"
    # a pool too small for every request at once: the recovered block
    # exhaustions stamp "oom" ledger lines
    base = ["--device", "cpu", "--requests", str(reqs), "--n-blocks", "8",
            "--slots", "4"]
    assert sdriver.main(base + ["--log-file", str(log), "--monitor-port",
                                "0", "--slo", NEVER["ttft"],
                                "--flight-recorder", "16"]) == 0
    out = capsys.readouterr().out.splitlines()
    listening = [json.loads(x) for x in out if "monitor_listening" in x]
    assert len(listening) == 1 and listening[0]["url"].endswith(
        "/status.json")
    _check_log(log, tmp_path)
    snap = [e for e in _events(log) if e["event"] == "monitor"][-1]
    assert snap["sketches"]["ttft_ms"]["n"] == 6
    assert any(e["event"] == "ledger" and e["kind"] == "oom"
               for e in _events(log))
    streams = [json.loads(x)["tokens"] for x in out if '"result"' in x]
    assert sdriver.main(base) == 0
    assert streams == [json.loads(x)["tokens"] for x in
                       capsys.readouterr().out.splitlines()
                       if '"result"' in x]
    _cli_reads(log, capsys)
