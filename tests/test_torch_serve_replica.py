"""The port's replica mode (`serve --serve`) and the router driver
(`python -m shallowspeed_tpu_torch.router`), on the CPU (`--device cpu`).

- The HTTP surface a router drives: POST /submit, GET /requests, POST
  /drain on the replica's monitor endpoint, the typed rejections
  (duplicate id, `EngineOverloaded` past `--max-queue`, `EngineDraining`),
  registration at a fleet collector and deregistration after a clean
  drain; the heartbeat file; SIGTERM still printing the summary.
- A cross-process drill: the router over two `serve --serve` children,
  one killed at its second engine tick, the other's heartbeat frozen
  (found by `--hang-timeout`); every stream equals a plain `serve`
  run's (token for token: the same f32 CPU arithmetic, the continuation
  re-prefilled), both replicas respawned, the router log reduced by
  `--goodput` to per-replica MTTR and fleet availability. Its own wall
  limit is 60 s.

The replicas here run in a thread of the test process (the fleet
collector learns their endpoint through `--fleet-register`) or as
child processes; either way nothing of the JAX package runs.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

from shallowspeed_tpu_torch import chaos
from shallowspeed_tpu_torch import serve as sdriver
from shallowspeed_tpu_torch.telemetry.fleet import FleetCollector
from shallowspeed_tpu_torch.telemetry.monitor import StatusServer

ROOT = Path(__file__).resolve().parent.parent
MODEL = ["--device", "cpu", "--d-model", "32", "--n-heads", "4",
         "--n-layers", "1", "--max-seq", "128", "--n-blocks", "32",
         "--block-size", "8", "--slots", "4", "--prefill-chunk", "16"]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


class _Replica:
    """`serve --serve` in a thread of this process, registered at a
    fleet collector of the test's own."""

    def __init__(self, tmp_path, *extra):
        self.fc = FleetCollector()
        self.srv = StatusServer(self.fc, port=0)
        self.log = tmp_path / "replica.jsonl"
        self.rc = []
        argv = ["--serve", "--fleet-register",
                f"http://{self.srv.host}:{self.srv.port}", "--replica",
                "t0", "--log-file", str(self.log), *MODEL, *extra]
        self.thread = threading.Thread(
            target=lambda: self.rc.append(sdriver.main(argv)), daemon=True)
        self.thread.start()
        t0 = time.monotonic()
        while not self.fc.replicas and time.monotonic() - t0 < 30:
            time.sleep(0.02)
        assert self.fc.replicas, "the replica never registered"
        self.url = self.fc.replicas[0].url

    def close(self):
        try:
            if self.thread.is_alive():
                _post(self.url + "/drain", {})
                self.thread.join(30)
        finally:
            self.srv.close()
            chaos.configure(None)

    def wait_done(self, rid, limit=30.0):
        t0 = time.monotonic()
        while time.monotonic() - t0 < limit:
            rec = _get(self.url + "/requests")["requests"].get(rid)
            if rec and rec["status"] == "done":
                return rec
            time.sleep(0.02)
        raise AssertionError(f"{rid} not done")


def test_replica_http_submit_requests_drain(tmp_path, capsys):
    """Submit (one greedy, one sampled), poll to done, a duplicate id
    rejected typed; the streams equal a plain `serve` run's; drain
    rejects new work, the loop exits 0 and the replica deregisters."""
    rep = _Replica(tmp_path)
    try:
        assert _post(rep.url + "/submit", {
            "id": "a", "prompt": [5, 6, 7, 8], "max_new": 6}) == {
            "ok": True, "id": "a"}
        assert _post(rep.url + "/submit", {
            "id": "b", "prompt": [9, 3, 1], "max_new": 5,
            "temperature": 0.9, "seed": 4})["ok"]
        got = {r: rep.wait_done(r)["tokens"] for r in ("a", "b")}
        dup = _post(rep.url + "/submit", {"id": "a", "prompt": [1],
                                          "max_new": 2})
        assert dup["ok"] is False and "duplicate" in dup["error"]
        status = _get(rep.url + "/status.json")
        assert status["replica"] == "t0"
        assert _post(rep.url + "/drain", {})["draining"] is True
        rej = _post(rep.url + "/submit", {"id": "c", "prompt": [1],
                                          "max_new": 2})
        assert rej == {"ok": False, "error": "EngineDraining",
                       "retry_after": 1.0}
        rep.thread.join(30)
        assert rep.rc == [0] and not rep.fc.replicas     # deregistered
    finally:
        rep.close()
    out = capsys.readouterr().out
    summary = json.loads(next(x for x in out.splitlines()
                              if '"summary"' in x))
    assert summary["drained"] is True and summary["n_requests"] == 2
    reqs = tmp_path / "r.jsonl"
    reqs.write_text(json.dumps({"id": "a", "prompt": [5, 6, 7, 8],
                                "max_new": 6}) + "\n" + json.dumps(
        {"id": "b", "prompt": [9, 3, 1], "max_new": 5, "temperature": 0.9,
         "seed": 4}) + "\n")
    assert sdriver.main([*MODEL, "--requests", str(reqs)]) == 0
    plain = {r["id"]: r["tokens"] for r in map(
        json.loads, capsys.readouterr().out.splitlines())
        if r["event"] == "result"}
    assert got == plain


def test_replica_max_queue_typed_rejection(tmp_path):
    """`--max-queue 1`: while the first request waits in a stalled
    engine step (a chaos stall at tick 0), the second is rejected
    typed with a retry-after; after the stall it is accepted."""
    rep = _Replica(tmp_path, "--max-queue", "1", "--chaos", "stall@0:1.5",
                   "--chaos-state", str(tmp_path / "cs"))
    try:
        assert _post(rep.url + "/submit", {"id": "a", "prompt": [1, 2, 3],
                                           "max_new": 3})["ok"]
        over = _post(rep.url + "/submit", {"id": "b", "prompt": [4],
                                           "max_new": 2})
        assert over == {"ok": False, "error": "EngineOverloaded",
                        "retry_after": 0.5}
        rep.wait_done("a")
        assert _post(rep.url + "/submit", {"id": "b", "prompt": [4],
                                           "max_new": 2})["ok"]
        rep.wait_done("b")
    finally:
        rep.close()


def test_replica_heartbeat_and_sigterm_summary(tmp_path):
    """A child `serve --serve`: its heartbeat file is rewritten several
    times a second while it idles; SIGTERM ends it through the summary
    line (exit 143, `drained` false)."""
    hb = tmp_path / "hb"
    proc = subprocess.Popen(
        [sys.executable, "-m", "shallowspeed_tpu_torch.serve", "--serve",
         "--heartbeat-file", str(hb), *MODEL], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert '"monitor_listening"' in line, line
        url = json.loads(line)["url"]
        assert _get(url)["serving"] is None
        t0 = time.monotonic()
        while not hb.exists() and time.monotonic() - t0 < 10:
            time.sleep(0.05)
        first = hb.stat().st_mtime_ns
        time.sleep(0.6)
        assert hb.stat().st_mtime_ns > first and hb.read_text() == "ok"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 143
    summary = json.loads(next(x for x in out.splitlines()
                              if '"summary"' in x))
    assert summary["drained"] is False and summary["device"] == "cpu"


def test_router_drill_kill_and_freeze(tmp_path, capsys):
    """The router driver over two `serve --serve` children on the CPU:
    r0 killed at its second engine tick, r1's heartbeat frozen at its
    first (killed as a hang 2 s later, before r0's respawn, which waits
    out a 1 s backoff and a process start, can end `--settle`). Every
    stream equals the plain `serve` run's, at least one request failed
    over, both replicas respawned (restart_downtime stamps of classes
    crash and hang), and `--goodput` reduces the router log to
    per-replica MTTR and the fleet's availability. Wall limit 60 s."""
    from shallowspeed_tpu_torch.telemetry.goodput import (format_report,
                                                          run_goodput)
    from shallowspeed_tpu_torch.telemetry.schema import validate_file

    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps(r) + "\n" for r in [
        {"id": f"q{i}", "prompt_len": 6 + 3 * i, "prompt_seed": i,
         "max_new": 10, **({"temperature": 0.8, "seed": i} if i % 2 else {})}
        for i in range(6)]))
    run = tmp_path / "run"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "shallowspeed_tpu_torch.router",
         "--replicas", "2", *MODEL[2:], "--device", "cpu",
         "--requests", str(reqs), "--log-file", str(run / "router.jsonl"),
         "--chaos-fleet", "r0=kill@2;r1=freeze@1",
         "--chaos-state", str(tmp_path / "chaos"), "--hang-timeout", "2",
         "--backoff", "1", "--term-grace", "1", "--await-replicas", "30",
         "--settle", "25"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=60 - 5)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    fleet = {r["id"]: r["tokens"] for r in lines
             if r["event"] == "result" and r["status"] == "done"}
    summary = lines[-1]
    assert summary["event"] == "summary"
    assert summary["counters"]["failovers"] >= 1
    assert summary["counters"]["respawns"] >= 2, out.stdout[-3000:]
    ready = [r["replica"] for r in lines if r["event"] == "replica_ready"]
    assert ready.count("r0") >= 2 and ready.count("r1") >= 2
    assert sdriver.main([*MODEL, "--requests", str(reqs)]) == 0
    want = {r["id"]: r["tokens"] for r in map(
        json.loads, capsys.readouterr().out.splitlines())
        if r["event"] == "result"}
    assert fleet == want and len(want) == 6
    assert time.monotonic() - t0 < 60
    log = run / "router.jsonl"
    assert validate_file(log) == []
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    classes = {(r["replica"], r["fail_class"]) for r in recs
               if r.get("kind") == "restart_downtime"}
    assert {("r0", "crash"), ("r1", "hang")} <= classes, classes
    rep = run_goodput(log)
    assert {"r0", "r1"} <= set(rep["fleet"]["mttr"])
    assert 0.0 < rep["fleet"]["fleet_availability"] < 1.0
    assert "fleet availability" in format_report(rep)
