"""The port's serve driver against the root `serve.py`'s command line:
every root flag the port lacks is refused with `NotPorted` naming what
replaces it, no root flag is missing from both, the chaos flags act (a
plan's draw held against the JAX package's `chaos`) and so do the fleet
flags (the replica label, the heartbeat, the queue bound, fleet
registration, load shedding). The root driver is read as text; nothing
of it is imported."""

import json
import re
from pathlib import Path

import pytest

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch import serve as sdriver

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("flag", sorted(sdriver.UNPORTED))
def test_driver_refuses_root_flags_it_lacks(flag):
    """Each flag of the `UNPORTED` table raises `NotPorted` naming the
    flag and what replaces it (`--platform`: `--device`), with or
    without a value."""
    for argv in ([flag, "1"], [flag]):
        with pytest.raises(NotPorted, match=re.escape(flag)) as err:
            sdriver.parse_args(["--device", "cpu", *argv])
        assert err.value.later == sdriver.UNPORTED[flag]
        assert err.value.later.startswith("--device replaces it")


def _serve(tmp_path, *extra, reqs=None) -> list:
    """Two greedy requests (or `reqs`) through a tiny CPU `serve` with
    `extra` flags, no fault plan before or after it in this process;
    the log's records."""
    from shallowspeed_tpu_torch import chaos

    lines = reqs or [{"id": "a", "prompt": [5, 6, 7], "max_new": 4},
                     {"id": "b", "prompt_len": 20, "max_new": 4}]
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    log = tmp_path / "m.jsonl"
    chaos.configure(None)
    try:
        assert sdriver.main(["--device", "cpu", "--d-model", "16",
                             "--n-heads", "2", "--n-layers", "1",
                             "--max-seq", "64", "--requests", str(reqs),
                             "--log-file", str(log), *extra]) == 0
    finally:
        chaos.configure(None)
    return [json.loads(x) for x in log.read_text().splitlines()]


def _fault(recs) -> dict:
    fault, = (r for r in recs if r["event"] == "fault")
    return fault


def _act_chaos(tmp_path):
    """A tick-indexed stall: the engine's step hook at tick 2."""
    f = _fault(_serve(tmp_path, "--chaos", "stall@2:0.01"))
    assert (f["kind"], f["step"]) == ("stall", 2)


def _act_chaos_state(tmp_path):
    cs = tmp_path / "cs"
    _fault(_serve(tmp_path, "--chaos", "stall@1:0.01", "--chaos-state",
                  str(cs)))
    assert (cs / "fired_stall_at_1_0.01").exists()
    (tmp_path / "m.jsonl").unlink()
    assert not [r for r in _serve(tmp_path, "--chaos", "stall@1:0.01",
                                  "--chaos-state", str(cs))
                if r["event"] == "fault"]


def _act_chaos_seed(tmp_path):
    """nan@1 poisons the engine's parameter leaf the seed draws, in the
    reference's leaf order."""
    from shallowspeed_tpu.chaos import FaultPlan as JPlan
    from shallowspeed_tpu_torch.chaos import leaf_paths
    from shallowspeed_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab=256, d_model=16, n_heads=2,
                              n_layers=1, max_seq=64)
    n = len(list(leaf_paths(T.init(cfg, seed=0, device="cpu"))))
    ref = JPlan.parse("nan@1", seed=4)
    f = _fault(_serve(tmp_path, "--chaos", "nan@1", "--chaos-seed", "4"))
    assert f["leaf"] == int(ref._rng(ref.faults[0]).integers(0, n))


CHAOS_ACTS = {"--chaos": _act_chaos, "--chaos-state": _act_chaos_state,
              "--chaos-seed": _act_chaos_seed}


@pytest.mark.parametrize("flag", sorted(CHAOS_ACTS))
def test_chaos_flag_acts(tmp_path, flag):
    """Each chaos flag the driver refused with `NotPorted` until the
    fault plane came does what the root driver's does."""
    assert flag not in sdriver.UNPORTED
    CHAOS_ACTS[flag](tmp_path)


def _act_replica(tmp_path):
    """The label on the log's run_start line."""
    start = _serve(tmp_path, "--replica", "west-3")[0]
    assert (start["event"], start["replica"]) == ("run_start", "west-3")


def _act_heartbeat_file(tmp_path):
    hb = tmp_path / "hb"
    _serve(tmp_path, "--heartbeat-file", str(hb))
    assert hb.read_text() == "ok"


def _replica_thread(tmp_path, *extra):
    """`serve --serve` on a thread, registered at a collector of the
    test's; returns (collector, server, thread, the replica's URL)."""
    import threading
    import time

    from shallowspeed_tpu_torch.telemetry.fleet import FleetCollector
    from shallowspeed_tpu_torch.telemetry.monitor import StatusServer

    fc = FleetCollector()
    srv = StatusServer(fc, port=0)
    argv = ["--device", "cpu", "--d-model", "16", "--n-heads", "2",
            "--n-layers", "1", "--max-seq", "64", "--serve",
            "--fleet-register", f"http://{srv.host}:{srv.port}",
            "--log-file", str(tmp_path / "rep.jsonl"), *extra]
    th = threading.Thread(target=sdriver.main, args=(argv,), daemon=True)
    th.start()
    t0 = time.monotonic()
    while not fc.replicas and time.monotonic() - t0 < 30:
        time.sleep(0.02)
    assert fc.replicas
    return fc, srv, th, fc.replicas[0].url


def _call(url, body=None):
    import urllib.request

    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def _act_fleet_register(tmp_path):
    """Registered under the pid label, deregistered by a clean drain."""
    fc, srv, th, url = _replica_thread(tmp_path)
    try:
        assert fc.replicas[0].name.startswith("pid")
        assert _call(url + "/drain", {})["draining"]
        th.join(30)
        assert not th.is_alive() and not fc.replicas
    finally:
        srv.close()


def _act_max_queue(tmp_path):
    """`--max-queue 0`: every submission is refused typed."""
    fc, srv, th, url = _replica_thread(tmp_path, "--max-queue", "0")
    try:
        assert _call(url + "/submit", {"id": "a", "prompt": [1, 2],
                                       "max_new": 2}) == {
            "ok": False, "error": "EngineOverloaded", "retry_after": 0.5}
        _call(url + "/drain", {})
        th.join(30)
    finally:
        srv.close()


def _act_shed_load(tmp_path):
    """An SLO no request can meet burns critical after five requests:
    with `--shed-load` the engine pauses admission (a `load_shed`
    ledger line), without it the alert stays telemetry."""
    reqs = [{"id": f"r{i}", "prompt_len": 8, "prompt_seed": i,
             "max_new": 3, "at": 0.0} for i in range(9)]
    for shed in (True, False):
        log = _serve(tmp_path, "--slo", "ttft_p95_ms<0.0001", "--slots",
                     "1", *(["--shed-load"] if shed else []), reqs=reqs)
        sheds = [r for r in log if r.get("kind") == "load_shed"]
        assert any(r["event"] == "alert" for r in log)
        assert bool(sheds) == shed and (not shed or sheds[0]["count"] == 1)
        (tmp_path / "m.jsonl").unlink()


FLEET_ACTS = {"--replica": _act_replica,
              "--heartbeat-file": _act_heartbeat_file,
              "--fleet-register": _act_fleet_register,
              "--max-queue": _act_max_queue, "--shed-load": _act_shed_load}


@pytest.mark.parametrize("flag", sorted(FLEET_ACTS))
def test_fleet_flag_acts(tmp_path, flag):
    """Each fleet flag the driver refused with `NotPorted` until the
    serving fleet came does what the root driver's does."""
    assert flag not in sdriver.UNPORTED
    FLEET_ACTS[flag](tmp_path)


def test_driver_covers_every_root_flag():
    """Each flag the root `serve.py` declares is either one of the
    port's own or in its `UNPORTED` table, and the table names only
    root flags."""
    root = re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                      (ROOT / "serve.py").read_text())
    assert len(root) >= 30
    own = {o for a in sdriver.parser()._actions for o in a.option_strings
           if not isinstance(a, sdriver._Refuse)}
    missing = [f for f in root if f not in own and f not in sdriver.UNPORTED]
    assert not missing, missing
    assert set(sdriver.UNPORTED) <= set(root)
    assert not set(sdriver.UNPORTED) & own
