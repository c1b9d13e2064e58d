"""The port's live monitor (`shallowspeed_tpu_torch/telemetry/monitor.py`)
against the JAX package's on the same inputs: the same JSONL lines (made
from a numpy seed) give equal `status()`, emitted snapshots and alerts,
`/metrics` text and flight-recorder dumps; `parse_slos` gives equal
rules, whose burn-rate alerts fire on the same observations (a blip, a
slow bleed, a recovery); the `StatusServer` on port 0 serves what
`status()` returns and a port in use raises `PortInUseError`; the
tailer and `live_main --once` follow a growing file."""

import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from shallowspeed_tpu.telemetry import monitor as RM
from shallowspeed_tpu_torch.telemetry import monitor as PM
from torch_parity import ref_telemetry  # noqa: F401  (fixture)

SLOS = "ttft_p95_ms<40,step_p95_ms<150,tok_s_p50<900,availability>0.99"


def _lines(seed=0, n=120) -> list[dict]:
    """A run's metrics lines of every kind the monitor handles: step
    lines (some with health, numerics and memory fields and verdicts),
    requests, generate ticks, lifecycle transitions, ledger stamps
    (restart downtime, an OOM), a fault, an alert of another process,
    a profile snapshot — walls from a seeded clock."""
    rng = np.random.default_rng(seed)
    wall = 1.7e9
    out = [{"event": "run_start", "wall": wall, "t": 0.0}]
    step = 0
    for i in range(n):
        wall += float(rng.uniform(0.05, 0.6))
        kind = int(rng.integers(0, 9))
        if kind <= 2:
            rec = {"event": "step", "step": step,
                   "loss": round(float(rng.uniform(1, 6)), 6),
                   "tokens_per_sec": round(float(rng.uniform(200, 2e3)), 1),
                   "mfu": None, "hbm_live_mib": round(float(
                       rng.uniform(10, 90)), 2),
                   "host_rss_mib": 300.0 + i}
            if i % 17 == 5:
                rec["health_verdicts"] = ["loss_spike"]
            if i % 23 == 7:
                rec["num_scale_min"] = 0.5
                rec["num_precision"] = "fp8"
            if i % 29 == 11:
                rec["mem_verdicts"] = ["mem_leak"]
            step += int(rng.integers(1, 3))
        elif kind <= 4:
            rid = f"r{i}"
            for ph, prev in (("submit", None), ("queued", "submit"),
                             ("prefill", "queued"),
                             ("decoding", "prefill"),
                             ("finished", "decoding")):
                lc = {"event": "lifecycle", "id": rid, "phase": ph,
                      "wall": wall, "trace": f"t{i}"}
                if prev is not None:
                    lc.update(prev=prev, ms_in_prev=round(float(
                        rng.uniform(0.1, 30)), 3))
                out.append(lc)
            rec = {"event": "request", "id": rid,
                   "ttft_ms": round(float(rng.gamma(2.0, 12.0)), 3),
                   "tpot_ms": round(float(rng.gamma(2.0, 2.0)), 3),
                   "tokens_in": 16, "tokens_out": 8,
                   "queue_depth": int(rng.integers(0, 5))}
        elif kind == 5:
            rec = {"event": "generate",
                   "tokens_per_sec": round(float(rng.uniform(100, 1e3)), 1),
                   "queue_depth": int(rng.integers(0, 6)),
                   "active_slots": 3, "free_blocks": int(rng.integers(0,
                                                                      64)),
                   "spec_accept_rate": 0.5, "headroom_blocks": 7}
        elif kind == 6:
            rec = {"event": "ledger", "kind": "val",
                   "seconds": round(float(rng.uniform(0.01, 0.3)), 6)}
            if i % 3 == 0:
                rec = {"event": "ledger", "kind": "restart_downtime",
                       "seconds": 2.5, "fail_class": "crash"}
        elif kind == 7:
            rec = {"event": "health", "step": step,
                   "health_verdicts": ["grad_norm_spike"]} \
                if i % 2 else {"event": "ledger", "kind": "oom",
                               "requested": 4, "free": 1, "cold": 0,
                               "tick": i}
        else:
            rec = {"event": "fault", "kind": "stall", "step": step} \
                if i % 2 else {"event": "profile", "samples": i,
                               "folded": {"a;b": i}}
        rec["wall"] = round(wall, 3)
        rec.setdefault("t", round(wall - 1.7e9, 3))
        out.append(rec)
    return out


def _monitor(mod, tmp_path, name, emitted, **kw):
    d = tmp_path / name
    return mod.Monitor(slos=SLOS, flight=32, flight_dir=d,
                       derive_steps=True, snapshot_every=16,
                       clock=lambda: 1.7e9,
                       emit=lambda **rec: emitted.append(rec), **kw)


def _strip(status: dict) -> dict:
    """A status without its flight-dump paths' directories (each monitor
    dumps into its own)."""
    out = dict(status)
    out["flight_dumps"] = [p.rsplit("/", 1)[-1]
                           for p in status["flight_dumps"]]
    return out


def _dumps(paths) -> list:
    """The flight dumps' contents without the dump-time wall stamp."""
    out = []
    for p in paths:
        d = json.loads(open(p).read())
        d.pop("wall")
        out.append(d)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monitor_status_snapshots_alerts_and_metrics_equal(
        tmp_path, ref_telemetry, seed):  # noqa: F811
    lines = _lines(seed)
    got_emit, want_emit = [], []
    ref = _monitor(RM, tmp_path, "ref", want_emit)
    port = _monitor(PM, tmp_path, "port", got_emit)
    for rec in lines:
        ref.note_line(dict(rec))
        port.note_line(dict(rec))
    assert port.counters["alerts"] > 0 and port.counters["snapshots"] > 0
    assert port.counters["flight_dumps"] > 0
    assert _strip(port.status()) == _strip(ref.status())
    assert got_emit == want_emit
    assert port.prometheus() == ref.prometheus()
    assert port.sketch_payload() == ref.sketch_payload()
    assert port.profile_payload() == ref.profile_payload()
    assert _dumps(port.flight.dumps) == _dumps(ref.flight.dumps)
    port.close()
    ref.close()
    assert got_emit == want_emit


def test_parse_slos_equal_and_bad_specs_refused():
    specs = ["ttft_p95_ms<500", "tpot_p50_ms < 12.5",
             "availability>0.999", "step_p99_ms<1e3", "tok_s_p10>100"]
    for spec in specs:
        (r,), (p,) = RM.parse_slos(spec), PM.parse_slos(spec)
        assert vars(p).keys() == vars(r).keys()
        for k in ("spec", "metric", "op", "threshold", "sketch", "q",
                  "budget", "fast_s", "slow_s", "min_count"):
            assert getattr(p, k) == getattr(r, k), k
    assert PM.parse_slos("") == [] == RM.parse_slos(" ")
    for bad in ("ttft<5", "availability<0.9", "availability>1.5",
                "step_p100_ms<4", "x_p95_ms=3"):
        with pytest.raises(ValueError) as want:
            RM.parse_slos(bad)
        with pytest.raises(ValueError) as got:
            PM.parse_slos(bad)
        assert str(got.value) == str(want.value)


def _scenario(name):
    """(times, values) of one SLO story over a ttft_p95_ms<50 rule."""
    t = np.arange(0.0, 900.0, 2.0)
    v = np.full(t.shape, 10.0)
    if name == "blip":             # 20 s of bad: fast burns, slow not
        v[(t >= 300) & (t < 320)] = 99.0
    elif name == "slow_bleed":     # 12% bad all along: both burn
        v[::8] = 99.0
    elif name == "recovery":       # sustained bad, then healthy again
        v[(t >= 100) & (t < 500)] = 99.0
    return t, v


@pytest.mark.parametrize("name", ["blip", "slow_bleed", "recovery"])
def test_burn_rate_alerts_fire_on_the_same_observations(name):
    t, v = _scenario(name)
    (r,), (p,) = RM.parse_slos("ttft_p95_ms<50"), PM.parse_slos(
        "ttft_p95_ms<50")
    want, got = [], []
    for now, x in zip(t, v):
        r.record(float(x), float(now))
        p.record(float(x), float(now))
        want.append(r.evaluate(float(now)))
        got.append(p.evaluate(float(now)))
        assert p.status(float(now)) == r.status(float(now))
    assert got == want
    fired = [a for a in got if a is not None]
    if name == "blip":
        assert fired == []
    else:
        assert fired and fired[0]["state"] == "firing"
    if name == "recovery":
        assert fired[-1]["state"] == "resolved"


def test_availability_rule_burns_on_downtime_alike():
    (r,), (p,) = (RM.parse_slos("availability>0.99"),
                  PM.parse_slos("availability>0.99"))
    for mod, rule in ((RM, r), (PM, p)):
        rule.record_down(30.0, 100.0)
    assert p.evaluate(100.0) == r.evaluate(100.0)
    assert p.status(400.0) == r.status(400.0)


def test_flight_recorder_ring_dedup_and_cap(tmp_path):
    for mod, name in ((RM, "ref"), (PM, "port")):
        fr = mod.FlightRecorder(capacity=4, out_dir=tmp_path / name,
                                max_dumps=2)
        for i in range(10):
            fr.record({"event": "step", "step": i})
        assert fr.dump("slo:x", step=3) is not None
        assert fr.dump("slo:x", step=3) is None        # dedup
        assert fr.dump("fault:y") is not None
        assert fr.dump("fault:z", step=9) is None      # capped
    assert _dumps(sorted((tmp_path / "port").iterdir())) == _dumps(
        sorted((tmp_path / "ref").iterdir()))


def test_prom_helpers_equal():
    from shallowspeed_tpu.telemetry.sketch import LogHistogram as RH
    from shallowspeed_tpu_torch.telemetry.sketch import LogHistogram as PH

    rng = np.random.default_rng(3)
    vals = rng.lognormal(2.0, 1.5, 500)
    rh, ph = RH(), PH()
    for x in vals:
        rh.add(float(x))
        ph.add(float(x))
    assert PM.prom_histogram_lines("b", ph, 'replica="r0",') == \
        RM.prom_histogram_lines("b", rh, 'replica="r0",')
    assert PM.prom_histogram_lines("b", ph) == RM.prom_histogram_lines(
        "b", rh)
    assert PM.prom_escape('a"b\\c\nd') == RM.prom_escape('a"b\\c\nd')
    assert PM.HIST_LE == RM.HIST_LE and PM.CORE_SKETCHES == RM.CORE_SKETCHES


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_status_server_serves_status_and_metrics(tmp_path):
    mon = PM.Monitor(slos="step_p95_ms<100", flight=0)
    for rec in _lines(4, 40):
        if rec["event"] not in ("lifecycle",):
            mon.note_line(rec)
    srv = PM.StatusServer(mon, port=0)
    try:
        code, body = _get(srv.url("/status.json"))
        assert code == 200
        assert json.loads(body) == json.loads(json.dumps(mon.status(),
                                                         default=str))
        code, body = _get(srv.url("/metrics"))
        assert body == mon.prometheus()
        assert "shallowspeed_up 1" in body
        assert json.loads(_get(srv.url("/sketches.json"))[1]) == \
            json.loads(json.dumps(mon.sketch_payload()))
        assert json.loads(_get(srv.url("/profile.json"))[1]) == \
            mon.profile_payload()
        with pytest.raises(urllib.error.HTTPError) as miss:
            _get(srv.url("/nope"))
        assert miss.value.code == 404
    finally:
        srv.close()


def test_status_server_port_in_use_raises():
    mon = PM.Monitor(flight=0)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(1)
    try:
        with pytest.raises(PM.PortInUseError, match="--monitor-port"):
            PM.StatusServer(mon, port=sock.getsockname()[1])
    finally:
        sock.close()


def test_tailer_and_live_once_follow_a_growing_file(tmp_path):
    path = tmp_path / "m.jsonl"
    lines = [r for r in _lines(5, 60) if r["event"] != "lifecycle"]
    half = len(lines) // 2
    text = "".join(json.dumps(r) + "\n" for r in lines)
    cut = len("".join(json.dumps(r) + "\n" for r in lines[:half]))
    path.write_text(text[:cut + 7])            # a torn trailing line
    mon = PM.Monitor(flight=0, derive_steps=True, snapshot_every=0)
    tail = PM.FileTailer(path, mon, poll=0.05)
    assert tail.drain() == half
    with open(path, "a") as f:
        f.write(text[cut + 7:])
    assert tail.drain() == len(lines) - half
    ref = RM.Monitor(flight=0, derive_steps=True, snapshot_every=0)
    for rec in lines:
        ref.note_line(rec)
    assert mon.status() == ref.status()
    out = []
    assert PM.live_main(str(path), slos="step_p95_ms<100", once=True,
                        out=out.append) == 0
    want = []
    RM.live_main(str(path), slos="step_p95_ms<100", once=True,
                 out=want.append)
    assert out[1:] == want[1:] and "uptime" in out[1]
    assert PM.live_main(str(tmp_path / "none.jsonl"), once=True,
                        out=out.append) == 1
