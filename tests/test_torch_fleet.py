"""The port's fleet collector (`shallowspeed_tpu_torch/telemetry/fleet.py`)
against the JAX package's, on the CPU.

The collector is host code: the same replica JSONL files, and the same
status payloads from the same endpoints, go through both collectors
under one fixed clock, and `refresh()`'s status, `status()`,
`prometheus()`, `format_fleet_status()`, the emitted straggler and alert
events and the register / deregister replies must be equal — exactly,
as both run the same pure-Python arithmetic. Neither collector touches
JAX; the reference's module is imported as it stands.
"""

import json
from pathlib import Path

import pytest

from shallowspeed_tpu.telemetry import fleet as RF
from shallowspeed_tpu_torch.telemetry import fleet as PF
from shallowspeed_tpu_torch.telemetry import schema as PS


def _jsonl(path, replica, ttfts, step_ms=(), wall0=100.0, label=True):
    """A metrics file for one replica: run_start (with its label), step
    lines, one request line per ttft."""
    wall = wall0
    lines = []
    if label:
        lines.append({"event": "run_start", "schema_version": 8,
                      "replica": replica, "wall": wall})
    for s, ms in enumerate(step_ms):
        wall += ms / 1e3
        lines.append({"event": "step", "step": s, "loss": 1.0,
                      "tokens_per_sec": 50.0, "wall": round(wall, 4)})
    for i, t in enumerate(ttfts):
        wall += 0.01
        lines.append({"event": "request", "id": f"{replica}-q{i}",
                      "ttft_ms": float(t), "tpot_ms": 3.0 + i % 3,
                      "tokens_in": 4, "tokens_out": 4,
                      "wall": round(wall, 4)})
    Path(path).write_text("".join(json.dumps(x) + "\n" for x in lines))
    return path


def _scrub(obj, roots):
    """The flight dumps' paths with each package's own directory
    replaced by a placeholder (the only place the two runs differ)."""
    text = json.dumps(obj, sort_keys=True)
    for root in roots:
        text = text.replace(str(root), "<dir>")
    return json.loads(text)


def _files_scenario(mod, d: Path):
    """Three replicas, c ~6x slower: patience 2 fires the straggler on
    the second refresh (with a flight dump), a merged-stream SLO burns,
    and c's recovery resolves the straggler."""
    d.mkdir()
    clock = [1000.0]
    reps = {"a": ([20.0] * 10, [50.0] * 9), "b": ([22.0] * 10, [52.0] * 9),
            "c": ([130.0] * 10, [300.0] * 9)}
    paths = [_jsonl(d / f"{r}.jsonl", r, t, s) for r, (t, s) in reps.items()]
    fc = mod.FleetCollector(
        paths=paths, slos="ttft_p95_ms<100", clock=lambda: clock[0],
        straggler_patience=2, straggler_min_count=4, flight=8,
        flight_dir=d, slo_kw=dict(fast_s=10, slow_s=60, min_count=10))
    out = []
    for step in range(3):
        if step == 2:
            _jsonl(d / "c.jsonl", "c", [21.0] * 300, [50.0] * 9)
        clock[0] += 1.0
        st = fc.refresh()
        out.append({"refresh": st, "status": fc.status(),
                    "prometheus": fc.prometheus(),
                    "table": mod.format_fleet_status(st),
                    "worst": fc.worst("ttft_ms", 3)})
    # a dump's own "wall" is the recorder's real clock, not the fixed one
    dumps = [{k: v for k, v in json.loads(Path(p).read_text()).items()
              if k != "wall"} for p in fc.flight.dumps]
    out.append({"events": fc.events, "counters": fc.counters,
                "dumps": dumps})
    return out, fc


def _payloads():
    """Status / sketch / profile payloads of three endpoints; "down"
    refuses every call."""
    from shallowspeed_tpu_torch.telemetry.monitor import Monitor

    out = {}
    for name, base, head in (("up-a", 10.0, 9), ("up-b", 90.0, -3)):
        mon = Monitor(label=name, flight=0, clock=lambda: 500.0)
        for i in range(12):
            mon.note_line({"event": "request", "id": f"{name}{i}",
                           "ttft_ms": base + i, "tpot_ms": 2.0 + i % 2,
                           "tokens_in": 3, "tokens_out": 5,
                           "wall": 100.0 + i})
        mon.note_line({"event": "generate", "tokens_per_sec": 40.0,
                       "queue_depth": 1, "active_slots": 2,
                       "free_blocks": 7, "headroom_blocks": head,
                       "live_blocks": 4, "blocks_needed": 3,
                       "wall": 113.0})
        out[f"http://{name}"] = {
            "/status.json": mon.status(),
            "/sketches.json": mon.sketch_payload(),
            "/profile.json": {"enabled": True, "samples": 40,
                              "folded": {f"main;{name};tick": 30,
                                         "main;idle": 10},
                              "phases": {"decode-tick": 30}}}
    return out


def _endpoint_scenario(mod, monkeypatch):
    payloads = _payloads()

    def fake_get(self, endpoint):
        if self.url not in payloads:
            raise ConnectionError(f"refused: {self.url}")
        return json.loads(json.dumps(payloads[self.url][endpoint]))

    monkeypatch.setattr(mod.Replica, "_get", fake_get)
    clock = [2000.0]
    fc = mod.FleetCollector(
        urls=["http://up-a/status.json", "http://down"],
        slos="availability>0.9,ttft_p95_ms<50", clock=lambda: clock[0],
        slo_kw=dict(fast_s=10, slow_s=100, warn_burn=2.0,
                    critical_burn=50.0, min_count=1))
    replies = [fc.register_replica({"url": "http://up-b/status.json",
                                    "name": "b"}),
               fc.register_replica({"url": "http://up-b/", "name": "b"})]
    out = []
    for _ in range(3):
        clock[0] += 30.0
        st = fc.refresh()
        out.append({"refresh": st, "prometheus": fc.prometheus(),
                    "table": mod.format_fleet_status(st),
                    "profile": fc.profile_payload()})
    replies.append(fc.deregister_replica({"name": "b"}))
    with pytest.raises(ValueError, match="deregister"):
        fc.deregister_replica({"url": "http://nowhere"})
    with pytest.raises(ValueError, match="register needs"):
        fc.register_replica({"url": "ftp://x"})
    clock[0] += 30.0
    st = fc.refresh()
    out.append({"replies": replies, "refresh": st,
                "table": mod.format_fleet_status(st), "events": fc.events})
    monkeypatch.undo()
    return out


def test_collector_files_equal_reference(tmp_path):
    """File replicas: status, /metrics text, the terminal table, the
    worst exemplars, straggler and alert events, counters and the
    flight dumps, refresh for refresh."""
    want, rfc = _files_scenario(RF, tmp_path / "ref")
    got, pfc = _files_scenario(PF, tmp_path / "port")
    roots = (tmp_path / "ref", tmp_path / "port")
    assert _scrub(got, roots) == _scrub(want, roots)
    # the scenario did what it says: c fired and resolved, the SLO fired
    kinds = [(e["event"], e.get("replica"), e["state"]) for e in pfc.events]
    assert ("straggler", "c", "firing") in kinds
    assert ("straggler", "c", "resolved") in kinds
    assert any(e["event"] == "alert" for e in pfc.events)
    assert all(PS.validate_line(e) == [] for e in pfc.events)
    assert "STRAGGLER c ttft_ms" in got[1]["table"]


def test_collector_endpoints_equal_reference(tmp_path, monkeypatch):
    """Endpoint replicas (one registered over the collector's surface,
    one refusing every call and backing off): the same payloads give
    the same fleet view, availability burn, profile merge and replies."""
    want = _endpoint_scenario(RF, monkeypatch)
    got = _endpoint_scenario(PF, monkeypatch)
    assert got == want
    st = got[0]["refresh"]
    assert st["fleet"]["alive"] == 2 and st["fleet"]["replicas"] == 3
    assert st["replicas"]["http://down"]["backoff"]["failures"] == 1
    assert st["memory"]["worst_headroom"] == {"replica": "b", "value": -3}
    assert got[-1]["replies"][-1]["removed"] == "b"


@pytest.mark.parametrize("case", ["colliding_names", "mixed_rel_err"])
def test_collector_edge_cases_equal_reference(tmp_path, case):
    """Two unlabelled files with one stem (display names get '#uid');
    replicas whose sketches differ in rel_err (the largest group
    merges)."""
    def run(mod, d):
        d.mkdir()
        if case == "colliding_names":
            paths = []
            for sub, t in (("A", 20.0), ("B", 200.0)):
                (d / sub).mkdir()
                paths.append(_jsonl(d / sub / "metrics.jsonl", "x",
                                    [t] * 10, label=False))
            fc = mod.FleetCollector(paths=paths, straggler_patience=1,
                                    straggler_min_count=4,
                                    straggler_metrics=("ttft_ms",),
                                    clock=lambda: 50.0)
        else:
            paths = [_jsonl(d / f"{r}.jsonl", r, [10.0 + i] * 4)
                     for i, r in enumerate("abc")]
            fc = mod.FleetCollector(paths=paths, clock=lambda: 50.0)
            from shallowspeed_tpu.telemetry.sketch import \
                MetricSketches as RS
            from shallowspeed_tpu_torch.telemetry.sketch import \
                MetricSketches as PSk
            fc.replicas[1]._mon.sketches = (RS if mod is RF
                                            else PSk)(rel_err=0.05)
        st = fc.refresh()
        return [st, fc.prometheus(), mod.format_fleet_status(st)]

    want = run(RF, tmp_path / "ref")
    got = run(PF, tmp_path / "port")
    roots = (tmp_path / "ref", tmp_path / "port")
    assert _scrub(got, roots) == _scrub(want, roots)
    if case == "colliding_names":
        assert set(got[0]["replicas"]) == {"metrics", "metrics#1"}
    else:
        assert got[0]["fleet"]["skipped_mixed_rel_err"] == 1


def test_fleet_main_once_and_endpoint(tmp_path, capsys):
    """`fleet_main` renders one refresh of files (the CLI's --fleet
    --once) and serves the fleet's own endpoint with --port."""
    import urllib.request

    _jsonl(tmp_path / "a.jsonl", "a", [10.0] * 4)
    assert PF.fleet_main([str(tmp_path / "a.jsonl")], once=True) == 0
    out = capsys.readouterr().out
    assert "fleet: 1/1 replicas alive" in out and "[a] up" in out
    assert PF.fleet_main([str(tmp_path / "missing.jsonl")], once=True) == 1
    seen = []

    def grab(line):
        seen.append(line)
        if line.startswith("fleet endpoint: "):
            url = line.split()[2]
            st = json.loads(urllib.request.urlopen(url, timeout=10).read())
            seen.append(st)

    assert PF.fleet_main([str(tmp_path / "a.jsonl")], once=True, port=0,
                         out=grab) == 0
    assert seen[1]["fleet"]["replicas"] == 1
