"""The port's goodput ledger and reducer (`shallowspeed_tpu_torch/
telemetry/goodput.py`) against the JAX package's: `run_goodput` and
`format_report` of both packages are equal on the same logs (a straight
run, a restart with replayed steps, data stalls, guarded skipped
steps, fp8 fallbacks, a serving run with monitor snapshots, lifecycle,
prefix, memory and profile lines); each package's reducer reads the other's driver
log (a 2-layer `train_lm` of each, 3 steps); the port's `StepRates`
windows plus the excluded ledger seconds equal the wall clock, as
`tests/test_goodput.py` pins for the reference's."""

import json
import signal
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from shallowspeed_tpu_torch.metrics import MetricsLogger, StepRates
from shallowspeed_tpu_torch.telemetry import goodput as PG
from shallowspeed_tpu_torch.telemetry.monitor import Monitor
from shallowspeed_tpu_torch.telemetry.schema import validate_file
from torch_parity import ref_telemetry  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent


def _stanza(rng, wall, start_step, n_steps, *, stalls=False, skips=False,
            fp8=False, replica=None):
    """One process's lines: run_start, init/restore, steps at a seeded
    cadence with val/ckpt pauses, and the optional in-window losses."""
    recs = [{"event": "run_start", "start_step": start_step,
             "wall": round(wall, 3), "t": 0.0,
             **({"replica": replica} if replica else {})}]
    t0 = wall
    init = float(rng.uniform(0.5, 2.0))
    wall += init
    recs.append({"event": "ledger", "kind": "init",
                 "seconds": round(init, 6)})
    if start_step:
        wall += 0.7
        recs.append({"event": "ledger", "kind": "restore", "seconds": 0.7})
    wall += float(rng.uniform(0.5, 1.5))      # the first window's build
    skipped = 0
    for s in range(start_step, start_step + n_steps):
        wall += float(rng.uniform(0.09, 0.11))
        rec = {"event": "step", "step": s, "loss": 2.0,
               "tokens_per_sec": 100.0}
        if skips and s % 4 == 3:
            skipped += 1
            rec["health_skipped_total"] = skipped
        recs.append(rec)
        if s % 5 == 4:
            pause = float(rng.uniform(0.1, 0.4))
            wall += pause
            recs.append({"event": "ledger", "kind": "val",
                         "seconds": round(pause, 6)})
        if s % 7 == 6:
            wall += 0.3
            recs.append({"event": "ledger", "kind": "ckpt_save",
                         "seconds": 0.3})
        if stalls and s % 3 == 1:
            stall = float(rng.uniform(0.02, 0.05))
            wall += stall
            recs.append({"event": "ledger", "kind": "data_stall",
                         "seconds": round(stall, 6)})
        if skips and s % 4 == 3:
            recs.append({"event": "ledger", "kind": "skipped_steps",
                         "count": 1})
        if fp8 and s == start_step + 2:
            recs.append({"event": "ledger", "kind": "fp8_fallback",
                         "count": 1})
            recs.append({"event": "ledger", "kind": "shadow_parity",
                         "seconds": 0.05})
        recs[-1]["wall"] = round(wall, 3)
    # stamp walls on lines that lack one (the ledger lines ride between)
    w = t0
    for r in recs:
        if "wall" in r:
            w = r["wall"]
        else:
            r["wall"] = round(w, 3)
        r.setdefault("t", round(r["wall"] - t0, 3))
    return recs, wall


def _serving(rng, wall):
    """A serving stanza: requests, lifecycle lines, generate ticks with
    prefix and headroom gauges, a profile snapshot and a monitor
    snapshot made by the port's Monitor over the same requests."""
    recs = [{"event": "run_start", "wall": wall, "t": 0.0}]
    mon = Monitor(flight=0, snapshot_every=0)
    for i in range(24):
        wall += float(rng.uniform(0.01, 0.2))
        rid = f"q{i}"
        for ph, prev in (("submit", None), ("queued", "submit"),
                         ("prefill", "queued"), ("decoding", "prefill"),
                         ("finished", "decoding")):
            lc = {"event": "lifecycle", "id": rid, "phase": ph,
                  "wall": round(wall, 3), "trace": f"tr{i}"}
            if prev:
                lc.update(prev=prev, ms_in_prev=round(float(
                    rng.uniform(0.5, 9.0)), 3))
            recs.append(lc)
        req = {"event": "request", "id": rid,
               "ttft_ms": round(float(rng.gamma(2.0, 9.0)), 3),
               "tpot_ms": round(float(rng.gamma(2.0, 1.5)), 3),
               "tokens_in": 32, "tokens_out": 8, "preempted": i % 5 == 0,
               "prefix_hit_blocks": i % 3,
               "prefill_skipped_tokens": 16 * (i % 3),
               "wall": round(wall, 3)}
        req["preempted"] = int(req["preempted"])
        recs.append(req)
        mon.note_line(req)
        if i % 6 == 5:
            recs.append({"event": "generate", "tokens_per_sec": 400.0,
                         "prefix_hit_rate": 0.5, "cold_blocks": 3,
                         "prefix_blocks": 5, "headroom_blocks": 9 - i // 6,
                         "live_blocks": 20, "wall": round(wall, 3)})
    snap = mon.snapshot()
    recs.append({"event": "monitor", **snap, "wall": round(wall, 3)})
    recs.append({"event": "profile", "samples": 40, "step_samples": 30,
                 "phases": {"step": 30, "gateway": 10},
                 "folded": {"main;loop;step": 30, "main;gw": 10},
                 "other": 2, "wall": round(wall, 3)})
    recs.append({"event": "ledger", "kind": "oom", "requested": 6,
                 "free": 1, "cold": 2, "tick": 9, "wall": round(wall, 3)})
    return recs


def _log(kind: str, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    if kind == "straight":
        return _stanza(rng, 1.7e9, 0, 20)[0]
    if kind == "restart":
        a, w = _stanza(rng, 1.7e9, 0, 14)
        b, w = _stanza(rng, w + 3.0, 7, 12)
        b.insert(1, {"event": "ledger", "kind": "restart_downtime",
                     "seconds": 2.5, "fail_class": "crash",
                     "wall": b[0]["wall"]})
        c, _ = _stanza(rng, w + 2.0, 15, 5)
        return a + b + c
    if kind == "stalls":
        return _stanza(rng, 1.7e9, 0, 20, stalls=True)[0]
    if kind == "skipped":
        return _stanza(rng, 1.7e9, 0, 20, skips=True)[0]
    if kind == "fp8":
        return _stanza(rng, 1.7e9, 0, 12, fp8=True)[0]
    if kind == "serving":
        return _serving(rng, 1.7e9)
    raise AssertionError(kind)


KINDS = ["straight", "restart", "stalls", "skipped", "fp8", "serving"]


@pytest.mark.parametrize("kind", KINDS)
def test_run_goodput_and_report_equal_the_reference(tmp_path, kind,
                                                    ref_telemetry):  # noqa: F811
    from shallowspeed_tpu.telemetry import goodput as RG

    path = tmp_path / f"{kind}.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in _log(kind, 3)))
    assert validate_file(path) == []
    got, want = PG.run_goodput(path), RG.run_goodput(path)
    assert got == want
    assert PG.format_report(got) == RG.format_report(want)
    if kind == "restart":
        assert got["stanzas"] == 3 and got["counts"]["replayed_steps"] > 0
        assert "restart_downtime" in got["losses"]
    if kind == "stalls":
        assert got["losses"]["data_stall"] > 0
    if kind == "skipped":
        assert got["counts"]["skipped_steps"] == 5
        assert got["losses"]["skipped_steps"] > 0
    if kind == "fp8":
        assert got["counts"]["fp8_fallback"] == 1
        assert got["losses"]["shadow_parity"] == 0.05
    if kind == "serving":
        assert got["monitor"]["parity"] and all(
            v["within_bound"] for v in got["monitor"]["parity"].values())
        for block in ("requests", "lifecycle", "profiling", "prefix",
                      "memory"):
            assert got[block] is not None, block


def test_ledger_and_stamp_lines_alike(tmp_path):
    from shallowspeed_tpu.telemetry import goodput as RG

    assert PG.EXCLUDED_KINDS == RG.EXCLUDED_KINDS
    log = tmp_path / "m.jsonl"
    led = PG.GoodputLedger(MetricsLogger(log))
    led.note("init", seconds=1.5)
    led.note("recompiles", count=2)
    led.note("val", seconds=0.5)
    led.note("val", seconds=0.25)
    PG.stamp_ledger_line(log, "restart_downtime", seconds=1.0,
                         fail_class="crash")
    assert validate_file(log) == []
    assert led.seconds() == {"init": 1.5, "val": 0.75}
    assert led.counts() == {"recompiles": 2}
    assert led.excluded_seconds() == 2.25
    kinds = [json.loads(x).get("kind") for x in
             log.read_text().splitlines()[1:]]
    assert kinds == ["init", "recompiles", "val", "val", "restart_downtime"]


def test_steprates_windows_plus_excluded_ledger_equals_wall():
    """Every `StepRates.pause` also stamps the ledger, so the windows'
    seconds plus the excluded ledger seconds equal the elapsed wall
    clock exactly; the monitor sees each window's step time."""
    t = {"now": 100.0}
    led = PG.GoodputLedger()
    mon = Monitor(flight=0, snapshot_every=0, clock=lambda: t["now"])
    rates = StepRates(10, clock=lambda: t["now"], ledger=led, monitor=mon)
    win = []

    def log(steps):
        win.append(10 * steps / rates.log_point(steps)["tokens_per_sec"])

    t["now"] += 4.0
    log(4)
    t["now"] += 2.0
    rates.pause(2.0, kind="val")
    t["now"] += 3.0
    log(3)
    t["now"] += 1.5
    rates.pause(1.5, kind="ckpt_save")
    t["now"] += 0.5
    rates.pause(0.00001, kind="telemetry")     # below the stamp floor
    log(1)
    assert sum(win) + led.excluded_seconds() == pytest.approx(
        t["now"] - 100.0)
    assert led.seconds() == {"val": 2.0, "ckpt_save": 1.5}
    sk = mon.sketches.sketches["step_ms"]
    assert sk.n == 8 and sk.quantile(50) == pytest.approx(1000.0, rel=0.02)


def test_steprates_stamps_guarded_skip_deltas():
    class Health:
        def __init__(self):
            self.total = 0

        def step_fields(self):
            return {"health_skipped_total": self.total}

    h = Health()
    led = PG.GoodputLedger()
    rates = StepRates(10, health=h, ledger=led)
    for total in (0, 2, 2, 5):
        h.total = total
        rates.log_point(1)
    assert led.counts() == {"skipped_steps": 5}


@pytest.fixture
def root_train(monkeypatch):
    """The root `train_lm.train`, its walker-importing overlap module
    stood in for (jax 0.9 cannot import it; ROADMAP Queue 3) and its
    SIGTERM handler put back."""
    monkeypatch.setitem(sys.modules, "shallowspeed_tpu.parallel.overlap",
                        types.SimpleNamespace(from_flags=lambda m, b: None))
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("train_lm", None)
    import train_lm as root

    handler = signal.getsignal(signal.SIGTERM)
    try:
        yield lambda argv: root.train(root.parse_args(argv))
    finally:
        signal.signal(signal.SIGTERM, handler)
        sys.modules.pop("train_lm", None)


LM = ["--seq-len", "32", "--d-model", "32", "--n-heads", "4",
      "--n-layers", "2", "--batch-size", "4", "--steps", "3",
      "--log-every", "1", "--val-every", "2"]


def test_each_reducer_reads_the_other_drivers_log(tmp_path, root_train,
                                                  ref_telemetry):  # noqa: F811
    from shallowspeed_tpu.telemetry import goodput as RG
    from shallowspeed_tpu_torch import train_lm as tdriver

    port_log, root_log = tmp_path / "port.jsonl", tmp_path / "root.jsonl"
    tdriver.main(["--device", "cpu", *LM, "--log-file", str(port_log)])
    root_train([*LM, "--log-file", str(root_log)])
    for log in (port_log, root_log):
        assert validate_file(log) == []
        kinds = {json.loads(x).get("kind") for x in
                 log.read_text().splitlines() if '"ledger"' in x}
        assert {"init", "val"} <= kinds, (log, kinds)
        got, want = PG.run_goodput(log), RG.run_goodput(log)
        assert got == want
        assert PG.format_report(got) == RG.format_report(want)
        assert got["stanzas"] == 1 and 0.0 < got["goodput"] <= 1.0
        assert got["losses"]["init"] > 0 and got["losses"]["val"] > 0
        assert got["accounted_frac"] >= 0.95, got
