"""The supervised chaos canary of the port, end to end on the CPU (the
counterpart of the reference's `tests/test_chaos.py` canary and slow
acceptance run): `python -m shallowspeed_tpu_torch.elastic` supervising
`python -m shallowspeed_tpu_torch.train_lm` under the plan
`kill@9,corrupt@2,stall@5:0.3`.

- The port's fault-free run of the same flags is within 1e-4 of the
  root JAX driver's at every logged step (relative), and the drill ends
  on the fault-free run's losses bit for bit (a replay from the last
  verified checkpoint reproduces the trajectory: the data and dropout
  are pure functions of the step).
- Each planned fault fired once, stamped into the log (the fault lines
  validate under the port's schema); the corrupted checkpoint is
  quarantined as `.corrupt` and no "resumed from" names it.
- `run_goodput`: a restart, a crash MTTR, the fault tally, the stall
  named, >= 95 % of the wall accounted.

Children run on one intra-op thread (`OMP_NUM_THREADS=1`), so the
fault-free and supervised runs do the same arithmetic. The root driver
runs in this process with its walker-importing overlap module stood in
for (its `from_flags` returns the "off" plan, what the root driver gets
without --overlap on; jax 0.9 cannot import the module, ROADMAP Queue
3) and its SIGTERM handler put back.
"""

import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import pytest

from shallowspeed_tpu_torch.telemetry.goodput import run_goodput
from shallowspeed_tpu_torch.telemetry.schema import validate_file

ROOT = Path(__file__).resolve().parents[1]
ENV = {**{k: v for k, v in os.environ.items()
          if not k.startswith(("SHALLOWSPEED_CHAOS", "JAX_COORD",
                               "JAX_NUM_PROC", "JAX_PROCESS_ID"))},
       "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
COMMON = ["--seq-len", "32", "--d-model", "32", "--n-layers", "1",
          "--batch-size", "4", "--steps", "14", "--log-every", "2",
          "--prefetch", "0", "--save-every", "4"]
PORT = [sys.executable, "-m", "shallowspeed_tpu_torch.train_lm",
        "--device", "cpu", *COMMON]


def _faults_validate(log, tmp_path) -> list:
    """The log's fault lines (its checkpoint events are the port's own,
    which the schema, a copy of the reference's, does not know), and
    that they validate."""
    recs = [json.loads(x) for x in Path(log).read_text().splitlines()]
    faults = [r for r in recs if r.get("event") == "fault"]
    stamped = tmp_path / "faults.jsonl"
    stamped.write_text("".join(json.dumps(f) + "\n" for f in faults))
    assert validate_file(stamped) == []
    return faults


def _run(cmd, timeout=300):
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                       env=ENV, timeout=timeout)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r


def _losses(log) -> dict:
    """{step: loss} of a log's step lines, the last line of each step
    (a replayed step's second run)."""
    return {r["step"]: r["loss"] for r in map(json.loads,
                                             Path(log).read_text()
                                             .splitlines())
            if r.get("event") == "step"}


@pytest.fixture
def root_train(monkeypatch):
    """The root driver's `train` (see the module docstring)."""
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


def test_supervised_canary_matches_the_fault_free_run(tmp_path,
                                                      root_train):
    oracle = tmp_path / "oracle.jsonl"
    _run([*PORT, "--save-dir", str(tmp_path / "oracle_ck"),
          "--log-file", str(oracle)])
    root = tmp_path / "root.jsonl"
    root_train([*COMMON, "--log-file", str(root)])
    ours, theirs = _losses(oracle), _losses(root)
    assert sorted(ours) == sorted(theirs) == [0, 2, 4, 6, 8, 10, 12, 13]
    for step, loss in theirs.items():
        assert abs(ours[step] - loss) <= 1e-4 * abs(loss), (step, ours,
                                                             theirs)

    log = tmp_path / "chaos.jsonl"
    r = _run([sys.executable, "-m", "shallowspeed_tpu_torch.elastic",
              "--max-restarts", "4", "--backoff", "0.3", "--term-grace",
              "3", "--chaos", "kill@9,corrupt@2,stall@5:0.3",
              "--chaos-state", str(tmp_path / "cs"), "--", *PORT,
              "--save-dir", str(tmp_path / "ck"), "--auto-resume",
              "--log-file", str(log)], timeout=600)
    assert _losses(log) == ours                       # bit for bit
    corrupt = [p.name for p in (tmp_path / "ck").iterdir()
               if ".corrupt" in p.name]
    assert corrupt == ["ckpt_7.corrupt"]
    resumed = [x for x in r.stdout.splitlines() if "resumed from" in x]
    assert resumed and not any(".corrupt" in x for x in resumed)
    assert "[elastic] attempt 2" in r.stdout
    assert sorted(x["kind"] for x in _faults_validate(log, tmp_path)) == [
        "corrupt", "kill", "stall"]
    rep = run_goodput(log)
    assert rep["counts"]["restarts"] >= 1
    assert rep["mttr"].get("crash", {}).get("count", 0) >= 1
    assert rep["faults"] == {"corrupt": 1, "kill": 1, "stall": 1}
    assert rep["losses"].get("data_stall", 0) > 0
    assert rep["accounted_frac"] >= 0.95, rep


def test_sigterm_exits_within_the_grace(tmp_path):
    """The driver under the supervisor's SIGTERM: a prefetch producer
    asleep in a 60 s stall and an `AsyncSaver` do not hold the exit; it
    exits 143 at once, the log's lines so far on disk."""
    import signal
    import time

    log = tmp_path / "m.jsonl"
    proc = subprocess.Popen(
        [*PORT, "--steps", "60", "--prefetch", "2", "--async-save",
         "--save-dir", str(tmp_path / "ck"), "--save-every", "1",
         "--chaos", "stall@3:60", "--log-file", str(log)],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        t0 = time.monotonic()
        while not (log.exists() and '"fault"' in log.read_text()):
            assert proc.poll() is None and time.monotonic() - t0 < 120
            time.sleep(0.1)
        time.sleep(1.0)          # the loop is now waiting on the producer
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 143
        assert time.monotonic() - t0 < 5
    finally:
        if proc.poll() is None:
            proc.kill()
    steps = _losses(log)
    assert 2 in steps and 3 not in steps


@pytest.mark.slow
def test_multi_fault_acceptance(tmp_path):
    """The reference's slow acceptance run in the port: a kill inside
    the third save, a corrupted fourth save, a NaN-poisoned leaf (the
    health monitor's abort), a heartbeat freeze and a 45 s stall (the
    supervisor's hang kill): the run ends on the fault-free run's last
    loss, never resumes a corrupted checkpoint, names >= 95 %
    of the wall, with crash and hang MTTRs."""
    base = ["--seq-len", "32", "--d-model", "32", "--n-layers", "1",
            "--batch-size", "4", "--steps", "24", "--log-every", "2",
            "--prefetch", "0", "--save-every", "4", "--health", "monitor"]
    port = [sys.executable, "-m", "shallowspeed_tpu_torch.train_lm",
            "--device", "cpu", *base]
    oracle = tmp_path / "oracle.jsonl"
    _run([*port, "--save-dir", str(tmp_path / "oracle_ck"),
          "--log-file", str(oracle)])
    log = tmp_path / "chaos.jsonl"
    r = _run([sys.executable, "-m", "shallowspeed_tpu_torch.elastic",
              "--max-restarts", "6", "--backoff", "0.3", "--hang-timeout",
              "30", "--term-grace", "5", "--chaos",
              "stall@4:0.4,kill_in_save@3,corrupt@4,nan@13,freeze@17,"
              "stall@19:45", "--chaos-state", str(tmp_path / "cs"), "--",
              *port, "--save-dir", str(tmp_path / "ck"), "--auto-resume",
              "--log-file", str(log)], timeout=900)
    assert _losses(log)[23] == _losses(oracle)[23]
    faults = _faults_validate(log, tmp_path)
    assert {x["kind"] for x in faults} == {
        "stall", "kill_in_save", "corrupt", "nan", "freeze"}, faults
    corrupted, = [x["path"] for x in faults if x["kind"] == "corrupt"]
    resumed = [x for x in r.stdout.splitlines() if "resumed from" in x]
    corrupt_dir = str(Path(corrupted).parent)
    assert resumed and not any(x.endswith(corrupt_dir) or
                               corrupt_dir + " " in x for x in resumed)
    rep = run_goodput(log)
    assert rep["counts"]["restarts"] >= 3
    assert "crash" in rep["mttr"] and "hang" in rep["mttr"], rep["mttr"]
    assert rep["accounted_frac"] >= 0.95, rep
