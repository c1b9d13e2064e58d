"""The port's supervisor (`shallowspeed_tpu_torch/elastic.py`) against
the JAX package's (`shallowspeed_tpu/elastic.py`) where a function is
pure, and against tiny Python children where it supervises:

- `RestartPolicy`: budget, doubling, the cap, refill after a healthy
  run, per-class streams, seeded jitter — the same delays as the
  reference's for the same calls; `classify_exit`, the heartbeat
  status, `EXIT_CORRUPT_CKPT` (one constant, the checkpoint module's);
- `Supervisor`: restarts until success, gives up with the child's code,
  kills a hung child (also when its heartbeat file is deleted), stamps
  every failure class (crash, corrupt_ckpt, numeric, hang) into the
  ledger, aborts a poison step with a forensic snapshot, gives a child
  its SIGTERM grace, removes only the heartbeat files it made; the
  CLI's refusals;
- `GangSupervisor` with stub members: the three variables injected on a
  fresh port, a member's failure or hang restarts the whole gang, its
  heartbeat files removed, `--monitor-port` refused (`NotPorted`).

The training gang drill is `test_torch_elastic_gang.py`; the LM canary
`test_torch_chaos_drill.py`.
"""

import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from shallowspeed_tpu import elastic as JE
from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import elastic as E
from shallowspeed_tpu_torch.elastic import (GangSupervisor, RestartPolicy,
                                            Supervisor)

QUIET = dict(log=lambda *_: None)


# ------------------------------------------------------------- policy


def _delays(M, calls, **kw):
    p = M.RestartPolicy(**kw)
    out = []
    for c in calls:
        if isinstance(c, float):
            p.record_run(c)
            out.append(("run", c))
        else:
            out.append(p.next_restart(c))
    return out


@pytest.mark.parametrize("kw,calls", [
    (dict(max_restarts=3, backoff=1.0, backoff_max=3.0), [None] * 4),
    (dict(max_restarts=1, backoff=1.0, healthy_after=10.0),
     [None, None, 11.0, None]),
    (dict(max_restarts=1, backoff=1.0, healthy_after=10.0),
     [None, 2.0, None]),
    (dict(max_restarts=10, backoff=1.0, backoff_max=64.0),
     ["crash", "crash", "hang", "crash", "hang", 1e9, "crash", "hang"]),
    (dict(max_restarts=4, backoff=2.0, jitter=0.5, seed=7),
     ["crash"] * 3 + ["numeric"]),
])
def test_policy_matches_reference(kw, calls):
    got = _delays(E, calls, **kw)
    assert got == _delays(JE, calls, **kw)
    if "jitter" not in kw:
        return
    assert got[:3] == _delays(E, calls, **kw)[:3]     # seeded
    for base, d in zip([2.0, 4.0, 8.0], got):
        assert base <= d <= base * 1.5
    assert _delays(E, calls, **{**kw, "seed": 8}) != got


def test_policy_arithmetic():
    p = RestartPolicy(max_restarts=3, backoff=1.0, backoff_max=3.0,
                      healthy_after=60.0)
    assert [p.next_restart() for _ in range(4)] == [1.0, 2.0, 3.0, None]


def test_exit_classes_and_heartbeat(tmp_path):
    assert E.EXIT_CORRUPT_CKPT is C.EXIT_CORRUPT_CKPT
    assert E.EXIT_CORRUPT_CKPT == JE.EXIT_CORRUPT_CKPT
    assert E.FAIL_CLASSES == JE.FAIL_CLASSES
    for code in (0, 1, 65, -9, 143):
        assert E.classify_exit(code) == JE.classify_exit(code)
    hb = tmp_path / "hb"
    assert E.read_heartbeat_status(hb) == "ok"        # missing
    E.write_heartbeat(hb, "dead nonfinite gradients")
    assert E.read_heartbeat_status(hb) == JE.read_heartbeat_status(hb) \
        == "dead nonfinite gradients"
    hb.write_text("")
    assert E.read_heartbeat_status(hb) == "ok"


# --------------------------------------------------------- supervisor


def _script(tmp_path, body, name="child.py") -> list:
    f = tmp_path / name
    f.write_text(textwrap.dedent(body))
    return [sys.executable, str(f)]


def _attempts(marker):
    """Child-side counter: `n` is the attempt number from 0."""
    return f"""
        from pathlib import Path
        m = Path({str(marker)!r})
        n = int(m.read_text()) if m.exists() else 0
        m.write_text(str(n + 1))
    """


def _stamps(path, kind):
    return [json.loads(x) for x in Path(path).read_text().splitlines()
            if json.loads(x).get("kind") == kind]


def test_supervisor_restarts_until_success(tmp_path):
    marker = tmp_path / "attempts"
    cmd = _script(tmp_path, _attempts(marker) + """
        raise SystemExit(0 if n >= 2 else 1)
    """)
    sup = Supervisor(cmd, RestartPolicy(max_restarts=5, backoff=0.01),
                     poll_interval=0.05, **QUIET)
    assert sup.run() == 0
    assert marker.read_text() == "3"


def test_supervisor_gives_up_when_budget_exhausted(tmp_path):
    log = tmp_path / "m.jsonl"
    log.write_text("")
    cmd = _script(tmp_path, "raise SystemExit(7)")
    sup = Supervisor(cmd, RestartPolicy(max_restarts=2, backoff=0.01),
                     poll_interval=0.05, ledger_file=str(log), **QUIET)
    assert sup.run() == 7
    assert [r["fail_class"] for r in _stamps(log, "restart_downtime")] \
        == ["crash", "crash"]
    assert len(_stamps(log, "supervisor_abort")) == 1


@pytest.mark.parametrize("delete", [False, True])
def test_supervisor_kills_a_hung_child(tmp_path, delete):
    """A child that never beats is killed at the hang timeout (also when
    it deletes its heartbeat file: staleness counts from the last beat
    seen); the next attempt finishes."""
    marker, hb, log = tmp_path / "attempts", tmp_path / "hb", \
        tmp_path / "m.jsonl"
    log.write_text("")
    cmd = _script(tmp_path, _attempts(marker) + f"""
        import os, time
        if n == 0:
            if {delete}:
                os.unlink({str(hb)!r})
            time.sleep(60)
        raise SystemExit(0)
    """) + ["--heartbeat-file", str(hb)]
    sup = Supervisor(cmd, RestartPolicy(max_restarts=2, backoff=0.01),
                     hang_timeout=2.0, poll_interval=0.1, term_grace=0.5,
                     ledger_file=str(log), **QUIET)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 20
    assert marker.read_text() == "2"
    assert [r["fail_class"] for r in _stamps(log, "restart_downtime")] \
        == ["hang"]


def test_cli_refusals(tmp_path):
    with pytest.raises(SystemExit):
        E.main(["--max-restarts", "1"])                   # no command
    with pytest.raises(SystemExit):
        E.main(["--chaos", "kill@1", "--", "true"])      # no --chaos-state


def test_supervisor_stamps_crash_and_corrupt_ckpt(tmp_path):
    log = tmp_path / "m.jsonl"
    log.write_text("")
    for code in (3, E.EXIT_CORRUPT_CKPT):
        marker = tmp_path / f"ran_{code}"
        cmd = _script(tmp_path, f"""
            from pathlib import Path
            m = Path({str(marker)!r})
            if m.exists():
                raise SystemExit(0)
            m.write_text('x')
            raise SystemExit({code})
        """)
        sup = Supervisor(cmd, RestartPolicy(max_restarts=2, backoff=0.01),
                         poll_interval=0.05, ledger_file=str(log), **QUIET)
        assert sup.run() == 0
    stamps = _stamps(log, "restart_downtime")
    assert [r["fail_class"] for r in stamps] == ["crash", "corrupt_ckpt"]
    assert [r["exit_code"] for r in stamps] == [3, E.EXIT_CORRUPT_CKPT]
    assert all(r["attempt"] == 1 and r["seconds"] >= 0.01 for r in stamps)


def test_supervisor_numeric_class_via_dead_heartbeat(tmp_path):
    """A beating but numerically dead child is killed on its status, not
    on the hang timeout."""
    log, hb, marker = tmp_path / "m.jsonl", tmp_path / "hb", \
        tmp_path / "died_once"
    log.write_text("")
    cmd = _script(tmp_path, f"""
        import time
        from pathlib import Path
        m = Path({str(marker)!r})
        if m.exists():
            raise SystemExit(0)
        m.write_text('x')
        Path({str(hb)!r}).write_text('dead nonfinite gradients')
        time.sleep(60)
    """) + ["--heartbeat-file", str(hb)]
    sup = Supervisor(cmd, RestartPolicy(max_restarts=2, backoff=0.01),
                     hang_timeout=30.0, poll_interval=0.1, term_grace=1.0,
                     ledger_file=str(log), **QUIET)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 15
    assert [r["fail_class"] for r in _stamps(log, "restart_downtime")] \
        == ["numeric"]


def test_supervisor_poison_step_aborts_with_forensics(tmp_path):
    log, attempts = tmp_path / "m.jsonl", tmp_path / "attempts"
    cmd = _script(tmp_path, f"""
        import json
        from pathlib import Path
        a = Path({str(attempts)!r})
        n = int(a.read_text()) if a.exists() else 0
        a.write_text(str(n + 1))
        with open({str(log)!r}, 'a') as f:
            f.write(json.dumps({{"event": "step", "step": 7, "loss": 1.0,
                                 "tokens_per_sec": 1.0}}) + chr(10))
        raise SystemExit(9)
    """)
    sup = Supervisor(cmd, RestartPolicy(max_restarts=10, backoff=0.01),
                     poll_interval=0.05, ledger_file=str(log), **QUIET)
    assert sup.run() == 9
    assert attempts.read_text() == "2"        # aborted at the 2nd strike
    aborts = _stamps(log, "poison_step_abort")
    assert len(aborts) == 1 and aborts[0]["step"] == 7
    snap = json.loads(Path(f"{log}.poison_step_7.json").read_text())
    assert snap["poison_step"] == 7 and snap["fail_class"] == "crash"
    assert snap["exit_code"] == 9 and snap["metrics_tail"]


def test_term_grace_lets_the_child_flush(tmp_path):
    """A hang kill is SIGTERM first: a child that flushes on it (as the
    drivers' `install_sigterm_exit` does) gets the grace window."""
    flushed, marker, hb = (tmp_path / "flushed", tmp_path / "hung_once",
                           tmp_path / "hb")
    cmd = _script(tmp_path, f"""
        import sys, time
        sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})
        from pathlib import Path
        m = Path({str(marker)!r})
        if m.exists():
            raise SystemExit(0)
        m.write_text('x')
        import signal
        def flush(signum, frame):
            Path({str(flushed)!r}).write_text('ledger tail')
            raise SystemExit(143)
        signal.signal(signal.SIGTERM, flush)
        time.sleep(60)
    """) + ["--heartbeat-file", str(hb)]
    sup = Supervisor(cmd, RestartPolicy(max_restarts=2, backoff=0.01),
                     hang_timeout=2.0, poll_interval=0.1, term_grace=10.0,
                     **QUIET)
    assert sup.run() == 0
    assert flushed.read_text() == "ledger tail"


def test_install_sigterm_exit_raises_system_exit(tmp_path):
    """The drivers' handler: SIGTERM becomes SystemExit(143), which
    `terminating` recognises."""
    cmd = _script(tmp_path, f"""
        import os, signal, sys
        sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})
        from shallowspeed_tpu_torch.elastic import (install_sigterm_exit,
                                                    terminating)
        assert install_sigterm_exit()
        try:
            os.kill(os.getpid(), signal.SIGTERM)
        except SystemExit as e:
            assert terminating(e)
            raise
    """)
    assert subprocess.run(cmd, timeout=60).returncode == 143
    assert not E.terminating(SystemExit(1))


def test_supervisor_heartbeat_file_ownership(tmp_path):
    """A file the supervisor made is removed when it returns; a file the
    caller passed is not."""
    cmd = _script(tmp_path, "raise SystemExit(0)")
    sup = Supervisor(cmd, RestartPolicy(max_restarts=1), hang_timeout=30.0,
                     poll_interval=0.05, **QUIET)
    owned = Path(sup.heartbeat_file)
    assert owned.exists() and sup.argv[-2:] == ["--heartbeat-file",
                                                str(owned)]
    assert sup.run() == 0
    assert not owned.exists()
    hb = tmp_path / "hb"
    hb.touch()
    sup = Supervisor(cmd + ["--heartbeat-file", str(hb)],
                     RestartPolicy(max_restarts=1), hang_timeout=30.0,
                     poll_interval=0.05, **QUIET)
    assert sup.run() == 0 and hb.exists()


# ------------------------------------------------------------- gangs


def _gang_child(tmp_path, body):
    """A stub member: asserts the injected variables, then `body`."""
    head = textwrap.dedent(f"""
        import os, sys, time, pathlib
        assert os.environ["JAX_COORDINATOR_ADDRESS"].startswith(
            "localhost:")
        n = int(os.environ["JAX_NUM_PROCESSES"])
        pid = int(os.environ["JAX_PROCESS_ID"])
        root = pathlib.Path({str(tmp_path)!r})
    """)
    return _script(tmp_path, head + textwrap.dedent(body), name="member.py")


def test_gang_env_injection_and_clean_finish(tmp_path):
    cmd = _gang_child(tmp_path, """
        assert n == 2
        (root / f"saw_{pid}").write_text(os.environ["JAX_COORDINATOR_ADDRESS"])
    """)
    sup = GangSupervisor(cmd, 2, RestartPolicy(max_restarts=0),
                         poll_interval=0.05, **QUIET)
    assert sup.run() == 0
    addr = {(tmp_path / f"saw_{i}").read_text() for i in range(2)}
    assert len(addr) == 1


def test_gang_member_failure_restarts_the_whole_gang(tmp_path):
    cmd = _gang_child(tmp_path, """
        runs = root / f"runs_{pid}"
        runs.write_text(str(int(runs.read_text()) + 1
                            if runs.exists() else 1))
        (root / f"addr_{pid}_{runs.read_text()}").write_text(
            os.environ["JAX_COORDINATOR_ADDRESS"])
        if pid == 1 and not (root / "crashed").exists():
            (root / "crashed").write_text("x")
            sys.exit(3)
        time.sleep(0.5)
    """)
    log = tmp_path / "m.jsonl"
    log.write_text("")
    sup = GangSupervisor(cmd, 2, RestartPolicy(max_restarts=2,
                                               backoff=0.01),
                         poll_interval=0.05, ledger_file=str(log), **QUIET)
    assert sup.run() == 0
    assert (tmp_path / "runs_0").read_text() == "2"
    assert (tmp_path / "runs_1").read_text() == "2"
    # a fresh coordinator port for the second attempt
    assert (tmp_path / "addr_0_1").read_text() != \
        (tmp_path / "addr_0_2").read_text()
    assert [r["fail_class"] for r in _stamps(log, "restart_downtime")] \
        == ["crash"]


def test_gang_hang_restarts_and_cleans_up(tmp_path):
    cmd = _gang_child(tmp_path, """
        hb = sys.argv[sys.argv.index('--heartbeat-file') + 1]
        if pid == 0 and not (root / "hung").exists():
            (root / "hung").write_text("x")
            time.sleep(60)
        for _ in range(4):
            pathlib.Path(hb).touch(); time.sleep(0.1)
    """)
    sup = GangSupervisor(cmd, 2, RestartPolicy(max_restarts=2,
                                               backoff=0.01),
                         hang_timeout=2.0, poll_interval=0.1,
                         term_grace=0.5, **QUIET)
    files = [Path(p) for p in sup.heartbeat_files]
    assert len(files) == 2 and all(p.exists() for p in files)
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 20
    assert not any(p.exists() for p in files)
    with pytest.raises(ValueError, match="one heartbeat file per process"):
        GangSupervisor(cmd + ["--heartbeat-file", "x"], 2, hang_timeout=1.0)


def test_gang_monitor_port_is_not_ported():
    with pytest.raises(NotPorted, match="item 7"):
        GangSupervisor(["true"], 2, monitor_port=0)
    with pytest.raises(NotPorted):
        E.main(["--procs", "2", "--monitor-port", "0", "--", "true"])
