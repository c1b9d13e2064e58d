"""Failure detection and elastic recovery — counterpart of
`shallowspeed_tpu/elastic.py`.

Recovery is checkpoint-based: a failed run is restarted as a new
process and resumes from the newest verified checkpoint (`--auto-resume`
in the child's command), so a crash costs at most `--save-every` steps.

- **`Supervisor`** runs the training command as a child process and
  restarts it on failure, with a restart budget that refills after a
  healthy run-time window.
- **Failure classes** (`FAIL_CLASSES`): crash (a nonzero exit or an
  outside signal), hang (the heartbeat file's mtime went stale), numeric
  (the heartbeat says "dead <reason>", the health monitor's verdict) and
  corrupt_ckpt (exit `EXIT_CORRUPT_CKPT`: a strict `--resume` found no
  verified checkpoint). Each class backs off on its own jittered
  exponential stream; the same step failing twice in a row is a poison
  step (a labelled abort with a forensic snapshot, not a crash loop);
  kills are SIGTERM with a grace window before SIGKILL, so the child's
  finally blocks flush its metrics tail; each detection-to-respawn
  interval is stamped into the child's `--log-file` as a
  `restart_downtime` ledger line with its class (`telemetry/goodput`
  reduces them to MTTR).
- **`GangSupervisor`** runs N processes of one command with the
  reference's variables (`JAX_COORDINATOR_ADDRESS` on a fresh local port
  each attempt, `JAX_NUM_PROCESSES`, `JAX_PROCESS_ID`), one heartbeat
  file each; any member's failure kills and restarts the whole gang
  (`distributed.initialize` joins them on gloo).
- `--chaos` hands a fault plan (`chaos`) to the children.

The supervisor imports torch through the package but makes no CUDA
call: the children own the card.

    python -m shallowspeed_tpu_torch.elastic --max-restarts 3 \
        --hang-timeout 600 -- \
        python -m shallowspeed_tpu_torch.train_lm --save-dir ck \
        --auto-resume ...

The `--` separates the supervisor's flags from the training command.
With `--hang-timeout` the supervisor adds `--heartbeat-file` to a
command that has none. In gang mode `--monitor-port` gives each member
its own metrics file (`<log-file>.r<i>`) and serves one fleet collector
(`telemetry/fleet.FleetCollector`) over them: per-member and merged
quantiles, straggler detection across the gang.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

from shallowspeed_tpu_torch.checkpoint import EXIT_CORRUPT_CKPT

FAIL_CLASSES = ("crash", "hang", "numeric", "corrupt_ckpt")


# the exit code `install_sigterm_exit` gives a terminated driver
TERM_EXIT = 143

__all__ = ["EXIT_CORRUPT_CKPT", "FAIL_CLASSES", "GangSupervisor",
           "RestartPolicy", "Supervisor", "classify_exit",
           "install_sigterm_exit", "read_heartbeat_status",
           "write_heartbeat"]


def classify_exit(code: int) -> str | None:
    """Failure class of a child exit code: None for a clean exit,
    "corrupt_ckpt" for EXIT_CORRUPT_CKPT, "crash" for everything else
    (nonzero exits and outside signals)."""
    if code == 0:
        return None
    if code == EXIT_CORRUPT_CKPT:
        return "corrupt_ckpt"
    return "crash"


def install_sigterm_exit() -> bool:
    """Driver side of the --term-grace contract: SIGTERM becomes
    SystemExit(143), so the training loop's finally blocks run (the
    prefetcher closes, the tracer flushes, the metrics tail lands)
    before the supervisor's SIGKILL. Returns False outside the main
    thread, where signal handlers cannot be installed."""
    def _to_exit(signum, frame):
        raise SystemExit(TERM_EXIT)

    try:
        signal.signal(signal.SIGTERM, _to_exit)
        return True
    except ValueError:
        return False


def terminating(exc) -> bool:
    """Whether `exc` is the SystemExit `install_sigterm_exit` raises:
    the supervisor's SIGKILL follows within its grace window, so
    teardown should not wait on background writes."""
    return isinstance(exc, SystemExit) and exc.code == TERM_EXIT


def _argv_log_file(argv: list[str]) -> str | None:
    """The child command's --log-file value, if any (both the two-token
    form and --log-file=PATH)."""
    for i, arg in enumerate(argv):
        if arg == "--log-file" and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith("--log-file="):
            return arg.split("=", 1)[1]
    return None


def _set_argv_log_file(argv: list[str], path: str) -> list[str]:
    """A copy of `argv` with its --log-file value replaced (both forms),
    or `--log-file path` appended: gang mode's per-member files."""
    out = list(argv)
    for i, arg in enumerate(out):
        if arg == "--log-file" and i + 1 < len(out):
            out[i + 1] = path
            return out
        if arg.startswith("--log-file="):
            out[i] = f"--log-file={path}"
            return out
    return out + ["--log-file", path]


def write_heartbeat(path, status: str = "ok") -> None:
    """One beat: refresh the mtime (liveness) and record the health
    status ("ok" or "dead <reason>")."""
    with open(path, "w") as f:
        f.write(status)


def read_heartbeat_status(path) -> str:
    """The file's health status ("ok" for an empty, missing or
    unreadable file: liveness is the mtime's job)."""
    try:
        with open(path) as f:
            status = f.read(256).strip()
    except OSError:
        return "ok"
    return status or "ok"


@dataclass
class RestartPolicy:
    """Budgeted restarts with per-failure-class jittered exponential
    backoff. `max_restarts` failures are tolerated in all; each class's
    delay doubles from `backoff` up to `backoff_max` on its own stream;
    `jitter` stretches each delay by up to that fraction, drawn from a
    stream seeded by `seed`; a child that stayed up `healthy_after`
    seconds refills the budget and resets every backoff."""

    max_restarts: int = 3
    backoff: float = 5.0
    backoff_max: float = 300.0
    healthy_after: float = 600.0
    jitter: float = 0.0
    seed: int = 0

    _used: int = field(default=0, init=False)
    _next_backoff: float = field(default=0.0, init=False)
    _class_backoff: dict = field(default_factory=dict, init=False)
    _rng: random.Random = field(default=None, init=False)

    def __post_init__(self):
        self._next_backoff = self.backoff
        self._rng = random.Random(self.seed)

    def record_run(self, run_seconds: float) -> None:
        if run_seconds >= self.healthy_after:
            self._used = 0
            self._next_backoff = self.backoff
            self._class_backoff.clear()

    def next_restart(self, fail_class: str | None = None
                     ) -> float | None:
        """Delay before the next restart, or None when the budget is
        exhausted. With a `fail_class` the doubling is tracked per
        class; without one, on one shared stream."""
        if self._used >= self.max_restarts:
            return None
        self._used += 1
        if fail_class is None:
            delay = self._next_backoff
            self._next_backoff = min(self._next_backoff * 2,
                                     self.backoff_max)
        else:
            delay = self._class_backoff.get(fail_class, self.backoff)
            self._class_backoff[fail_class] = min(delay * 2,
                                                  self.backoff_max)
        if self.jitter:
            delay *= 1.0 + self.jitter * self._rng.random()
        return delay


class Supervisor:
    """Run `argv` as a child process; restart on failure per `policy`;
    kill and restart on heartbeat staleness when `hang_timeout` is set,
    and on a "dead ..." heartbeat status whenever there is a heartbeat
    file."""

    def __init__(self, argv: list[str], policy: RestartPolicy | None = None,
                 hang_timeout: float | None = None,
                 heartbeat_file: str | None = None,
                 poll_interval: float = 1.0,
                 log=print, ledger_file: str | None = None,
                 term_grace: float = 5.0,
                 child_env: dict | None = None,
                 monitor_port: int | None = None, slo: str = ""):
        self.argv = list(argv)
        self.policy = policy or RestartPolicy()
        self.hang_timeout = hang_timeout
        self.poll_interval = poll_interval
        self.log = log
        # with a port: the child's metrics JSONL (every restart's stanza
        # and this supervisor's stamps) tailed into a Monitor, served
        # for the whole supervised history
        self.monitor_port = monitor_port
        self.slo = slo or ""
        self.term_grace = term_grace    # SIGTERM, then SIGKILL; 0 = SIGKILL
        self.child_env = dict(child_env or {})
        self._poison_step: int | None = None
        self._poison_count = 0
        self._log_mark = 0
        # restart stamps go into the child's own log, so the goodput
        # reducer sees the whole history in one file
        self.ledger_file = ledger_file or _argv_log_file(self.argv)
        self._owned_hb = False       # a file this supervisor created
        if hang_timeout is not None and heartbeat_file is None:
            if "--heartbeat-file" in self.argv:
                heartbeat_file = self.argv[
                    self.argv.index("--heartbeat-file") + 1]
            else:
                fd, heartbeat_file = tempfile.mkstemp(prefix="hb_")
                os.close(fd)
                self.argv += ["--heartbeat-file", heartbeat_file]
                self._owned_hb = True
        self.heartbeat_file = heartbeat_file

    # ------------------------------------------------------------ child

    def _terminate(self, child) -> None:
        """SIGTERM, wait `term_grace` seconds for a voluntary exit, then
        SIGKILL what remains."""
        if child.poll() is not None:
            return
        if self.term_grace and self.term_grace > 0:
            child.send_signal(signal.SIGTERM)
            try:
                child.wait(timeout=self.term_grace)
                return
            except subprocess.TimeoutExpired:
                pass
        child.send_signal(signal.SIGKILL)
        child.wait()

    def _spawn(self, argv):
        self._mark_log()
        env = ({**os.environ, **self.child_env} if self.child_env
               else None)
        return subprocess.Popen(argv, env=env)

    def _run_once(self) -> tuple[int, float, str | None]:
        """One child run: (exit code, run seconds, failure class); the
        class is None on a clean exit, and a hang or health kill reports
        exit code -9."""
        t0 = time.monotonic()
        if self.heartbeat_file:
            # a fresh child gets a fresh liveness clock and status: a
            # leftover "dead ..." would kill every restart at once
            try:
                write_heartbeat(self.heartbeat_file, "ok")
            except OSError:
                pass
        child = self._spawn(self.argv)
        # staleness counts from the last beat seen (the child's start at
        # worst), also when the heartbeat file disappears mid-run
        hb_seen = time.time()
        try:
            while True:
                code = child.poll()
                if code is not None:
                    return code, time.monotonic() - t0, classify_exit(code)
                if self.heartbeat_file:
                    status = read_heartbeat_status(self.heartbeat_file)
                    if status.startswith("dead"):
                        self.log(f"[elastic] health verdict {status!r} — "
                                 f"killing child {child.pid} for a "
                                 f"checkpoint restart")
                        self._terminate(child)
                        return -9, time.monotonic() - t0, "numeric"
                if self.hang_timeout is not None:
                    try:
                        hb_seen = max(hb_seen,
                                      os.path.getmtime(self.heartbeat_file))
                    except OSError:
                        pass
                    stale = time.time() - hb_seen
                    if stale > self.hang_timeout:
                        self.log(f"[elastic] heartbeat stale {stale:.0f}s > "
                                 f"{self.hang_timeout}s — killing child "
                                 f"{child.pid}")
                        self._terminate(child)
                        return -9, time.monotonic() - t0, "hang"
                time.sleep(self.poll_interval)
        except BaseException:
            # an interrupt of the supervisor must not orphan the child
            self._terminate(child)
            raise

    # ------------------------------------------------------------- loop

    def _cleanup_heartbeats(self) -> None:
        """Unlink a heartbeat file this supervisor created (never one
        the caller passed)."""
        if self._owned_hb and self.heartbeat_file:
            try:
                os.unlink(self.heartbeat_file)
            except OSError:
                pass

    def _start_monitor(self):
        """(monitor, server, tailer) for --monitor-port, or Nones. The
        tailer reads the ledger file from byte 0, then follows it."""
        if self.monitor_port is None or not self.ledger_file:
            if self.monitor_port is not None:
                self.log("[elastic] --monitor-port needs the child "
                         "command to carry --log-file (the metrics "
                         "JSONL to aggregate); monitoring disabled")
            return None, None, None
        from shallowspeed_tpu_torch.telemetry.monitor import (FileTailer,
                                                              Monitor,
                                                              StatusServer)

        mon = Monitor(slos=self.slo, flight=0, derive_steps=True,
                      snapshot_every=0)
        srv = StatusServer(mon, port=self.monitor_port)
        tailer = FileTailer(self.ledger_file, mon)
        tailer.start()
        self.log(f"[elastic] monitor: {srv.url('/status.json')} "
                 f"(+ /metrics) over {self.ledger_file}")
        return mon, srv, tailer

    def run(self) -> int:
        """Supervise until the child exits 0 or the restart budget is
        exhausted; returns the final exit code."""
        mon, srv, tailer = self._start_monitor()
        try:
            return self._supervise()
        finally:
            if tailer is not None:
                tailer.stop()
            if srv is not None:
                srv.close()
            self._cleanup_heartbeats()

    def _last_logged_step(self) -> int | None:
        """The last step this child's lines in the metrics JSONL
        recorded (only lines written after it spawned: a replacement
        that died before logging reads as no step, not as a repeat of
        its predecessor's)."""
        if not self.ledger_file:
            return None
        try:
            with open(self.ledger_file, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 262144, self._log_mark))
                tail = f.read().decode(errors="replace")
        except OSError:
            return None
        step = None
        for line in tail.splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("event") == "step" \
                    and isinstance(rec.get("step"), int):
                step = rec["step"]
        return step

    def _mark_log(self) -> None:
        """Remember where the metrics file ends as a child spawns."""
        try:
            self._log_mark = (os.path.getsize(self.ledger_file)
                              if self.ledger_file else 0)
        except OSError:
            self._log_mark = 0

    def _check_poison(self) -> int | None:
        """The same last step for two failed children in a row is a
        deterministic failure; returns that step (else None)."""
        step = self._last_logged_step()
        if step is not None and step == self._poison_step:
            self._poison_count += 1
        else:
            self._poison_step, self._poison_count = step, 1
        if step is not None and self._poison_count >= 2:
            return step
        return None

    def _stamp(self, kind: str, **fields) -> None:
        if self.ledger_file:
            from shallowspeed_tpu_torch.telemetry.goodput import (
                stamp_ledger_line)

            stamp_ledger_line(self.ledger_file, kind, **fields)

    def _forensics(self, step: int, fail_class, code) -> str | None:
        """Freeze the evidence of a poison-step abort next to the
        metrics file: the step, the class, the exit code, the command,
        the heartbeat status and the log's last 40 lines."""
        if not self.ledger_file:
            return None
        path = f"{self.ledger_file}.poison_step_{step}.json"
        tail = ""
        try:
            with open(self.ledger_file, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - 16384))
                tail = f.read().decode(errors="replace")
        except OSError:
            pass
        hb = (read_heartbeat_status(self.heartbeat_file)
              if self.heartbeat_file else None)
        try:
            with open(path, "w") as f:
                json.dump({"poison_step": step,
                           "fail_class": fail_class,
                           "exit_code": code,
                           "argv": self.argv,
                           "heartbeat_status": hb,
                           "metrics_tail": tail.splitlines()[-40:]},
                          f, indent=1)
        except OSError:
            return None
        return path

    def _supervise(self) -> int:
        attempt = 0
        while True:
            attempt += 1
            self.log(f"[elastic] attempt {attempt}: {' '.join(self.argv)}")
            code, secs, fail_class = self._run_once()
            t_dead = time.monotonic()
            if code == 0:
                self.log(f"[elastic] child finished cleanly after "
                         f"{secs:.0f}s")
                return 0
            self.policy.record_run(secs)
            poison = self._check_poison()
            if poison is not None:
                snap = self._forensics(poison, fail_class, code)
                self.log(f"[elastic] poison step {poison}: the same "
                         f"step failed twice in a row (class "
                         f"{fail_class}, exit {code}) — aborting"
                         + (f"; forensic snapshot {snap}" if snap
                            else ""))
                self._stamp("poison_step_abort", step=poison,
                            fail_class=fail_class, exit_code=code)
                return code if code > 0 else 1
            delay = self.policy.next_restart(fail_class)
            if delay is None:
                self.log(f"[elastic] child failed (exit {code}, class "
                         f"{fail_class}) and the restart budget is "
                         f"exhausted; giving up")
                self._stamp("supervisor_abort", fail_class=fail_class,
                            exit_code=code)
                return code if code > 0 else 1
            self.log(f"[elastic] child failed (exit {code}, class "
                     f"{fail_class}) after {secs:.0f}s; restarting in "
                     f"{delay:.1f}s")
            time.sleep(delay)
            # detection to respawn (kill latency + backoff), which the
            # goodput reducer turns into MTTR per class
            self._stamp("restart_downtime",
                        seconds=round(time.monotonic() - t_dead, 3),
                        attempt=attempt, exit_code=code,
                        fail_class=fail_class)


class GangSupervisor(Supervisor):
    """Several processes of one command, supervised as one gang: any
    member exiting nonzero, or any member's heartbeat going stale or
    dead, kills the whole gang, and the shared restart budget relaunches
    all N from the newest checkpoint (`--auto-resume` in the command).
    A process group cannot repair a dead peer, so recovery is a gang
    restart. Member i gets `JAX_COORDINATOR_ADDRESS` (a fresh local port
    per attempt unless `coordinator` pins one), `JAX_NUM_PROCESSES=N` and
    `JAX_PROCESS_ID=i`, which `distributed.initialize` reads. Restart
    stamps go to the command's --log-file, the one process 0 writes."""

    def __init__(self, argv: list[str], n_procs: int,
                 policy: RestartPolicy | None = None,
                 hang_timeout: float | None = None,
                 coordinator: str | None = None,
                 poll_interval: float = 1.0, log=print,
                 ledger_file: str | None = None,
                 term_grace: float = 5.0,
                 child_env: dict | None = None,
                 monitor_port: int | None = None, slo: str = ""):
        # not Supervisor.__init__: the heartbeat is per member here
        self.argv = list(argv)
        self.n = int(n_procs)
        if self.n < 1:
            raise ValueError(f"a gang needs at least one process, got "
                             f"{self.n}")
        self.policy = policy or RestartPolicy()
        self.hang_timeout = hang_timeout
        self.coordinator = coordinator
        self.poll_interval = poll_interval
        self.log = log
        self.term_grace = term_grace
        self.child_env = dict(child_env or {})
        self.monitor_port = monitor_port
        self.slo = slo or ""
        self.heartbeat_file = None          # one file per member instead
        self._poison_step = None
        self._poison_count = 0
        self._log_mark = 0
        # gang monitoring: each member its own metrics file (one shared
        # file would interleave N processes' lines) and one fleet
        # collector over them; the supervisor's stamps and the poison
        # detector's evidence stay in member 0's file
        self.member_log_files: list[str] = []
        base = ledger_file or _argv_log_file(self.argv)
        if monitor_port is not None and base:
            self.member_log_files = [f"{base}.r{i}" for i in range(self.n)]
            base = self.member_log_files[0]
        self.ledger_file = base
        self.heartbeat_files = []
        if hang_timeout is not None:
            if "--heartbeat-file" in self.argv:
                raise ValueError("gang mode injects one heartbeat file "
                                 "per process; drop the explicit "
                                 "--heartbeat-file")
            for i in range(self.n):
                fd, path = tempfile.mkstemp(prefix=f"hb{i}_")
                os.close(fd)
                self.heartbeat_files.append(path)

    def _cleanup_heartbeats(self) -> None:
        for path in self.heartbeat_files:
            try:
                os.unlink(path)
            except OSError:
                pass

    def _start_monitor(self):
        """(collector, server, collector) for --monitor-port, or Nones:
        one `FleetCollector` over the members' metrics files, served as
        the gang's /status.json + /metrics (member-labelled). The
        collector is also what `run()` stops at teardown."""
        if self.monitor_port is None:
            return None, None, None
        if not self.member_log_files:
            self.log("[elastic] --monitor-port needs the gang command to "
                     "carry --log-file (the metrics JSONL to aggregate per "
                     "member); monitoring disabled")
            return None, None, None
        from shallowspeed_tpu_torch.telemetry.fleet import FleetCollector
        from shallowspeed_tpu_torch.telemetry.monitor import StatusServer

        fc = FleetCollector(paths=self.member_log_files,
                            labels=[f"r{i}" for i in range(self.n)],
                            slos=self.slo)
        srv = StatusServer(fc, port=self.monitor_port)
        fc.start(poll=max(0.5, float(self.poll_interval)))
        self.log(f"[elastic] fleet monitor: {srv.url('/status.json')} "
                 f"(+ /metrics) over {self.n} member file(s)")
        return fc, srv, fc

    def _free_port(self) -> int:
        import socket

        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    def _kill_gang(self, children) -> None:
        """SIGTERM the whole gang at once, give every member the one
        shared grace window, then SIGKILL the stragglers."""
        live = [c for c in children if c.poll() is None]
        if self.term_grace and self.term_grace > 0:
            for c in live:
                c.send_signal(signal.SIGTERM)
            deadline = time.monotonic() + self.term_grace
            for c in live:
                try:
                    c.wait(timeout=max(0.05,
                                       deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        for c in children:
            if c.poll() is None:
                c.send_signal(signal.SIGKILL)
        for c in children:
            c.wait()

    def _run_once(self) -> tuple[int, float, str | None]:
        t0 = time.monotonic()
        self._mark_log()
        coord = self.coordinator or f"localhost:{self._free_port()}"
        children = []
        # whatever goes wrong here (a failed spawn, an interrupt) must
        # not leave members running
        try:
            for i in range(self.n):
                argv = list(self.argv)
                if self.member_log_files:
                    argv = _set_argv_log_file(argv, self.member_log_files[i])
                if self.heartbeat_files:
                    try:
                        write_heartbeat(self.heartbeat_files[i], "ok")
                    except OSError:
                        pass
                    argv += ["--heartbeat-file", self.heartbeat_files[i]]
                env = {**os.environ, **self.child_env,
                       "JAX_COORDINATOR_ADDRESS": coord,
                       "JAX_NUM_PROCESSES": str(self.n),
                       "JAX_PROCESS_ID": str(i)}
                children.append(subprocess.Popen(argv, env=env))
            hb_seen = [time.time()] * self.n
            while True:
                codes = [c.poll() for c in children]
                if any(c is not None and c != 0 for c in codes):
                    bad = next(i for i, c in enumerate(codes)
                               if c is not None and c != 0)
                    self.log(f"[elastic] gang member {bad} exited "
                             f"{codes[bad]} — killing the gang")
                    self._kill_gang(children)
                    return (codes[bad], time.monotonic() - t0,
                            classify_exit(codes[bad]) or "crash")
                if all(c == 0 for c in codes):
                    return 0, time.monotonic() - t0, None
                if self.hang_timeout is not None:
                    for i, hb in enumerate(self.heartbeat_files):
                        if codes[i] == 0:
                            continue  # finished members stop beating
                        status = read_heartbeat_status(hb)
                        if status.startswith("dead"):
                            self.log(f"[elastic] gang member {i} "
                                     f"health verdict {status!r} — "
                                     f"killing the gang for a "
                                     f"checkpoint restart")
                            self._kill_gang(children)
                            return -9, time.monotonic() - t0, "numeric"
                        try:
                            hb_seen[i] = max(hb_seen[i],
                                             os.path.getmtime(hb))
                        except OSError:
                            pass
                        stale = time.time() - hb_seen[i]
                        if stale > self.hang_timeout:
                            self.log(f"[elastic] gang member {i} "
                                     f"heartbeat stale {stale:.0f}s > "
                                     f"{self.hang_timeout}s — killing "
                                     f"the gang")
                            self._kill_gang(children)
                            return -9, time.monotonic() - t0, "hang"
                time.sleep(self.poll_interval)
        except BaseException:
            self._kill_gang(children)
            raise


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m shallowspeed_tpu_torch.elastic",
        description="Restart-on-failure supervisor with checkpoint-based "
                    "recovery (pair with --save-dir/--auto-resume)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--backoff", type=float, default=5.0)
    ap.add_argument("--backoff-max", type=float, default=300.0)
    ap.add_argument("--healthy-after", type=float, default=600.0,
                    help="a run this long refills the restart budget")
    ap.add_argument("--hang-timeout", type=float, default=None,
                    help="kill the child if its heartbeat file goes "
                         "stale this long (seconds)")
    ap.add_argument("--term-grace", type=float, default=5.0,
                    help="SIGTERM first and wait this long for the child "
                         "to flush its metrics tail before SIGKILL (0 = "
                         "straight SIGKILL)")
    ap.add_argument("--jitter", type=float, default=0.1,
                    help="stretch each restart backoff by up to this "
                         "fraction (a per-process seed: supervisors "
                         "restarting off one outage spread out)")
    ap.add_argument("--chaos", default="",
                    help="fault-injection plan for the children "
                         "(shallowspeed_tpu_torch.chaos DSL or a JSON "
                         "path), exported via SHALLOWSPEED_CHAOS")
    ap.add_argument("--chaos-state", default="",
                    help="directory of the plan's fired-fault markers; "
                         "must survive restarts (required with --chaos)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--procs", type=int, default=1,
                    help="gang mode: N processes of the command "
                         "(JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                         "JAX_PROCESS_ID injected); any member's failure "
                         "restarts the whole gang")
    ap.add_argument("--coordinator", default=None,
                    help="pin the gang's coordinator address (default: "
                         "a fresh localhost port per attempt)")
    ap.add_argument("--monitor-port", type=int, default=None,
                    help="serve /status.json + /metrics for the whole "
                         "supervised history (tails the child's "
                         "--log-file; 0 = free port); with --procs N one "
                         "fleet collector over the members' own files "
                         "(<log-file>.r<i>)")
    ap.add_argument("--slo", default="",
                    help="SLOs evaluated over the tailed stream "
                         "(telemetry/monitor DSL)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- training command")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no training command given (separate it with --)")
    policy = RestartPolicy(
        max_restarts=args.max_restarts, backoff=args.backoff,
        backoff_max=args.backoff_max, healthy_after=args.healthy_after,
        # a per-process seed: supervisors restarting off one outage must
        # draw different jitter; tests build RestartPolicy with a seed
        jitter=args.jitter, seed=os.getpid())
    child_env = None
    if args.chaos:
        if not args.chaos_state:
            ap.error("--chaos needs --chaos-state (fired-fault markers "
                     "must survive restarts, or every restarted child "
                     "re-fires every fault)")
        from shallowspeed_tpu_torch.chaos import FaultPlan

        plan = FaultPlan.parse(args.chaos, seed=args.chaos_seed,
                               state_dir=args.chaos_state)
        child_env = {k: v for k, v in plan.export_env().items()
                     if k.startswith("SHALLOWSPEED_CHAOS")}
    if args.procs > 1:
        sup = GangSupervisor(cmd, args.procs, policy,
                             hang_timeout=args.hang_timeout,
                             coordinator=args.coordinator,
                             term_grace=args.term_grace,
                             child_env=child_env,
                             monitor_port=args.monitor_port,
                             slo=args.slo)
    else:
        sup = Supervisor(cmd, policy, hang_timeout=args.hang_timeout,
                         term_grace=args.term_grace,
                         child_env=child_env,
                         monitor_port=args.monitor_port,
                         slo=args.slo)
    return sup.run()


if __name__ == "__main__":
    sys.exit(main())
