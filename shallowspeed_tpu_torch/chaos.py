"""Deterministic fault injection — counterpart of
`shallowspeed_tpu/chaos.py`, the adversarial proof of the recovery
stack (the elastic supervisor, health-guarded steps, atomic
checkpoints, the goodput ledger). Faults are scheduled at named
injection points wired into the drivers, the data loader and the
checkpoint writer, so a chaos drill is a seeded, replayable plan rather
than a hand-run `kill -9`:

    python -m shallowspeed_tpu_torch.elastic --max-restarts 4 \
        --chaos 'kill@9,corrupt@2,stall@5:0.5' --chaos-state ck/.chaos \
        -- python -m shallowspeed_tpu_torch.train_lm --save-dir ck \
        --auto-resume ...

Fault kinds (`kind@at[:arg]`, comma-separated; `at` is a 0-based step
for step faults and a 1-based save ordinal for save faults):

- ``kill@N``          SIGKILL this process before dispatching step N.
- ``kill_in_save@K``  SIGKILL inside the K-th checkpoint save's
                      tmp-write/rename window, at a seeded offset among
                      its points (after each npz, before the rename,
                      after it); fires on `AsyncSaver`'s writer thread
                      too.
- ``nan@N`` / ``inf@N``  scale one seeded parameter leaf by NaN / Inf
                      before step N, on every copy the engine holds, so
                      every later gradient is non-finite.
- ``scale_poison@N``  zero one seeded layer's fp8 amax history
                      (`fp8.Fp8TrainEngine.amax_hist`).
- ``stall@N:S``       sleep S seconds (default 2.0) in the data loader
                      at step N; the goodput ledger names it
                      ``data_stall``.
- ``freeze@N``        stop writing heartbeats from step N on (the run
                      keeps stepping): the hang only the supervisor's
                      staleness clock can catch.
- ``enospc@K``        the K-th save raises OSError(ENOSPC) before it
                      writes; `latest()` is unaffected.
- ``corrupt@K[:mode]``  after the K-th save lands, corrupt it:
                      ``bitflip`` (default: one seeded bit of a seeded
                      npz), ``truncate`` (cut the npz in half) or
                      ``delete`` (unlink it) — manifest verification
                      must catch it at the next restore.

Every fault fires at most once per plan: a fired fault writes a marker
into ``state_dir`` before its body runs, and the state dir survives
supervisor restarts (the drivers default it to ``<save_dir>/.chaos``),
so a restarted child replays the fault window clean. The plan's seed
picks the poisoned leaf, the flipped bit and the kill offset inside a
save; the draws, the offsets and the marker files are the reference's,
so one plan means the same faults in both packages. The supervisor
hands the plan to its children through ``SHALLOWSPEED_CHAOS`` /
``SHALLOWSPEED_CHAOS_STATE`` / ``SHALLOWSPEED_CHAOS_SEED``; a driver's
``--chaos`` flag wins over them. Every fired fault is stamped as a
schema-v5 ``{"event": "fault", ...}`` line into the run's metrics JSONL,
fsync'd (the process may be about to die).
"""

from __future__ import annotations

import errno
import json
import os
import signal
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

ENV_SPEC = "SHALLOWSPEED_CHAOS"
ENV_STATE = "SHALLOWSPEED_CHAOS_STATE"
ENV_SEED = "SHALLOWSPEED_CHAOS_SEED"

STEP_KINDS = ("kill", "nan", "inf", "stall", "freeze", "scale_poison")
SAVE_KINDS = ("kill_in_save", "enospc", "corrupt")
KINDS = STEP_KINDS + SAVE_KINDS

_CORRUPT_MODES = ("bitflip", "truncate", "delete")


@dataclass(frozen=True)
class Fault:
    """One scheduled fault: `kind` at step/save-ordinal `at`, with an
    optional kind-specific `arg` (stall seconds, corrupt mode)."""

    kind: str
    at: int
    arg: str | float | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(know {', '.join(KINDS)})")
        if self.kind in SAVE_KINDS and self.at < 1:
            raise ValueError(f"{self.kind} takes a 1-based save "
                             f"ordinal, got {self.at}")
        if self.kind == "corrupt" and self.arg is not None \
                and self.arg not in _CORRUPT_MODES:
            raise ValueError(f"corrupt mode {self.arg!r} not in "
                             f"{_CORRUPT_MODES}")

    @property
    def id(self) -> str:
        """Stable token — doubles as the fired-marker filename stem."""
        tail = "" if self.arg is None else f":{self.arg}"
        return f"{self.kind}@{self.at}{tail}"


def _parse_token(tok: str) -> Fault:
    if "@" not in tok:
        raise ValueError(
            f"bad fault token {tok!r} (want kind@at[:arg], e.g. "
            f"'kill@9' or 'stall@5:2.5')")
    kind, _, rest = tok.partition("@")
    at, _, arg = rest.partition(":")
    parsed: str | float | None = None
    if arg:
        parsed = arg if kind == "corrupt" else float(arg)
    try:
        at_i = int(at)
    except ValueError:
        raise ValueError(f"bad fault position in {tok!r}: {at!r} is "
                         f"not an integer step/save ordinal") from None
    return Fault(kind.strip(), at_i, parsed)


def leaf_paths(tree, prefix: tuple = ()):
    """The paths (tuples of keys and indices) of a tree's leaves in the
    JAX package's flattening order (`jax.tree_util.tree_flatten`: dict
    keys sorted, lists and tuples in order, None no leaf) — the order
    the reference draws the poisoned leaf from."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (i,))
    elif tree is not None:
        yield prefix


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _replaced(tree, path, fn):
    """A copy of `tree`'s containers with the leaf at `path` replaced by
    `fn(leaf)`; every other leaf is shared."""
    if not path:
        return fn(tree)
    k, rest = path[0], path[1:]
    if isinstance(tree, dict):
        return {key: _replaced(v, rest, fn) if key == k else v
                for key, v in tree.items()}
    return type(tree)(_replaced(v, rest, fn) if i == k else v
                      for i, v in enumerate(tree))


def _scaled(x, factor: float):
    """`x * factor` as a new leaf of `x`'s kind: a tensor keeps its
    `requires_grad` (a leaf of an autograd engine stays one)."""
    import torch

    if isinstance(x, torch.Tensor):
        return (x.detach() * factor).requires_grad_(x.requires_grad)
    return np.asarray(x) * factor


class FaultPlan:
    """A seeded schedule of faults plus the once-only firing state.

    `state_dir=None` keeps fired markers in-process only — fine for a
    single-process drill, wrong under a supervisor (the restarted child
    would re-fire every fault)."""

    def __init__(self, faults: list[Fault], seed: int = 0,
                 state_dir=None, log_file=None):
        self.faults = list(faults)
        self.seed = int(seed)
        self.state_dir = Path(state_dir) if state_dir else None
        if self.state_dir is not None:
            self.state_dir.mkdir(parents=True, exist_ok=True)
        self.log_file = str(log_file) if log_file else None
        self._mem_fired: set[str] = set()
        self._mem_saves = 0        # save ordinal when state_dir is None
        self._frozen = False       # heartbeat freeze is in-process state
        # in-flight save bookkeeping (kill_in_save): set at save start
        self._save_target: int | None = None
        self._save_point = 0
        self._save_fault: Fault | None = None

    # ------------------------------------------------------- parse/spec

    @classmethod
    def parse(cls, spec: str, seed: int = 0, state_dir=None,
              log_file=None) -> "FaultPlan":
        """Parse the compact DSL, inline JSON, or a path to a JSON
        plan file (``{"seed": 0, "faults": [{"kind", "at", "arg"}]}``)."""
        spec = spec.strip()
        if spec.startswith("{"):
            return cls._from_json(json.loads(spec), seed, state_dir,
                                  log_file)
        if spec.endswith(".json") and Path(spec).exists():
            return cls._from_json(json.loads(Path(spec).read_text()),
                                  seed, state_dir, log_file)
        faults = [_parse_token(t) for t in spec.split(",") if t.strip()]
        if not faults:
            raise ValueError(f"empty chaos spec {spec!r}")
        return cls(faults, seed=seed, state_dir=state_dir,
                   log_file=log_file)

    @classmethod
    def _from_json(cls, obj: dict, seed, state_dir, log_file):
        faults = [Fault(f["kind"], int(f["at"]), f.get("arg"))
                  for f in obj.get("faults", ())]
        if not faults:
            raise ValueError("chaos JSON plan has no faults")
        return cls(faults, seed=int(obj.get("seed", seed)),
                   state_dir=state_dir, log_file=log_file)

    def to_spec(self) -> str:
        """The compact DSL round-trip (what export_env propagates)."""
        return ",".join(f.id for f in self.faults)

    def export_env(self, env: dict | None = None) -> dict:
        """Child-process env carrying this plan (supervisor side)."""
        env = dict(os.environ if env is None else env)
        env[ENV_SPEC] = self.to_spec()
        env[ENV_SEED] = str(self.seed)
        if self.state_dir is not None:
            env[ENV_STATE] = str(self.state_dir)
        return env

    # -------------------------------------------------- firing/markers

    def _rng(self, fault: Fault) -> np.random.Generator:
        """Per-fault deterministic stream: the plan seed plus the
        fault's position in the plan."""
        return np.random.default_rng([self.seed,
                                      self.faults.index(fault)])

    def fired(self, fault: Fault) -> bool:
        if fault.id in self._mem_fired:
            return True
        if self.state_dir is not None:
            return (self.state_dir / self._marker(fault)).exists()
        return False

    def _marker(self, fault: Fault) -> str:
        safe = fault.id.replace("@", "_at_").replace(":", "_")
        return f"fired_{safe}"

    def _mark(self, fault: Fault) -> None:
        self._mem_fired.add(fault.id)
        if self.state_dir is not None:
            (self.state_dir / self._marker(fault)).write_text(
                f"{time.time():.3f}\n")

    def stamp(self, fault: Fault, **extra) -> None:
        """Append the schema-v5 fault event to the metrics JSONL,
        fsync'd: a kill fault dies microseconds later. Best effort.
        Registered observers (`add_observer`: the live monitor's flight
        recorder, the profiler's capture trigger) see the record first,
        while the process still exists."""
        rec = {"event": "fault", "kind": fault.kind,
               "fault_id": fault.id, "wall": round(time.time(), 3),
               **extra}
        for fn in list(_observers):
            try:
                fn(rec)
            except Exception:
                pass
        if self.log_file is None:
            return
        try:
            with open(self.log_file, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass

    def _fire(self, fault: Fault, **extra) -> None:
        """Marker first, stamp second: even a SIGKILL microseconds into
        the fault body must not let a restarted child re-fire it."""
        self._mark(fault)
        self.stamp(fault, **extra)

    # ------------------------------------------------- step-loop hooks

    def due(self, kind: str, at: int) -> Fault | None:
        for f in self.faults:
            if f.kind == kind and f.at == at and not self.fired(f):
                return f
        return None

    def on_step(self, step: int, engine=None) -> None:
        """Driver hook, top of the step loop. Freeze and poison first
        (they leave the process alive), kill last."""
        f = self.due("freeze", step)
        if f is not None:
            self._fire(f, step=step)
            self._frozen = True
        for kind in ("nan", "inf"):
            f = self.due(kind, step)
            if f is not None:
                if engine is None:
                    raise RuntimeError(
                        f"chaos fault {f.id} needs an engine to poison")
                leaf = self._poison(engine, f, kind)
                self._fire(f, step=step, leaf=leaf)
        f = self.due("scale_poison", step)
        if f is not None:
            if engine is None:
                raise RuntimeError(
                    f"chaos fault {f.id} needs an engine to poison")
            layer = self._poison_scale(engine, f)
            self._fire(f, step=step, layer=layer)
        f = self.due("kill", step)
        if f is not None:
            self._fire(f, step=step)
            os.kill(os.getpid(), signal.SIGKILL)

    def _poison(self, engine, fault: Fault, kind: str) -> int:
        """Scale one seeded parameter leaf by NaN / Inf on every copy
        the engine holds; returns its index in `leaf_paths` order (the
        reference's `tree_flatten` order over the same tree). Engines
        that keep live replicas list them in `param_copies()` (each
        replica's leaf is scaled in place); the GSPMD family's
        `layout_params` is its tree in the reference engine's layout
        (the pipeline's blocks stacked), gathered, and assigning it
        installs it in every cell; any other engine's `params` is
        replaced by a copy with the leaf scaled."""
        import torch

        bad = float("nan") if kind == "nan" else float("inf")
        copies = getattr(engine, "param_copies", None)
        if copies is not None:
            trees = copies()
            paths = list(leaf_paths(trees[0]))
            idx = int(self._rng(fault).integers(0, len(paths)))
            with torch.no_grad():
                for tree in trees:
                    _at(tree, paths[idx]).mul_(bad)
            return idx
        attr = ("layout_params" if hasattr(type(engine), "layout_params")
                else "params")
        tree = getattr(engine, attr)
        paths = list(leaf_paths(tree))
        idx = int(self._rng(fault).integers(0, len(paths)))
        try:
            setattr(engine, attr,
                    _replaced(tree, paths[idx], lambda x: _scaled(x, bad)))
        except AttributeError:
            raise RuntimeError(
                f"chaos fault {fault.id} needs an engine with "
                f"assignable params; {type(engine).__name__} exposes "
                f"a read-only view (use kill/stall/freeze/save faults "
                f"with this engine)") from None
        return idx

    def _poison_scale(self, engine, fault: Fault) -> int:
        """Zero one seeded layer's fp8 amax history: its delayed scale
        collapses to the divide floor next step, so every quantize on
        that layer saturates (the scale_collapse verdict and a
        shadow-parity blowup, not a non-finite gradient)."""
        hist = getattr(engine, "amax_hist", None)
        if hist is None:
            raise RuntimeError(
                f"chaos fault {fault.id} needs an engine with an "
                f"amax_hist (fp8 delayed scaling); "
                f"{type(engine).__name__} has none — use "
                f"kill/nan/inf/stall/freeze with this engine")
        layer = int(self._rng(fault).integers(0, hist.shape[0]))
        hist = hist.clone()
        hist[layer] = 0.0
        engine.amax_hist = hist
        return layer

    def heartbeat_frozen(self) -> bool:
        return self._frozen

    def unfired(self) -> list[str]:
        """Faults still scheduled but never fired: a drill that ends
        with entries here injected less than planned. The drivers
        report them at a clean exit."""
        return [f.id for f in self.faults if not self.fired(f)]

    def on_data_load(self, step: int) -> None:
        """Data-loader hook (the drivers' batch producers and
        `data/dataset.py`): a stall fault sleeps here."""
        f = self.due("stall", step)
        if f is not None:
            secs = float(f.arg) if f.arg is not None else 2.0
            self._fire(f, step=step, seconds=round(secs, 3))
            time.sleep(secs)

    # ------------------------------------------------------ save hooks

    def _save_count(self, advance: bool) -> int:
        """1-based ordinal of the current save, shared across restarts
        through the state dir (a fault aimed at save K counts the saves
        earlier children completed)."""
        if self.state_dir is None:
            if advance:
                self._mem_saves += 1
            return self._mem_saves
        p = self.state_dir / "save_count"
        try:
            n = int(p.read_text())
        except (OSError, ValueError):
            n = 0
        if advance:
            n += 1
            p.write_text(str(n))
        return n

    def on_save(self, point: str) -> None:
        """Checkpoint-writer hook (`checkpoint._write_ckpt`). Points
        stream in as ``start``, ``file:<name>`` per npz written,
        ``pre_rename``, ``renamed``. ENOSPC raises at ``start``;
        kill_in_save SIGKILLs at a seeded point offset."""
        if point == "start":
            n = self._save_count(advance=True)
            self._save_point = 0
            self._save_target = None
            self._save_fault = None
            f = self.due("kill_in_save", n)
            if f is not None:
                # a seeded offset among the upcoming points; 6 exceeds
                # any real save's point count, so high draws fall
                # through to fire at the 'renamed' point
                self._save_target = int(self._rng(f).integers(0, 6))
                self._save_fault = f
            f = self.due("enospc", n)
            if f is not None:
                self._fire(f, save=n)
                raise OSError(errno.ENOSPC, os.strerror(errno.ENOSPC),
                              "chaos: injected ENOSPC during save")
            return
        if self._save_fault is None:
            return
        hit = (self._save_point == self._save_target
               or point == "renamed")
        self._save_point += 1
        if hit:
            f, self._save_fault = self._save_fault, None
            self._fire(f, point=point)
            os.kill(os.getpid(), signal.SIGKILL)

    def after_save(self, final_path) -> None:
        """Post-hoc corruption of a just-landed checkpoint: a seeded
        bit flip / truncation / member deletion the manifest
        verification must catch at the next restore."""
        n = self._save_count(advance=False)
        f = self.due("corrupt", n)
        if f is None:
            return
        mode = f.arg or "bitflip"
        rng = self._rng(f)
        npz = sorted(Path(final_path).glob("*.npz"))
        if not npz:
            return
        target = npz[int(rng.integers(0, len(npz)))]
        if mode == "delete":
            target.unlink()
        elif mode == "truncate":
            data = target.read_bytes()
            target.write_bytes(data[: max(1, len(data) // 2)])
        else:  # bitflip
            data = bytearray(target.read_bytes())
            pos = int(rng.integers(0, len(data)))
            data[pos] ^= 1 << int(rng.integers(0, 8))
            target.write_bytes(bytes(data))
        self._fire(f, save=n, path=str(target), mode=mode)


def parse_fleet_spec(spec: str) -> dict:
    """Per-replica chaos plans for fleet drills: ``'r0=kill@6;r1=
    stall@3:0.5'`` maps replica names to ordinary plan specs, each
    validated here; returns {name: spec}."""
    out: dict[str, str] = {}
    for tok in spec.split(";"):
        tok = tok.strip()
        if not tok:
            continue
        name, eq, sub = tok.partition("=")
        if not eq or not name.strip() or not sub.strip():
            raise ValueError(
                f"bad fleet chaos token {tok!r} (want "
                f"'replica=plan', e.g. 'r0=kill@6;r1=stall@3:0.5')")
        for t in sub.split(","):
            if t.strip():
                _parse_token(t)       # typed error on a bad sub-plan
        out[name.strip()] = sub.strip()
    if not out:
        raise ValueError(f"empty fleet chaos spec {spec!r}")
    return out


# --------------------------------------------------- module-level plan
#
# One plan per process: the drivers configure it from --chaos (or the
# supervisor-exported env), and the checkpoint writer's hooks read it
# through active() — on the async saver's writer thread too.

_PLAN: FaultPlan | None = None
_ENV_CHECKED = False

# fault-stamp observers: the live monitor's `note_line` and the
# profiler's `on_fault`, so an injected fault reaches them in-process
# before the process the fault may kill is gone
_observers: list = []


def add_observer(fn) -> None:
    """Register a callable(record_dict) invoked at every fault stamp."""
    if fn not in _observers:
        _observers.append(fn)


def remove_observer(fn) -> None:
    try:
        _observers.remove(fn)
    except ValueError:
        pass


def configure(plan: FaultPlan | None) -> FaultPlan | None:
    global _PLAN, _ENV_CHECKED
    _PLAN = plan
    _ENV_CHECKED = True
    return plan


def setup(spec: str = "", seed: int = 0, state_dir=None,
          log_file=None) -> FaultPlan | None:
    """Driver entry: install a plan from the --chaos flag, falling back
    to the supervisor-exported environment (whose state dir and seed
    then win over the driver's defaults). Returns None, and installs
    nothing, when neither names a plan."""
    env_seed = os.environ.get(ENV_SEED)
    if not spec:
        spec = os.environ.get(ENV_SPEC, "")
        if not spec:
            return configure(None)
        if env_seed is not None:
            seed = int(env_seed)
        state_dir = os.environ.get(ENV_STATE) or state_dir
    return configure(FaultPlan.parse(spec, seed=seed,
                                     state_dir=state_dir,
                                     log_file=log_file))


def active() -> FaultPlan | None:
    """The installed plan, adopted from the environment on first use so
    the checkpoint hooks fire in a process that never called setup()."""
    global _ENV_CHECKED
    if _PLAN is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        if os.environ.get(ENV_SPEC):
            return setup()
    return _PLAN


# no-ops when no plan is installed

def on_step(step: int, engine=None) -> None:
    plan = active()
    if plan is not None:
        plan.on_step(step, engine)


def on_data_load(step: int) -> None:
    plan = active()
    if plan is not None:
        plan.on_data_load(step)


def on_save(point: str) -> None:
    plan = active()
    if plan is not None:
        plan.on_save(point)


def after_save(final_path) -> None:
    plan = active()
    if plan is not None:
        plan.after_save(final_path)


def heartbeat_frozen() -> bool:
    plan = active()
    return plan is not None and plan.heartbeat_frozen()
