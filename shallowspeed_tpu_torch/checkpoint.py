"""Checkpoint / resume — counterpart of `shallowspeed_tpu/checkpoint.py`
for one process, in the same on-disk format, so a checkpoint written by
either package restores in the other.

- **Format**: `ckpt_N/` holds one `.npz` per tree — `params.npz` (the
  canonical f32 parameters), `opt.npz` (the optimizer state, its meta
  saying which engine and optimizer wrote it), `opt_canon.npz` (the
  same state in the canonical whole-model layout, written by the
  engines whose layout is not canonical: the MLP pipeline engines), and
  any `extra` trees (`ema.npz`) — plus `manifest.json`. An npz holds numbered members
  `leaf_i` and a uint8 member `spec`, the JSON of {"tree": structure,
  "meta": ...}; the structure tells dicts (sorted keys), lists, tuples
  and None apart. No pickle anywhere.
- **Stored, not deflated** (the one divergence): the reference writes
  `np.savez_compressed`; this package writes `np.savez`. Random f32
  weights deflate to ~93 % of their size at a few MB/s, which at the
  1.21B LM's 14.5 GB would be minutes a save. `np.load` reads stored
  and deflated members alike, so each package reads the other's files.
- **Atomic and durable**: a save writes `ckpt_N.tmp/`, fsyncs each
  file, writes the manifest, fsyncs the directory, renames it to
  `ckpt_N` and fsyncs the parent; `latest()` never picks a `.tmp`.
- **Integrity**: `manifest.json` holds each npz's SHA-256 and size;
  `verify` checks them and raises `CheckpointError`, `quarantine`
  renames a bad directory to `ckpt_N.corrupt`, `restore_latest` falls
  back to the newest checkpoint that verifies and loads. Retention
  (`keep`) never deletes the newest verified checkpoint. Checkpoints
  from before manifests restore on completeness alone.
- `restore` verifies first, then checks the parameters' structure and
  shapes against the engine (`ValueError` on a mismatch: a wrong
  config is a user error, not corruption), then installs params, then
  the optimizer state: the engine's own record when the same engine
  class wrote it, else the canonical record re-laid into this engine's
  layout, so each MLP engine restores any other's checkpoint. The LM
  engine's ZeRO layouts hand `opt.npz` the canonical (unsharded) state
  and cut a restored one into their slices (`parallel/zero.py`), so its
  checkpoints cross between (dp, sp) layouts and packages.

Left out, with the reference's multi-process and fault-injection
planes: the collective fetch and the barriers around a save (ROADMAP
Queue 1 item 5b, `distributed.py` and the multi-process launch; one
process drives every cell of a grid here) and the chaos hooks (item
6).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import shutil
import threading
import time
import warnings
import zipfile
from pathlib import Path

import numpy as np
import torch

from shallowspeed_tpu_torch.weights import (leaves, opt_state_to_numpy,
                                            params_to_numpy, to_host)

_FILES = ("params.npz", "opt.npz")
_MANIFEST = "manifest.json"

# the process exit code of a strict --resume that found every
# checkpoint corrupt; the reference's supervisor classes it as
# checkpoint corruption (`shallowspeed_tpu/elastic.py::EXIT_CORRUPT_CKPT`)
EXIT_CORRUPT_CKPT = 65


class CheckpointError(RuntimeError):
    """A checkpoint could not be trusted or loaded: integrity
    verification failed, an npz is unreadable/truncated, or a manifest
    member is missing. Carries the offending path — callers quarantine
    it and fall back to the newest verified checkpoint."""

    def __init__(self, msg: str, path=None):
        super().__init__(msg)
        self.path = Path(path) if path is not None else None


# ------------------------------------------------------------ durability


def _fsync_path(path) -> None:
    """fsync a file or directory by fd: the rename is only durable if
    the data and the directory entries are forced out first."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# -------------------------------------------------------------- integrity


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(ckpt_dir) -> Path:
    """Per-file SHA-256 manifest over every npz in the directory,
    written INSIDE the atomic tmp dir, so a renamed checkpoint always
    carries its own integrity record."""
    d = Path(ckpt_dir)
    files = {p.name: {"sha256": _sha256(p), "bytes": p.stat().st_size}
             for p in sorted(d.glob("*.npz"))}
    path = d / _MANIFEST
    path.write_text(json.dumps({"version": 1, "files": files},
                               indent=0) + "\n")
    _fsync_path(path)
    return path


def verify(ckpt_dir) -> None:
    """Raise CheckpointError unless the checkpoint's bytes match its
    manifest. Pre-manifest checkpoints (nothing to hash against) pass
    on completeness alone — new saves always write a manifest."""
    d = Path(ckpt_dir)
    man = d / _MANIFEST
    if not man.exists():
        for f in _FILES:
            if not (d / f).exists():
                raise CheckpointError(
                    f"checkpoint {d} is incomplete (no {f}, no "
                    f"manifest)", path=d / f)
        return
    try:
        listed = json.loads(man.read_text())["files"]
        # valid JSON of the wrong shape must quarantine like any other
        # corruption, not escape as a raw TypeError
        if not isinstance(listed, dict) or not all(
                isinstance(rec, dict) for rec in listed.values()):
            raise TypeError("manifest 'files' is not a dict of dicts")
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointError(
            f"checkpoint {d} has an unreadable manifest ({e})",
            path=man) from e
    for name, rec in sorted(listed.items()):
        p = d / name
        if not p.exists():
            raise CheckpointError(
                f"checkpoint {d}: manifest lists {name} but the file "
                f"is missing", path=p)
        size = p.stat().st_size
        if size != rec.get("bytes"):
            raise CheckpointError(
                f"checkpoint {d}: {name} is {size} bytes, manifest "
                f"says {rec.get('bytes')} (truncated?)", path=p)
        digest = _sha256(p)
        if digest != rec.get("sha256"):
            raise CheckpointError(
                f"checkpoint {d}: {name} SHA-256 mismatch "
                f"({digest[:12]}… != {str(rec.get('sha256'))[:12]}…)",
                path=p)


def is_verified(ckpt_dir) -> bool:
    try:
        verify(ckpt_dir)
        return True
    except CheckpointError:
        return False


def quarantine(ckpt_dir) -> Path | None:
    """Rename a bad checkpoint dir to `ckpt_N.corrupt` (numbered on
    collision) so `latest()` never considers it again but the bytes
    stay for forensics. Returns the new path, or None when the rename
    failed (the dir was moved already, or the filesystem refuses)."""
    d = Path(ckpt_dir)
    target = d.with_name(d.name + ".corrupt")
    n = 1
    while target.exists():
        n += 1
        target = d.with_name(f"{d.name}.corrupt{n}")
    try:
        d.rename(target)
    except OSError:
        return None
    warnings.warn(f"quarantined corrupt checkpoint {d} -> {target}")
    return target


# ----------------------------------------------------------- pytree <-> npz


def _numpy_leaf(x) -> np.ndarray:
    """A leaf as the numpy array a checkpoint holds: a tensor as a host
    copy (a bf16 tensor has no numpy form, so only f32 masters may
    reach a checkpoint), anything else through `np.asarray`."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if x.dtype == torch.bfloat16:
        raise TypeError("a bfloat16 tensor has no numpy form; checkpoint "
                        "the float32 master weights")
    return to_host(x)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _encode(tree, leaves: list, leaf=_numpy_leaf):
    """Deterministic traversal of dict/list/tuple/None nests; appends
    `leaf(x)` of each array leaf (a tensor, a numpy array or a Python
    number) to `leaves` and returns the JSON-able structure spec (the
    reference's, key for key)."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"kind": "dict", "keys": keys,
                "children": [_encode(tree[k], leaves, leaf) for k in keys]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"kind": kind,
                "children": [_encode(c, leaves, leaf) for c in tree]}
    if tree is None:
        return {"kind": "none"}
    leaves.append(leaf(tree))
    return {"kind": "leaf", "index": len(leaves) - 1}


def _decode(spec, leaves):
    kind = spec["kind"]
    if kind == "dict":
        return {k: _decode(c, leaves)
                for k, c in zip(spec["keys"], spec["children"])}
    if kind == "list":
        return [_decode(c, leaves) for c in spec["children"]]
    if kind == "tuple":
        return tuple(_decode(c, leaves) for c in spec["children"])
    if kind == "none":
        return None
    return leaves[spec["index"]]


def save_pytree(path, tree, meta: dict | None = None) -> None:
    """One npz per tree: numbered array leaves + the JSON spec (+ JSON
    meta), members stored uncompressed."""
    leaves: list[np.ndarray] = []
    spec = _encode(tree, leaves)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["spec"] = np.frombuffer(
        json.dumps({"tree": spec, "meta": meta or {}}).encode(), np.uint8)
    np.savez(path, **payload)


def load_pytree(path, with_meta: bool = False):
    with np.load(path, allow_pickle=False) as z:
        head = json.loads(z["spec"].tobytes().decode())
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    tree = _decode(head["tree"], leaves)
    return (tree, head["meta"]) if with_meta else tree


def _structure_mismatch(a, b) -> str | None:
    """None if `a` and `b` have the same structure (kinds and dict keys,
    as `_encode` records them) and leaf shapes, else a description."""
    sa, sb = [], []
    ta = _encode(a, sa, _shape)
    tb = _encode(b, sb, _shape)
    if ta != tb:
        return f"tree structure {json.dumps(ta)} != {json.dumps(tb)}"
    for i, (x, y) in enumerate(zip(sa, sb)):
        if x != y:
            return f"leaf {i} shape {x} != {y}"
    return None


# ------------------------------------------------------------- save/restore


def _write_ckpt(ckpt_dir, epoch: int, params, opt_state, meta: dict,
                extra: dict, opt_canon=None, canon_meta=None,
                keep: int | None = None, stats: dict | None = None) -> Path:
    """The one encoding of the on-disk layout + atomic rename, shared by
    the synchronous and async save paths. The trees are host copies.
    `stats`, when given, receives the seconds of the write with its
    fsyncs (`write_s`), of the manifest's hashing (`hash_s`) and of the
    rename with its fsyncs (`rename_s`), and the bytes written."""
    final = Path(ckpt_dir) / f"ckpt_{epoch}"
    tmp = Path(ckpt_dir) / f"ckpt_{epoch}.tmp"
    # multi-process runs: the collective fetch and the barrier around
    # this write come with ROADMAP Queue 1 item 5b's multi-process
    # launch; the chaos hooks
    # (chaos.on_save) with item 6
    t0 = time.perf_counter()
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    def _write(name, tree, meta=None):
        save_pytree(tmp / name, tree, meta=meta)
        # force the bytes out BEFORE the rename publishes the dir
        _fsync_path(tmp / name)

    _write("params.npz", params)
    _write("opt.npz", opt_state, meta=meta)
    if opt_canon is not None:
        _write("opt_canon.npz", opt_canon, meta=canon_meta)
    for name, tree in sorted(extra.items()):
        _write(f"{name}.npz", tree)
    t1 = time.perf_counter()
    write_manifest(tmp)
    _fsync_path(tmp)
    t2 = time.perf_counter()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _fsync_path(final.parent)   # the rename itself must be durable too
    t3 = time.perf_counter()
    if keep:
        prune(ckpt_dir, keep, trusted=final)
    # chaos.after_save(final) goes here with ROADMAP Queue 1 item 6
    if stats is not None:
        stats.update(write_s=t1 - t0, hash_s=t2 - t1, rename_s=t3 - t2,
                     bytes=sum(p.stat().st_size
                               for p in final.glob("*.npz")))
    return final


def _opt_meta(engine, epoch: int) -> dict:
    opt = getattr(engine, "optimizer", None)
    return {
        "epoch": int(epoch),
        "engine": type(engine).__name__,
        "optimizer": None if opt is None else type(opt).__name__,
        # True => opt.npz doubles as the canonical record (identity
        # layout); a cross-engine restore may import it directly
        "opt_is_canonical": bool(
            getattr(engine, "canonical_opt_identity", False)),
    }


def _canon_opt_export(engine, host_opt_state):
    """The engine-agnostic optimizer record for `opt_canon.npz` (host
    numpy) and its meta, or (None, None) when none is needed: an
    identity-layout engine's `opt.npz` already IS the canonical record
    (`opt_is_canonical` in its meta). The per-stage VM merges its
    stages (`canon_opt_export`); the stacked SPMD engine re-lays each
    params-shaped moment tree with its params' transform
    (`Optimizer.map_state_trees` + `canon_export_tree`)."""
    opt = getattr(engine, "optimizer", None)
    if opt is None or getattr(engine, "canonical_opt_identity", False):
        return None, None
    meta = {"optimizer": type(opt).__name__}
    custom = getattr(engine, "canon_opt_export", None)
    if custom is not None:
        return opt_state_to_numpy(custom()), meta
    export = getattr(engine, "canon_export_tree", None)
    if export is None:
        return None, None
    try:
        return opt.map_state_trees(host_opt_state, export), meta
    except ValueError:      # not params-shaped (Adafactor's factored
        return None, None   # slots): opt.npz alone, as the reference


def _canon_opt_import(engine, canon):
    """Inverse of `_canon_opt_export`: the canonical state in this
    engine's layout (host-side), or None when it cannot import."""
    if getattr(engine, "canonical_opt_identity", False):
        return canon
    custom = getattr(engine, "canon_opt_import", None)
    if custom is not None:
        return custom(canon)
    imp = getattr(engine, "canon_import_tree", None)
    if imp is None:
        return None
    return engine.optimizer.map_state_trees(canon, imp)


def _snapshot(engine, extra: dict | None, stats: dict | None):
    """Host copies of the engine's params and optimizer state (the
    step `t` as a 0-d int32 array), of its canonical optimizer record
    where it has one (with that record's meta), and of the `extra`
    trees."""
    t0 = time.perf_counter()
    params = params_to_numpy(engine.get_canonical_params())
    opt_state = opt_state_to_numpy(engine.opt_state)
    canon = _canon_opt_export(engine, opt_state)
    extra = {k: params_to_numpy(v) for k, v in (extra or {}).items()}
    if stats is not None:
        stats["fetch_s"] = time.perf_counter() - t0
    return params, opt_state, canon, extra


def _candidates(ckpt_dir) -> list[tuple[int, Path]]:
    """(epoch, path) for every directory that *claims* to be a complete
    checkpoint: a manifest marks completion for new saves; the legacy
    rule (both npz present) covers pre-manifest dirs. `.tmp` leftovers,
    `.corrupt` quarantines, and foreign names never qualify."""
    d = Path(ckpt_dir)
    found = []
    for p in d.iterdir() if d.exists() else ():
        m = re.fullmatch(r"ckpt_(\d+)", p.name)
        if not m:
            continue
        if (p / _MANIFEST).exists() \
                or all((p / f).exists() for f in _FILES):
            found.append((int(m.group(1)), p))
    return sorted(found)


def prune(ckpt_dir, keep: int, trusted=None) -> None:
    """Delete all complete `ckpt_N` directories except the `keep`
    highest-epoch ones, but NEVER the newest *verified* checkpoint: if
    everything newer is corrupt, the one restorable state must survive
    rotation, whatever its age. `trusted`: a path this process just
    wrote and hashed, taken as verified without re-reading it. `.tmp`
    leftovers and foreign names are untouched."""
    if keep < 1:
        raise ValueError(f"prune keeps at least one checkpoint, got {keep}")
    found = _candidates(ckpt_dir)
    doomed = found[:-keep or None]
    if doomed:
        trusted = Path(trusted) if trusted is not None else None
        for _, p in reversed(found):
            if p == trusted or is_verified(p):
                doomed = [(e, q) for e, q in doomed if q != p]
                break
    for _, p in doomed:
        shutil.rmtree(p, ignore_errors=True)


def save(ckpt_dir, engine, epoch: int, extra: dict | None = None,
         keep: int | None = None, stats: dict | None = None) -> Path:
    """Atomically write `ckpt_dir/ckpt_{epoch}/`: canonical params +
    the engine's optimizer state (+ `extra` {file stem: tree}, e.g. the
    driver's EMA weights, inside the same atomic rename). `keep` prunes
    to that many checkpoints. `stats`, when given, receives the seconds
    of the device-to-host fetch (`fetch_s`) and of `_write_ckpt`'s
    stages, and the bytes written."""
    params, opt_state, canon, extra = _snapshot(engine, extra, stats)
    return _write_ckpt(ckpt_dir, epoch, params, opt_state,
                       _opt_meta(engine, epoch), extra, *canon, keep=keep,
                       stats=stats)


class AsyncSaver:
    """Non-blocking checkpointing: the device->host snapshot happens on
    the caller's thread (it pins the state at the save point), then the
    npz writing, hashing and the atomic rename run on ONE background
    worker, so the training loop never blocks on disk. Saves land in
    order; `wait()` drains the queue (call it before reading `latest()`
    or exiting). Errors surface on the next save()/wait() call rather
    than being swallowed."""

    def __init__(self):
        # maxsize bounds host memory: each queued save pins a full host
        # snapshot of params + opt state (+ EMA); if the disk is slower
        # than the --save-every cadence, save() backpressures the loop
        self._q = queue.Queue(maxsize=2)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                item()
            except Exception as e:  # surfaced on the caller's side
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint save failed") from err

    def save(self, ckpt_dir, engine, epoch: int,
             extra: dict | None = None, keep: int | None = None,
             stats: dict | None = None) -> None:
        """Snapshot now, write later; the engine may keep training (and
        updating its tensors in place) at once. `stats` as `save`'s,
        filled by the worker once the write is done."""
        self._raise_pending()
        params, opt_state, canon, extra = _snapshot(engine, extra, stats)
        meta = _opt_meta(engine, epoch)

        def write():
            _write_ckpt(ckpt_dir, epoch, params, opt_state, meta, extra,
                        *canon, keep=keep, stats=stats)

        self._q.put(write)

    def wait(self) -> None:
        """Block until every queued save is on disk; re-raise failures."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the worker, re-raise failures."""
        self._q.join()
        self._q.put(None)
        self._q.join()
        self._thread.join()
        self._raise_pending()


def has_checkpoint(ckpt_dir) -> bool:
    """Whether any complete-looking checkpoint exists — a cheap probe
    (no hashing). The auto-resume gate uses it and leaves verification,
    quarantine and fallback to `restore_latest`, so the newest
    checkpoint is hashed once, at restore."""
    return bool(_candidates(ckpt_dir))


def latest(ckpt_dir) -> Path | None:
    """Highest-epoch VERIFIED checkpoint directory (ignores `.tmp`
    leftovers, foreign `ckpt_*` names, and incomplete dirs). A complete
    dir that fails verification is quarantined as `ckpt_N.corrupt` on
    the spot and the scan falls back to the next newest."""
    for _, p in reversed(_candidates(ckpt_dir)):
        if is_verified(p):
            return p
        quarantine(p)
    return None


def _load_checked(path, with_meta: bool = False):
    """load_pytree with every load-path failure (truncated zip, bad JSON
    spec, missing members, IO errors) as the one typed CheckpointError
    carrying the offending path."""
    try:
        return load_pytree(path, with_meta=with_meta)
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        raise CheckpointError(
            f"checkpoint file {path} failed to load "
            f"({type(e).__name__}: {e})", path=path) from e


def load_params(ckpt_path, template) -> dict:
    """The verified parameter tree (numpy) of checkpoint dir
    `ckpt_path`, checked against `template` (a tree of the model's
    parameters, or of anything with their shapes): CheckpointError when
    the checkpoint is missing, corrupt or unreadable, ValueError when
    its structure or shapes differ from the template's."""
    d = Path(ckpt_path)
    if not (d / "params.npz").exists():
        raise CheckpointError(f"checkpoint {d} has no params.npz",
                              path=d / "params.npz")
    verify(d)
    params = _load_checked(d / "params.npz")
    mismatch = _structure_mismatch(params, template)
    if mismatch is not None:
        raise ValueError(
            f"checkpoint {d} does not match this model config "
            f"({mismatch}); refusing to restore")
    return params


def _restore_opt_canonical(engine, d: Path, opt_state, meta) -> bool:
    """Try the engine-agnostic optimizer record: `opt_canon.npz` if
    present (a layout-transforming engine wrote it), else `opt.npz`
    itself when its meta says the writing engine's layout was
    canonical; re-laid into this engine's layout (`_canon_opt_import`).
    Returns True when it was installed."""
    path = d / "opt_canon.npz"
    if path.exists():
        canon, cmeta = _load_checked(path, with_meta=True)
        src_kind = cmeta.get("optimizer")
    elif meta.get("opt_is_canonical"):
        canon, src_kind = opt_state, meta.get("optimizer")
    else:
        return False
    opt = engine.optimizer
    if src_kind != type(opt).__name__:
        warnings.warn(f"canonical opt state is {src_kind} but this "
                      f"engine runs {type(opt).__name__}; re-initializing")
        return False
    state = _canon_opt_import(engine, canon)
    if state is None:
        return False
    mismatch = _structure_mismatch(state, engine.opt_state)
    if mismatch is not None:
        warnings.warn(f"canonical opt state does not match this engine's "
                      f"optimizer ({mismatch}); re-initializing")
        return False
    engine.set_opt_state(state)
    return True


def restore(engine, ckpt_path, stats: dict | None = None) -> int:
    """Load a checkpoint into `engine`; returns the next step.

    The manifest is verified BEFORE anything is installed (a corrupt
    checkpoint raises CheckpointError; quarantine-and-fall-back is
    `restore_latest`'s job). The parameters' structure and shapes are
    checked against the engine's (ValueError on a mismatch). The
    optimizer state restores from the canonical record where the writer
    left one, else when the same engine class wrote a state of the same
    structure, else it is re-initialized with a warning. `stats`, when
    given, receives the seconds of the verification (`verify_s`), of
    reading the npz files (`load_s`) and of placing them on the device
    (`place_s`), and the bytes read."""
    d = Path(ckpt_path)
    t0 = time.perf_counter()
    if not (d / "params.npz").exists():
        raise CheckpointError(f"checkpoint {d} has no params.npz",
                              path=d / "params.npz")
    verify(d)
    t1 = time.perf_counter()
    params = _load_checked(d / "params.npz")
    mismatch = _structure_mismatch(params, engine.get_canonical_params())
    if mismatch is not None:
        raise ValueError(
            f"checkpoint {d} does not match this engine's model config "
            f"({mismatch}); refusing to restore")
    opt_state, meta = _load_checked(d / "opt.npz", with_meta=True)
    t2 = time.perf_counter()
    engine.set_canonical_params(params)
    del params
    # a layout-transforming writer leaves the canonical record: it goes
    # first, since the same engine class may lay its state out otherwise
    # (a pipeline at another virtual_pp permutes its stacked layers)
    same = (meta["engine"] == type(engine).__name__
            and _structure_mismatch(opt_state, engine.opt_state) is None)
    if same and not (d / "opt_canon.npz").exists():
        engine.set_opt_state(opt_state)
    elif any(True for _ in leaves(opt_state)):
        if _restore_opt_canonical(engine, d, opt_state, meta):
            pass                # the canonical record, re-laid
        elif same:
            engine.set_opt_state(opt_state)
        else:
            warnings.warn(
                f"checkpoint opt state is {meta['engine']}-shaped and "
                f"does not match this {type(engine).__name__}'s "
                f"(no importable canonical record); re-initializing")
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t3 = time.perf_counter()
    nxt = int(meta["epoch"]) + 1
    # the step counter resumes at the global step, as the reference's
    # restore sets it (its dropout keys derive from it)
    engine._step_count = nxt
    if stats is not None:
        stats.update(verify_s=t1 - t0, load_s=t2 - t1, place_s=t3 - t2,
                     bytes=sum(p.stat().st_size for p in d.glob("*.npz")
                               if p.name in _FILES))
    return nxt


def restore_latest(engine, ckpt_dir, stats: dict | None = None
                   ) -> tuple[int, Path | None, list[Path]]:
    """Restore the newest checkpoint that both verifies AND loads,
    quarantining every one that doesn't and falling back. Returns
    `(next_step, restored_path, quarantined_paths)`; `(0, None, [...])`
    when nothing restorable remains. Config mismatches (ValueError)
    propagate: a wrong --resume target is a user error, not corruption
    to quarantine. `stats` as `restore`'s, for the one restored."""
    quarantined: list[Path] = []
    while True:
        cands = _candidates(ckpt_dir)
        if not cands:
            return 0, None, quarantined
        _, ck = cands[-1]
        try:
            return restore(engine, ck, stats), ck, quarantined
        except CheckpointError as e:
            warnings.warn(f"restore of {ck} failed ({e}); quarantining "
                          f"and falling back")
            q = quarantine(ck)
            if q is None:
                # the dir could not be renamed (a read-only FS): bail
                # rather than spin on the same dir
                return 0, None, quarantined
            quarantined.append(q)
