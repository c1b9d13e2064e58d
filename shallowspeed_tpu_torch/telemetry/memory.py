"""Live device-memory accounting — the port's memory observatory,
counterpart of `shallowspeed_tpu/telemetry/memory.py` on the CUDA
caching allocator.

- `live_hbm_high_water()`: per-device bytes the allocator holds for
  live tensors (`torch.cuda.memory_allocated`). The reference sums
  `jax.live_arrays()`; torch has no list of live arrays, and the
  caching allocator's live blocks are the closest counterpart (they
  also count the in-step transients still alive, and round each
  block up to the allocator's granule). On the CPU there is no
  allocator count: 0 bytes.
- `device_memory_stats()`: the allocator's own view per CUDA device
  (`torch.cuda.memory_stats`), with `allocated_bytes.all.current` /
  `.peak` under the reference's `bytes_in_use` / `peak_bytes_in_use`
  keys; {} on the CPU, as the reference's CPU path returns.

The reference's static prediction (`static_peak_bytes`, `cross_check`)
walks the jaxpr with `analysis/`, which the port does not have: there
is no static HBM bound here, so `hbm_static_mib` / `hbm_within_bound`
stay absent from step lines, as they are in the reference without a
static report.

The OWNERSHIP REGISTRY decomposes the allocated total: engines and
drivers register their long-lived trees (params, optimizer state, KV
block pools) as zero-arg resolvers, and `per_owner_accounting()`
attributes each tensor's storage to the first owner whose resolved
tree holds it. Storages are keyed by `untyped_storage().data_ptr()`,
so two views of one buffer (or two owners resolving one tensor) count
its bytes once. What no owner claims is the `untracked` residual —
allocated bytes minus owned bytes, the leak alarm. Resolvers (not
trees) because the trees rotate: optimizer state is replaced every
step, so a registered snapshot would pin dead buffers alive and go
stale within one iteration.

`MemoryWatch` turns the sampled series into `telemetry/anomaly`
verdicts: `mem_drift` (robust EWMA z-spike in resident device bytes or
host RSS) and `mem_leak` (sustained growth over `patience` consecutive
observations) — a copy of the reference's.
"""

from __future__ import annotations

import gc
import warnings

import torch

from shallowspeed_tpu_torch.weights import leaves


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def live_hbm_high_water() -> dict:
    """Allocated bytes per CUDA device; returns {"per_device": {dev_str:
    bytes}, "max_device_bytes", "n_arrays"} (`n_arrays` counts the
    devices sampled: the allocator keeps no per-tensor list)."""
    per_dev = {str(d): int(torch.cuda.memory_allocated(d))
               for d in _cuda_devices()}
    return {"per_device": per_dev,
            "max_device_bytes": max(per_dev.values(), default=0),
            "n_arrays": len(per_dev)}


def device_memory_stats() -> dict:
    """Allocator stats per CUDA device ({} on the CPU): the integer
    entries of `torch.cuda.memory_stats`, plus the reference's
    `bytes_in_use` / `peak_bytes_in_use` (the allocated bytes now and
    their peak since the last `reset_peak_memory_stats`)."""
    out = {}
    for d in _cuda_devices():
        st = torch.cuda.memory_stats(d)
        if not st:
            continue
        rec = {k: int(v) for k, v in st.items()
               if isinstance(v, (int, float))}
        rec["bytes_in_use"] = int(st.get("allocated_bytes.all.current", 0))
        rec["peak_bytes_in_use"] = int(st.get("allocated_bytes.all.peak", 0))
        out[str(d)] = rec
    return out


# ------------------------------------------------- ownership registry
#
# name -> zero-arg resolver returning a tree of tensors (or None when
# the owner has nothing resident yet). Module-global, as the
# reference's: the registry holds no tensor references of its own.

_OWNERS: dict[str, object] = {}


def register_owner(name: str, resolve) -> None:
    """Register (or replace) a memory owner. `resolve` is a zero-arg
    callable returning the owner's CURRENT tree of tensors (dicts,
    lists, tuples) — called fresh at every accounting point. Return
    None (or raise) to report nothing this window."""
    if not callable(resolve):
        raise TypeError(f"register_owner({name!r}): resolver must be "
                        f"callable, got {type(resolve).__name__}")
    _OWNERS[str(name)] = resolve


def unregister_owner(name: str) -> None:
    _OWNERS.pop(str(name), None)


def clear_owners() -> None:
    """Drop every registered owner (test isolation / driver teardown)."""
    _OWNERS.clear()


def registered_owners() -> tuple:
    return tuple(_OWNERS)


def _leaves(tree):
    return (x for x in leaves(tree) if isinstance(x, torch.Tensor))


def _storage(t: torch.Tensor):
    """(storage key, bytes) of a tensor's whole storage; None for a
    tensor without one (meta)."""
    try:
        st = t.untyped_storage()
        return (t.device.type, t.device.index, st.data_ptr()), int(st.nbytes())
    except (RuntimeError, NotImplementedError):
        return None


def _device_total(tensors) -> int:
    """The bytes the allocator holds now: `memory_allocated` summed over
    the CUDA devices; on a CPU-only run the storages of `tensors`."""
    devs = _cuda_devices()
    if devs:
        return sum(int(torch.cuda.memory_allocated(d)) for d in devs)
    seen = {}
    for t in tensors:
        s = _storage(t)
        if s is not None:
            seen[s[0]] = s[1]
    return sum(seen.values())


def per_owner_accounting() -> dict:
    """Decompose the allocated bytes (all CUDA devices) into per-owner
    contributions plus the unclaimed residual:

        {"owners": {name: bytes}, "tracked_bytes", "untracked_bytes",
         "live_bytes", "n_live_arrays"}

    Each storage is claimed at most once (first registered owner wins),
    so `sum(owners.values()) == tracked_bytes`. On the card
    `live_bytes` is `memory_allocated` and `untracked_bytes` what the
    owners do not hold (clamped at 0: the allocator rounds blocks up,
    so it never reports less than the owners' storages). Without a card
    the live total is the owners' own storages and the residual 0.
    `n_live_arrays` counts the storages claimed."""
    claimed: dict = {}
    owners: dict[str, int] = {}
    owned_tensors = []
    for name, resolve in _OWNERS.items():
        try:
            tree = resolve()
        except Exception:
            tree = None
        total = 0
        for leaf in _leaves(tree):
            owned_tensors.append(leaf)
            s = _storage(leaf)
            if s is None or s[0] in claimed:
                continue
            claimed[s[0]] = name
            total += s[1]
        owners[name] = total
    tracked = sum(owners.values())
    live = _device_total(owned_tensors)
    return {"owners": owners, "tracked_bytes": int(tracked),
            "untracked_bytes": int(max(0, live - tracked)),
            "live_bytes": int(max(live, tracked)),
            "n_live_arrays": len(claimed)}


def top_live_arrays(k: int = 5) -> list[dict]:
    """The k largest live tensors the garbage collector can reach (one
    entry per storage) — the first thing to read in an OOM dump. Each
    entry carries shape/dtype/bytes plus the owning registry name
    ("untracked" when nothing claims it). Walks `gc.get_objects()`:
    call it only when it is wanted, never inside a step."""
    owner_of: dict = {}
    for name, resolve in _OWNERS.items():
        try:
            tree = resolve()
        except Exception:
            continue
        for leaf in _leaves(tree):
            s = _storage(leaf)
            if s is not None:
                owner_of.setdefault(s[0], name)
    rows, seen = [], set()
    with warnings.catch_warnings():
        # isinstance on some of torch's deprecated objects warns
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        s = _storage(obj)
        if s is None or s[0] in seen:
            continue
        seen.add(s[0])
        rows.append({"shape": list(obj.shape), "dtype": str(obj.dtype),
                     "nbytes": s[1], "device": str(obj.device),
                     "owner": owner_of.get(s[0], "untracked")})
    rows.sort(key=lambda r: r["nbytes"], reverse=True)
    return rows[:max(0, int(k))]


def host_rss_bytes() -> int:
    """Host resident set size, stdlib-only: /proc/self/status VmRSS
    where procfs exists (Linux), else getrusage peak (ru_maxrss is KiB
    on Linux semantics, bytes on macOS — close enough for a trend
    series; the detector watches deltas, not absolutes). 0 when
    neither source works."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss) if sys.platform == "darwin" else int(rss) * 1024
    except Exception:
        return 0


def forensics(top_k: int = 8) -> dict:
    """The memory flight-dump payload: per-owner decomposition, the
    top-k largest live tensors, allocator stats, and host RSS —
    everything host-side (allocates no device memory)."""
    return {"accounting": per_owner_accounting(),
            "top_arrays": top_live_arrays(top_k),
            "device_stats": device_memory_stats(),
            "host_rss_bytes": host_rss_bytes()}


class MemoryWatch:
    """Steady-state leak/drift detector over resident-bytes series — a
    copy of the reference's.

    Two complementary detectors per series (device-resident bytes and
    host RSS, fed by the caller each log window):

    - `mem_drift`: robust EWMA z-spike (`telemetry/anomaly.RobustEWMA`)
      — a step change in residency (a buffer that should have been
      freed and wasn't).
    - `mem_leak`: the slope detector — residency grew by more than
      `growth_frac` in EACH of `patience` consecutive observations. A
      slow leak never z-spikes (the EWMA mean tracks it), but it
      cannot hide from a monotone-growth run.

    Verdicts carry the `telemetry/anomaly` shape."""

    def __init__(self, spike_z: float = 6.0, patience: int = 6,
                 growth_frac: float = 0.01, alpha: float = 0.05,
                 warmup: int = 8):
        from shallowspeed_tpu_torch.telemetry.anomaly import RobustEWMA

        self.spike_z = float(spike_z)
        self.patience = int(patience)
        self.growth_frac = float(growth_frac)
        self._ewma = {"device": RobustEWMA(alpha, warmup),
                      "host_rss": RobustEWMA(alpha, warmup)}
        self._last: dict[str, float] = {}
        self._runs: dict[str, int] = {}
        self._leak_reported: set[str] = set()

    def _observe_series(self, step: int, name: str, x: float) -> list:
        from shallowspeed_tpu_torch.telemetry.anomaly import Verdict

        out = []
        z = self._ewma[name].update(x)
        if z is not None and z > self.spike_z:
            out.append(Verdict(
                "mem_drift", step,
                detail=f"{name} resident {x / (1 << 20):.1f} MiB is "
                       f"{z:.1f} robust sigmas above its EWMA "
                       f"{self._ewma[name].mean / (1 << 20):.1f} MiB"))
        last = self._last.get(name)
        self._last[name] = x
        if last is not None and last > 0 \
                and x > last * (1.0 + self.growth_frac):
            run = self._runs.get(name, 0) + 1
            self._runs[name] = run
            if run >= self.patience and name not in self._leak_reported:
                self._leak_reported.add(name)
                out.append(Verdict(
                    "mem_leak", step, severity="error",
                    detail=f"{name} residency grew >"
                           f"{self.growth_frac:.1%} per window for "
                           f"{run} consecutive windows (now "
                           f"{x / (1 << 20):.1f} MiB)"))
        elif last is not None:
            self._runs[name] = 0
            self._leak_reported.discard(name)
        return out

    def observe(self, step: int, device_bytes=None,
                rss_bytes=None) -> list:
        """Feed one log window's samples; returns anomaly Verdicts
        (possibly empty). Either series may be None (CPU runs have no
        allocator stats; tests may feed only one)."""
        out = []
        if device_bytes is not None:
            out.extend(self._observe_series(step, "device",
                                            float(device_bytes)))
        if rss_bytes is not None and rss_bytes > 0:
            out.extend(self._observe_series(step, "host_rss",
                                            float(rss_bytes)))
        return out
