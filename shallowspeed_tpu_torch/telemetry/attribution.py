"""Per-step time attribution — the roofline waterfall, counterpart of
`shallowspeed_tpu/telemetry/attribution.py`.

Every spans-level step line reconciles the MEASURED (span-fenced) step
time against analytic components:

- **compute**: per-op roofline time of one real training step, counted
  by `roofline_of_step`: a `TorchDispatchMode` is active through the
  step's forward, `backward()` and update and prices every aten op —
  `mm`, `addmm`, `bmm`, `baddbmm` and `matmul` at 2 M N K FLOPs with
  their operand and result bytes as dot bytes, every other op (views
  and allocations aside, which move nothing) at its input and output
  bytes. The hand-written kernels launch through ctypes, where no
  dispatch mode sees them, so their wrappers report their own FLOPs
  and bytes to the active counter (`ops/_work.py`). This replaces the
  reference's jaxpr walk (`roofline_of_jaxpr`): the port has no jaxpr.
- **exposed communication**: the step's counted collective bytes
  (`collectives.py`), all exposed (the reference's value when no
  dataflow exposure is known), priced at the wire rate: NVLink's one-way
  rate from `flops.py` when the cells sit on distinct cards, a copy
  inside HBM (half the HBM rate: each byte read and written) when they
  share one card; the step line's `attrib_wire` names which.
- **pipeline bubble**: `bubble.py`'s fraction, passed through;
- **host/dispatch gap**: the log window's wall time not covered by
  any fenced step span.

What is left is `attrib_unexplained_frac`. On a card `flops.py` knows
(the H100) the rates are its published peaks ("table"); elsewhere (the
CPU tests) a probe calibrates them and the compute component is
self-scaled over the first two spans-level windows, then frozen, as the
reference does.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from shallowspeed_tpu_torch import flops as _flops
from shallowspeed_tpu_torch.ops import _work

# fp8-operand matmul FLOPs run at this multiple of the table/calibrated
# rate: the H100 SXM data sheet's dense e4m3 1,979 TFLOP/s against its
# bf16 989 TFLOP/s, the reference's ratio too
FP8_FLOPS_RATIO = 2.0

# ------------------------------------------------------- device rates

_CALIBRATED: dict | None = None


def _median_timed(fn, reps: int = 5) -> float:
    fn()  # warmup (allocator)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _calibrate() -> dict:
    """Effective CPU rates measured in place (cached per process), each
    as a SLOPE between two probe sizes so the per-call overhead cancels
    out: f32 matmuls at n=256/512 for FLOP/s, 1/4 MiB elementwise sweeps
    for bytes/s (the reference's probe). The wire defaults to the memory
    rate (cells on one host copy in memory)."""
    global _CALIBRATED
    if _CALIBRATED is not None:
        return _CALIBRATED

    def slope(points):  # [(work, seconds)] -> work/s with offset removed
        (w1, t1), (w2, t2) = points
        if t2 - t1 <= 1e-9:
            return w2 / max(t2, 1e-9)  # noise floor: direct large rate
        return (w2 - w1) / (t2 - t1)

    gen = torch.Generator().manual_seed(0)
    mm_pts = []
    for n in (256, 512):
        a = torch.randn((n, n), generator=gen, dtype=torch.float32)
        mm_pts.append((2.0 * n ** 3, _median_timed(lambda: a @ a)))
    ew_pts = []
    for m in (1 << 18, 1 << 20):  # 1 MiB, 4 MiB f32
        x = torch.zeros((m,), dtype=torch.float32)
        ew_pts.append((2.0 * m * 4,
                       _median_timed(lambda: x * 1.0000001 + 1.0)))
    rate = {
        "flops": max(slope(mm_pts), 1e6),
        "hbm": max(slope(ew_pts), 1e6),
        "source": "calibrated",
    }
    rate["ici"] = rate["hbm"]
    rate["wire"] = "memory"
    _CALIBRATED = rate
    return rate


def recalibrate() -> dict:
    """Drop the cached calibration and probe again (tests use this to
    shrug off a host-load transient that skewed the first probe)."""
    global _CALIBRATED
    _CALIBRATED = None
    return _calibrate()


def device_rates(dtype: str = "bf16", device=None,
                 shared: bool = True) -> dict:
    """{"flops", "hbm", "ici", "source", "wire"} for one torch device:
    the card's published peaks from `flops.py` when it knows the card
    ("table"), else the in-place calibration ("calibrated"). `shared`:
    the engine's cells share this card, so a collective byte is a copy
    inside HBM ("hbm_copy", half the HBM rate); otherwise it crosses
    NVLink ("nvlink", the data sheet's one-way rate)."""
    peak = _flops.device_peak_flops(device, dtype)
    if peak is None:
        return _calibrate()
    hbm = _flops.device_mem_bandwidth(device) or peak / 300.0
    wire = _flops.device_wire_bandwidth(device)
    if shared or wire is None:
        return {"flops": peak, "hbm": hbm, "ici": hbm / 2.0,
                "source": "table", "wire": "hbm_copy"}
    return {"flops": peak, "hbm": hbm, "ici": wire, "source": "table",
            "wire": "nvlink"}


# ---------------------------------------------------- roofline costing

# the matrix products and where their two matrix operands sit
_DOTS = {"mm": (0, 1), "matmul": (0, 1), "bmm": (0, 1),
         "addmm": (1, 2), "baddbmm": (1, 2)}
# ops that move no bytes: allocations and aliases the dispatcher does
# not flag as views
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "alias", "lift_fresh",
               "resize_", "set_"}
_KEYS = ("flops", "flops_fp8", "dot_bytes", "bytes")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class StepCounter(TorchDispatchMode):
    """The dispatch mode `roofline_of_step` runs a step under: per
    device, matmul FLOPs (and the fp8-operand subset), matmul operand +
    result bytes, and every other op's input + output bytes; the
    kernels' self-reports (`ops/_work.py`) under their names."""

    def __init__(self):
        super().__init__()
        self.per_device: dict[str, dict] = {}
        self.kernels: dict[str, dict] = {}
        self._quiet = 0

    def _acc(self, device) -> dict:
        return self.per_device.setdefault(str(device),
                                          dict.fromkeys(_KEYS, 0))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._quiet:
            return out
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_TRAFFIC:
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs or {}))
        outs = list(_tensors(out))
        if not ins and not outs:
            return out
        acc = self._acc((outs or ins)[0].device)
        moved = _work.nbytes(*ins, *outs)
        if name in _DOTS and outs:
            a, b = (args[i] for i in _DOTS[name])
            fl = 2 * outs[0].numel() * a.shape[-1]
            acc["flops"] += fl
            if a.dtype.is_floating_point and a.element_size() == 1 \
                    or b.dtype.is_floating_point and b.element_size() == 1:
                acc["flops_fp8"] += fl
            acc["dot_bytes"] += moved
        else:
            acc["bytes"] += moved
        return out

    def kernel(self, name, device, flops, nbytes, fp8_flops=0):
        """A hand-written kernel's self-report: its FLOPs and bytes
        count on `device`, the aten ops under its wrapper do not."""
        acc = self._acc(device)
        acc["flops"] += int(flops)
        acc["flops_fp8"] += int(fp8_flops)
        acc["dot_bytes"] += int(nbytes)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        return _Quiet(self)


class _Quiet:
    def __init__(self, counter: StepCounter):
        self.c = counter

    def __enter__(self):
        self.c._quiet += 1

    def __exit__(self, *exc):
        self.c._quiet -= 1


def roofline_of_step(fn, *args, cells: int | None = None, **kwargs):
    """Run `fn(*args, **kwargs)` — one real training step, forward,
    `backward()` and update — once under `StepCounter` and return
    (its result, the roofline inputs). It observes the step; nothing
    re-runs. The inputs carry the reference's keys: the busiest
    device's matmul FLOPs (`flops_shard`, fp8 subset `flops_fp8_shard`),
    matmul bytes (`dot_bytes_shard`) and other bytes (`bytes_shard`),
    each priced against ONE card (the `_global` keys are 0: every op
    here runs at a cell's own shapes on a real device). `per_device`
    keeps each device's counts and `kernels` the self-reports by
    wrapper. `approximate` is True when `cells` (the engine's grid
    size) exceeds the devices the step ran on: the cells share a card
    and the counts are the card's, not attributable per cell."""
    counter = StepCounter()
    prev = _work.active
    _work.active = counter
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        _work.active = prev
    per = counter.per_device
    busiest = max(per.values(), key=lambda a: (a["flops"], a["bytes"]),
                  default=dict.fromkeys(_KEYS, 0))
    roof = {f"{k}_shard": int(busiest[k]) for k in _KEYS}
    roof.update({f"{k}_global": 0 for k in _KEYS})
    roof["per_device"] = {d: dict(a) for d, a in per.items()}
    roof["kernels"] = counter.kernels
    roof["approximate"] = cells is not None and cells > max(len(per), 1)
    return out, roof


# --------------------------------------------------------- the waterfall


def roofline_seconds(roof: dict, rates: dict,
                     n_devices: int = 1) -> dict:
    """Roofline seconds per step: matmuls take the max of their
    compute and operand-byte times (a small matmul is memory-bound —
    its FLOPs alone would undercount it), everything else the HBM
    roofline. Aggregated per locality bucket (max of sums, a mild
    lower bound on the per-op sum of maxes)."""
    nd = max(1, int(n_devices))
    mxu = hbm = 0.0
    for key, div in (("shard", 1), ("global", nd)):
        fl = roof.get("flops_" + key, 0)
        fp8 = min(roof.get("flops_fp8_" + key, 0), fl)
        # fp8-operand dots run at FP8_FLOPS_RATIO x the base rate
        flop_s = ((fl - fp8) / rates["flops"]
                  + fp8 / (rates["flops"] * FP8_FLOPS_RATIO))
        mxu += max(flop_s,
                   roof.get("dot_bytes_" + key, 0) / rates["hbm"]) / div
        hbm += roof.get("bytes_" + key, 0) / rates["hbm"] / div
    return {"mxu_s": mxu, "hbm_s": hbm}


def step_waterfall(t_step: float, roofline: dict | None = None,
                   coll_bytes: int = 0,
                   exposed_frac: float | None = None,
                   bubble_fraction: float | None = None,
                   host_gap: float | None = None,
                   n_devices: int = 1, rates: dict | None = None,
                   dtype: str = "bf16",
                   compute_scale: float | None = None) -> dict:
    """Reconcile one measured (fenced) step time `t_step` (seconds)
    against the analytic components; returns the `attrib_*` step-line
    fields (telemetry schema v4).

    - `roofline`: `roofline_of_step` output for the step.
    - `coll_bytes`: per-device collective payload bytes per step
      (`collectives` convention); `exposed_frac` splits them into
      exposed (priced at the wire rate) vs hidden (free — overlapped
      under compute). None means no exposure info: all bytes count as
      exposed (conservative).
    - `bubble_fraction`: the pipeline's measured (or static) bubble.
    - `host_gap`: seconds of the window not inside any fenced step
      span, already divided down to PER-STEP terms by the caller.
    - `compute_scale`: the frozen self-calibration factor applied to
      the compute component on rate-calibrated hosts (RunTelemetry
      derives it at the first window; None = absolute rates, the card's
      table).

    `attrib_unexplained_frac = max(0, 1 - sum(components))` — when the
    components sum past 1 (the byte model is an unfused upper bound)
    unexplained clamps to 0, the safe direction for an alarm.
    """
    assert t_step > 0.0, t_step
    if rates is None:
        rates = device_rates(dtype=dtype)
    out = {"attrib_t_step_ms": round(t_step * 1e3, 3),
           "attrib_rates_source": rates.get("source", "table")}
    explained = 0.0
    if roofline is not None:
        secs = roofline_seconds(roofline, rates, n_devices)
        scale = 1.0 if compute_scale is None else float(compute_scale)
        comp = scale * (secs["mxu_s"] + secs["hbm_s"]) / t_step
        out["attrib_compute_frac"] = round(comp, 4)
        out["attrib_mxu_frac"] = round(scale * secs["mxu_s"] / t_step,
                                       4)
        if compute_scale is not None:
            out["attrib_compute_scale"] = round(scale, 4)
        explained += comp
    if coll_bytes:
        frac = 1.0 if exposed_frac is None else float(exposed_frac)
        wire = coll_bytes * frac / rates["ici"] / t_step
        out["attrib_comm_exposed_frac"] = round(wire, 4)
        explained += wire
    if bubble_fraction is not None:
        out["attrib_bubble_frac"] = round(float(bubble_fraction), 4)
        explained += float(bubble_fraction)
    if host_gap is not None:
        hf = max(0.0, float(host_gap)) / t_step
        out["attrib_host_frac"] = round(hf, 4)
        explained += hf
    out["attrib_unexplained_frac"] = round(max(0.0, 1.0 - explained), 4)
    return out


def window_step_spans(events, names=("step", "batch")) -> list[float]:
    """Fenced step-span durations (seconds) in a tracer event window:
    top-level "X" spans named `step` (the compiled engines) or `batch`
    (the pipeline VM). Nested phase spans (grads/update/per-op) are
    excluded by name."""
    return [e["dur"] / 1e6 for e in events
            if e.get("ph") == "X" and e.get("name") in names
            and e.get("dur")]
