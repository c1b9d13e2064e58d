"""Bench-trajectory regression gate.

A copy of `shallowspeed_tpu/telemetry/regress.py` (pure Python; the
port keeps its own copy rather than import the JAX package).

`BENCH_r*.json` is machine-written every round but was never
machine-read — a slow drift in throughput or MFU would only be caught
by a human rereading the trajectory. `python -m
shallowspeed_tpu_torch.telemetry --regress BENCH_*.json` (wired into
pre-commit) reads the whole trajectory and FAILS when the newest
round's headline metrics drop below the prior rounds by more than a
noise band.

Noise bands: bench.py (round 8) records per-side spread diagnostics —
`(max-min)/median` over its interleaved measurement rounds — in every
BENCH line from r06 on. The gate derives each metric's band as
`max(floor, K_SPREAD * max recorded spread)` so a noisy host widens
its own tolerance instead of crying wolf; the floors come from this
host's measured behavior (BASELINE.md documents ±7% wall-clock swings
under load for CPU-side numbers; the bench done-bar is ±2% on MFU, so
MFU gets a tight floor). Rounds r01–r05 predate the spread fields and
are covered by the floors alone.

Comparison: the LAST round's value vs the MEDIAN of all prior rounds
that carry the metric (median, not max — one lucky round must not
ratchet the bar above the machine's honest rate). Metrics where
higher is better throughout.
"""

from __future__ import annotations

import json
from pathlib import Path

K_SPREAD = 3.0  # band = max(floor, K_SPREAD * max recorded spread)

# metric -> (floor band, key into parsed["spread"] when recorded)
METRICS = {
    "value": (0.15, "tpu"),            # raw samples/sec: host-load prone
    "vs_baseline": (0.12, "tpu"),      # ratio, but both sides CPU-noisy
    "transformer_mfu": (0.05, None),   # fused on-chip: the ±2% done-bar
    "big_model_mfu": (0.05, None),
    # serving decode throughput (round 11, bench.py offered-load
    # sweep): per-tick dispatch on a CPU host — wall-clock-noisy like
    # `value`, plus scheduler overhead, so a wide floor; rounds before
    # r07 lack the metric and pass vacuously
    "serving_tok_per_sec": (0.35, None),
    # spec-on serving headline (round 14, the spec-on/off sweep):
    # same dispatch noise as the spec-off number, same wide floor;
    # additionally sensitive to the n-gram proposer's acceptance on
    # the bench's templated prompts — a drop here means speculation
    # stopped paying, which is exactly what the gate should catch
    "serving_spec_tok_per_sec": (0.35, None),
    # fleet router headline (round 15, bench.py's 2-replica in-process
    # sweep): the serving dispatch noise PLUS the router's host-side
    # polling/scoring — a drop here with serving_tok_per_sec flat
    # means routing overhead grew; rounds before r15 pass vacuously
    "fleet_tok_per_sec": (0.35, None),
    # fp8 attribution gate (round 18, bench.py bench_fp8): ratio of
    # the bf16 baseline's attrib_mxu_frac to the fp8-on case's — the
    # quantized-dot pricing must keep it > 1. Mostly deterministic
    # (jaxpr-derived rooflines; the calibrated flops/hbm rate ratio
    # moves it a little per host), so a tight floor; rounds before
    # r18 lack the metric and pass vacuously
    "fp8_mxu_shrink": (0.10, None),
    # prefix-caching fleet headline (round 19, bench.py bench_prefix:
    # the 2-replica sticky-routing shared-prompt sweep, prefix cache
    # on): the same dispatch noise as fleet_tok_per_sec plus the
    # cache-hit admission path — a drop here with fleet_tok_per_sec
    # flat means prefix caching or sticky routing stopped paying;
    # rounds before r19 lack the metric and pass vacuously
    "prefix_tok_per_sec": (0.35, None),
    # serving capacity (round 20, the memory observatory): generated
    # tokens per peak live KV block over bench's serving sweep — how
    # much decode work each resident block bought. A drop with
    # serving_tok_per_sec flat means residency grew (blocks pinned
    # longer, eviction stopped paying, or admission overcommitting);
    # same dispatch noise as the throughput numbers, so the same wide
    # floor. Rounds before r20 lack the metric and pass vacuously.
    "serving_capacity_tok_per_blk": (0.35, None),
}


def load_trajectory(paths) -> list[dict]:
    """Parsed bench entries sorted by round number `n`. Accepts file
    paths and directories (scanned for BENCH_*.json)."""
    files: list[Path] = []
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            files.extend(sorted(p.glob("BENCH_*.json")))
        else:
            files.append(p)
    entries = []
    for f in files:
        rec = json.loads(Path(f).read_text())
        parsed = rec.get("parsed")
        if not isinstance(parsed, dict):
            continue
        entries.append({"n": int(rec.get("n", 0)), "path": str(f),
                        "parsed": parsed})
    entries.sort(key=lambda e: e["n"])
    return entries


def _median(vals):
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _band(metric: str, entries) -> float:
    floor, spread_key = METRICS[metric]
    if spread_key is None:
        return floor
    spreads = []
    for e in entries:
        sp = e["parsed"].get("spread")
        if isinstance(sp, dict) and isinstance(sp.get(spread_key),
                                               (int, float)):
            spreads.append(float(sp[spread_key]))
    return max(floor, K_SPREAD * max(spreads)) if spreads else floor


def check_trajectory(entries) -> tuple[list[str], list[str]]:
    """(problems, report_lines) for one trajectory. Empty problems =
    the gate passes. Needs >= 2 entries carrying a metric to judge it;
    a trajectory of 0/1 entries passes vacuously."""
    problems: list[str] = []
    report: list[str] = []
    if len(entries) < 2:
        return problems, [f"{len(entries)} bench round(s) — nothing to "
                          f"compare"]
    last = entries[-1]
    prior = entries[:-1]
    for metric in METRICS:
        cur = last["parsed"].get(metric)
        hist = [e["parsed"][metric] for e in prior
                if isinstance(e["parsed"].get(metric), (int, float))]
        if not isinstance(cur, (int, float)) or not hist:
            continue
        ref = _median(hist)
        band = _band(metric, entries)
        drop = (ref - cur) / ref if ref > 0 else 0.0
        verdict = "OK" if drop <= band else "REGRESSION"
        report.append(
            f"{metric:<18} r{last['n']:02d}={cur:<12.4g} "
            f"median(prior {len(hist)})={ref:<12.4g} "
            f"drop={drop:+7.2%}  band={band:.0%}  {verdict}")
        if drop > band:
            problems.append(
                f"{metric}: r{last['n']:02d} value {cur:.6g} is "
                f"{drop:.1%} below the prior-round median {ref:.6g} "
                f"(noise band {band:.0%}) — {last['path']}")
    if not report:
        report.append("no shared metrics across rounds")
    return problems, report


def main(paths) -> int:
    entries = load_trajectory(paths)
    problems, report = check_trajectory(entries)
    print(f"bench trajectory: {len(entries)} round(s) "
          f"({', '.join('r%02d' % e['n'] for e in entries)})")
    for line in report:
        print("  " + line)
    for p in problems:
        print("REGRESSION: " + p)
    print("regress gate: " + ("FAIL" if problems else "OK"))
    return 1 if problems else 0
