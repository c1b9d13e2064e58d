"""Request-latency summary — copy of
`shallowspeed_tpu/telemetry/report.py::percentile` and
`request_summary`, so both drivers reduce their records alike."""

from __future__ import annotations

import math


def percentile(vals, q: float) -> float | None:
    """Nearest-rank percentile, rank = floor(q/100 * (n-1) + 0.5)
    (round half up); None on empty input."""
    vals = sorted(float(v) for v in vals)
    if not vals:
        return None
    k = min(len(vals) - 1,
            max(0, math.floor(q / 100.0 * (len(vals) - 1) + 0.5)))
    return vals[k]


def request_summary(recs) -> dict | None:
    """p50/p95 time-to-first-token and time-per-output-token, tokens
    moved and preemptions over the engine's request records; None when
    there are none."""
    recs = [r for r in recs if isinstance(r, dict) and "ttft_ms" in r]
    if not recs:
        return None
    ttft = [r["ttft_ms"] for r in recs
            if isinstance(r.get("ttft_ms"), (int, float))]
    tpot = [r["tpot_ms"] for r in recs
            if isinstance(r.get("tpot_ms"), (int, float))]

    def rnd(v):
        return None if v is None else round(v, 3)

    return {
        "n_requests": len(recs),
        "ttft_ms_p50": rnd(percentile(ttft, 50)),
        "ttft_ms_p95": rnd(percentile(ttft, 95)),
        "tpot_ms_p50": rnd(percentile(tpot, 50)),
        "tpot_ms_p95": rnd(percentile(tpot, 95)),
        "tokens_in": sum(int(r.get("tokens_in", 0)) for r in recs),
        "tokens_out": sum(int(r.get("tokens_out", 0)) for r in recs),
        "preempted": sum(int(r.get("preempted", 0)) for r in recs),
    }
