"""Mergeable log-bucketed histogram sketches — streaming quantiles in

A copy of `shallowspeed_tpu/telemetry/sketch.py` (pure Python; the
port keeps its own copy rather than import the JAX package).
constant memory.

The offline reducers (`report.percentile`, `goodput.run_goodput`) sort
the full value list; a live endpoint cannot (a day of serving is
millions of ttft samples, and `/status.json` must answer *now*). A
`LogHistogram` keeps counts in geometrically spaced buckets
(DDSketch-style): bucket ``i`` covers ``(gamma^(i-1), gamma^i]`` with
``gamma = (1 + rel_err) / (1 - rel_err)``, and a bucket's
representative value ``2 * gamma^i / (gamma + 1)`` is within
``rel_err`` of every sample that landed in it. Counts are EXACT —
only the value axis is quantized — so:

- ``quantile(q)`` is the nearest-rank percentile (the SAME rank rule
  as `report.percentile`, so live and offline disagree only by the
  documented bucket error, never by rank convention) with relative
  error <= ``rel_err`` (clamped into the exact [min, max] envelope);
- ``merge`` is exact bucket-count addition: per-process sketches
  serialized into the metrics JSONL (schema-v7 ``"monitor"`` events)
  recombine across supervisor restarts and gang members into the
  whole-run distribution — the property a fleet aggregator needs;
- memory is O(log(max/min) / rel_err) buckets whatever the stream
  length (~700 buckets spans nanoseconds..days at 1% error).

Pure stdlib (math + dict) — no jax, no numpy — so the `--live` tailer
and the elastic supervisor can run it anywhere, at import cost zero.
"""

from __future__ import annotations

import math


class LogHistogram:
    """One metric's streaming distribution (module docstring)."""

    __slots__ = ("rel_err", "_log_gamma", "_gamma", "buckets", "n_zero",
                 "n", "vmin", "vmax", "total")

    def __init__(self, rel_err: float = 0.01):
        if not 0.0 < rel_err < 1.0:
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        self.rel_err = float(rel_err)
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self.buckets: dict[int, int] = {}
        self.n_zero = 0          # samples <= 0 (queue depth 0 is real)
        self.n = 0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.total = 0.0         # running sum -> mean

    # ------------------------------------------------------------ feed

    def add(self, x, count: int = 1) -> None:
        """Absorb `count` observations of value `x` (a window average
        fed with its window's step count weights correctly)."""
        x = float(x)
        count = int(count)
        if count <= 0 or not math.isfinite(x):
            return
        self.n += count
        self.total += x * count
        self.vmin = min(self.vmin, x)
        self.vmax = max(self.vmax, x)
        if x <= 0.0:
            self.n_zero += count
            return
        i = math.ceil(math.log(x) / self._log_gamma)
        self.buckets[i] = self.buckets.get(i, 0) + count

    # --------------------------------------------------------- queries

    def _bucket_value(self, i: int) -> float:
        # midpoint estimate: within rel_err of anything in the bucket
        return 2.0 * self._gamma ** i / (self._gamma + 1.0)

    def quantile(self, q: float) -> float | None:
        """Nearest-rank percentile, q in [0, 100] (None when empty).
        Same rank rule as `report.percentile`: rank = floor(q/100 *
        (n-1) + 0.5), so the live and offline reducers share one
        definition and differ only by the bucket's rel_err."""
        if self.n == 0:
            return None
        rank = min(self.n - 1,
                   max(0, math.floor(q / 100.0 * (self.n - 1) + 0.5)))
        if rank < self.n_zero:
            return min(0.0, self.vmin)
        seen = self.n_zero
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if rank < seen:
                v = self._bucket_value(i)
                return min(self.vmax, max(self.vmin, v))
        return self.vmax  # unreachable unless counts drifted

    def mean(self) -> float | None:
        return self.total / self.n if self.n else None

    def count_above(self, x: float) -> int:
        """Observations whose value exceeds `x`, at bucket resolution:
        a bucket counts by its representative value, so the answer is
        exact except for samples within `rel_err` of `x` — the bound
        the fleet SLO evaluator inherits when it scores a merged
        stream against a threshold without the raw values."""
        x = float(x)
        n = self.n_zero if x < 0.0 else 0
        for i, c in self.buckets.items():
            if self._bucket_value(i) > x:
                n += c
        return n

    def count_le(self, x: float) -> int:
        """Observations at or below `x`, at bucket resolution (the
        complement of `count_above`, zeros/negatives included) — the
        cumulative counter behind the native Prometheus histogram
        export. Exact except for samples within `rel_err` of `x`."""
        return self.n - self.count_above(x)

    def summary(self, qs=(50, 95, 99)) -> dict:
        """The /status.json block for this sketch."""
        out = {"count": self.n}
        if self.n:
            out["min"] = round(self.vmin, 6)
            out["max"] = round(self.vmax, 6)
            out["mean"] = round(self.mean(), 6)
            for q in qs:
                out[f"p{q}"] = round(self.quantile(q), 6)
        return out

    # ------------------------------------------------- merge/serialize

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Exact in-place union (same rel_err required — bucket indices
        are only comparable on one gamma grid)."""
        if abs(other.rel_err - self.rel_err) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different rel_err "
                f"({self.rel_err} vs {other.rel_err})")
        for i, c in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + c
        self.n_zero += other.n_zero
        self.n += other.n
        self.total += other.total
        if other.n:
            self.vmin = min(self.vmin, other.vmin)
            self.vmax = max(self.vmax, other.vmax)
        return self

    def to_dict(self) -> dict:
        """JSON-safe serialization (bucket keys become strings); the
        schema-v7 ``"monitor"`` event carries one of these per metric."""
        out = {"rel_err": self.rel_err, "n": self.n,
               "zero": self.n_zero,
               "buckets": {str(i): c for i, c in self.buckets.items()}}
        if self.n:
            out["min"] = self.vmin
            out["max"] = self.vmax
            out["sum"] = self.total
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        sk = cls(rel_err=float(d.get("rel_err", 0.01)))
        sk.buckets = {int(i): int(c)
                      for i, c in (d.get("buckets") or {}).items()}
        sk.n_zero = int(d.get("zero", 0))
        sk.n = int(d.get("n", 0))
        sk.total = float(d.get("sum", 0.0))
        if sk.n:
            sk.vmin = float(d.get("min", math.inf))
            sk.vmax = float(d.get("max", -math.inf))
        return sk


class MetricSketches:
    """A named family of LogHistograms sharing one rel_err — the
    monitor's whole streaming state, one `observe` call per sample."""

    def __init__(self, rel_err: float = 0.01):
        self.rel_err = float(rel_err)
        self.sketches: dict[str, LogHistogram] = {}

    def observe(self, name: str, value, count: int = 1) -> None:
        sk = self.sketches.get(name)
        if sk is None:
            sk = self.sketches[name] = LogHistogram(self.rel_err)
        sk.add(value, count)

    def quantile(self, name: str, q: float) -> float | None:
        sk = self.sketches.get(name)
        return sk.quantile(q) if sk is not None else None

    def summary(self, qs=(50, 95, 99)) -> dict:
        return {name: sk.summary(qs)
                for name, sk in sorted(self.sketches.items()) if sk.n}

    def to_dict(self) -> dict:
        return {name: sk.to_dict()
                for name, sk in sorted(self.sketches.items()) if sk.n}

    def merge_dict(self, snap: dict) -> "MetricSketches":
        """Fold one serialized sketch family (a ``"monitor"`` event's
        ``sketches`` payload) into this one — the cross-process /
        cross-stanza aggregation path."""
        for name, d in (snap or {}).items():
            sk = LogHistogram.from_dict(d)
            if name in self.sketches:
                self.sketches[name].merge(sk)
            else:
                self.sketches[name] = sk
        return self
