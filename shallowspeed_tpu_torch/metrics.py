"""Structured JSONL metrics — the part of
`shallowspeed_tpu/metrics.py::MetricsLogger` the serving driver uses.
The live monitor feed and file-rotation handling are not ported yet."""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    """Append-only JSONL writer, flushed per line; a no-op when `path`
    is falsy. Every line carries `t` (seconds since start), `wall` and
    `mono` stamps like the reference's."""

    def __init__(self, path=None, **run_info):
        self.path = Path(path) if path else None
        self._t0 = time.time()
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
            self.log(event="run_start", **run_info)

    def log(self, **fields) -> None:
        if self._fh is None:
            return
        now = time.time()
        fields.setdefault("t", round(now - self._t0, 3))
        fields.setdefault("wall", round(now, 3))
        fields.setdefault("mono", round(time.monotonic(), 6))
        self._fh.write(json.dumps(fields) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
