"""The telemetry core on the card: the `spans` fence waits for the
device (the side stream's work too), the allocator's counters behind
the memory fields, the owners' bytes against `memory_allocated`, and the
`torch.profiler` capture's kernel events. Every test carries the `cuda`
marker and skips without a GPU. This file imports neither jax nor the
JAX package:
    pytest -q --noconftest -m cuda tests/test_torch_telemetry_cuda.py
"""

import json

import pytest
import torch

from shallowspeed_tpu_torch.telemetry import memory as M
from shallowspeed_tpu_torch.telemetry import profiler as P
from shallowspeed_tpu_torch.telemetry import trace as TR


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA synchronizes, the caching "
                    "allocator's counters and CUPTI have no CPU mode")
    yield torch.device("cuda")
    TR.configure()
    M.clear_owners()


def _busy(dev, n=4096, reps=8):
    """Enough device work to outlast a host call by far."""
    x = torch.randn(n, n, device=dev)
    for _ in range(reps):
        x = x @ x
        x = x / x.norm()
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("side", [False, True], ids=["main", "side-stream"])
def test_spans_fence_brackets_the_device_work(cuda, side, monkeypatch):
    """At `spans` the span's duration holds the device time of what was
    dispatched inside it, on the current stream or on another stream of
    the device; at `steps` the span synchronizes nothing."""
    _busy(cuda)                     # cuBLAS set up before the timed spans
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    stream = torch.cuda.Stream() if side else torch.cuda.current_stream()
    real, syncs = torch.cuda.synchronize, []

    def counted(device=None):
        syncs.append(device)
        real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    durs = {}
    for level in ("steps", "spans"):
        tr = TR.configure(level=level)
        del syncs[:]
        with tr.span("step") as sp:
            with torch.cuda.stream(stream):
                start.record(stream)
                x = _busy(cuda)
                end.record(stream)
            sp.fence(torch.zeros(1, device=cuda), [torch.zeros(2)])
        durs[level] = len(syncs)
        real()
        span_ms = tr.events[-1]["dur"] / 1e3
        del x
    assert durs == {"steps": 0, "spans": 1}
    assert span_ms >= start.elapsed_time(end) * 0.99


@pytest.mark.cuda
def test_allocator_counters_and_owner_bytes(cuda):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = {"w": torch.zeros(1024, 1024, device=cuda),
              "b": [torch.zeros(1024, device=cuda)]}
    scratch = torch.zeros(256, 1024, device=cuda)
    M.register_owner("train.params", lambda: params)
    M.register_owner("view", lambda: params["w"][:10])
    acct = M.per_owner_accounting()
    owned = (1024 * 1024 + 1024) * 4
    assert acct["owners"] == {"train.params": owned, "view": 0}
    alloc = torch.cuda.memory_allocated()
    assert acct["live_bytes"] == alloc
    assert acct["untracked_bytes"] == alloc - owned
    assert acct["untracked_bytes"] >= scratch.numel() * 4
    stats = M.device_memory_stats()[f"cuda:{torch.cuda.current_device()}"]
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated()
    assert stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    live = M.live_hbm_high_water()
    assert live["max_device_bytes"] == torch.cuda.memory_allocated()
    assert any(r["owner"] == "train.params" for r in M.top_live_arrays(4))


@pytest.mark.cuda
def test_device_trace_records_the_kernels(cuda, tmp_path):
    with P.device_trace_ctx(tmp_path):
        _busy(cuda, n=1024, reps=2)
    trace = json.loads(P.trace_file(tmp_path).read_text())
    kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
    assert kernels and all(e.get("dur", 0) >= 0 for e in kernels)
