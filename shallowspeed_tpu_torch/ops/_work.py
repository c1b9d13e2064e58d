"""The hand-written kernels' work self-reports.

The kernels launch through ctypes (`_build.launch`), where torch's
dispatch never sees them, so a dispatch-mode counter
(`telemetry.attribution.roofline_of_step`) would count their FLOPs and
bytes as zero. Each wrapper in `flash_attention.py` and `matmul.py`
therefore reports its own work to the counter of the running step,
`active`, through the `reports` decorator: the FLOPs of its products
and the bytes its call must move (each input read once, each output
written once), the counts their bounds in PERF.md's kernel table use.
While a wrapper runs, the counter ignores the aten ops under it (the
plain version on a CPU tensor, the output allocations on a CUDA one),
so the count is the same on the CPU and on the card. With no counter
active a call costs one global read.
"""

from __future__ import annotations

import functools

# the counter of the step being counted (`attribution.StepCounter`), or
# None
active = None


def reports(work):
    """Decorate a kernel wrapper: with a counter active, `work(*args,
    **kwargs)` -> (device, flops, bytes, fp8 flops) is reported under
    the wrapper's name and the aten ops inside are not counted."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            c = active
            if c is None:
                return fn(*args, **kwargs)
            with c.kernel(fn.__name__, *work(*args, **kwargs)):
                return fn(*args, **kwargs)
        return inner
    return wrap


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
