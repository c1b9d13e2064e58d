"""Collective traffic accounting — bytes and calls per grid axis,
counted at run time.

The reference (`shallowspeed_tpu/telemetry/collectives.py`) walks the
jaxpr of a compiled step and totals what each collective hands the
fabric. The port has no jaxpr: its engines move data between the cells
of their grids in Python, so each of those moves counts itself here,
on the axis it crosses, as it runs — the replicas' rank-order sums,
`gspmd.shard` / `gather`, Megatron's `copy_to_cells` /
`reduce_from_cells`, ZeRO's reduce-scatter and all-gather, the
pipeline's hops, the sp substrates' ring and all-to-all steps and
`distributed.move` / `share` / `exchange`.

Byte convention, the reference's: the LOCAL operand bytes entering the
collective — one cell's payload: a replica's f32 gradient partial for
the dp sum (or ZeRO-2's reduce-scatter), one cell's slices for ZeRO's
all-gather, one FSDP piece for a leaf's gather, the tensor a pipeline
hop carries, one cell's K and V blocks for a ring hop — with no
algorithm factor. A collective counts once per call, however many
cells take part. The backward's collectives (the transpose of a ring
hop, of an all-gather, of Megatron's f and g) count where autograd
runs them (`tap`).

Unlike the static walk, the count is of what ran in the step: a hop
inside a loop counts once per execution, a branch that did not run
counts nothing, so `approximate` is always False. The port runs each
data replica's model-axis collectives (its ring, its tp reductions) as
calls of their own, so those count once per replica, where the
reference's one SPMD program counts them once for every replica.
Engines read their step's traffic with `mark()` before and
`since(mark)` after (`telemetry_traffic()`); counting costs one dict
update per collective and no device sync.
"""

from __future__ import annotations

import threading

import torch

from shallowspeed_tpu_torch.weights import leaves

_LOCK = threading.Lock()
# axis -> [bytes, calls], cumulative over the process
_COUNTS: dict[str, list] = {}


def count(axis: str, nbytes: int, calls: int = 1) -> None:
    """Book one collective (or `calls` of them) moving `nbytes` local
    operand bytes over `axis` in total."""
    with _LOCK:
        slot = _COUNTS.setdefault(axis, [0, 0])
        slot[0] += int(nbytes)
        slot[1] += int(calls)


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree of dicts, lists and tuples."""
    return sum(int(x.numel()) * x.element_size() for x in leaves(tree)
               if isinstance(x, torch.Tensor))


def count_tensors(axis: str, tree, calls: int = 1) -> None:
    """`count` with the bytes of a tree of tensors."""
    count(axis, tensor_bytes(tree), calls)


def mark() -> dict:
    """A snapshot of the cumulative counters, for `since`."""
    with _LOCK:
        return {k: tuple(v) for k, v in _COUNTS.items()}


def since(before: dict) -> dict:
    """The traffic counted after `before` (from `mark`), in the
    reference's shape: {"per_axis": {axis: {"bytes", "calls"}},
    "total_bytes", "approximate"}."""
    now = mark()
    per_axis = {}
    for axis in sorted(now):
        b0, c0 = before.get(axis, (0, 0))
        b, c = now[axis][0] - b0, now[axis][1] - c0
        if c:
            per_axis[axis] = {"bytes": b, "calls": c}
    return {"per_axis": per_axis,
            "total_bytes": sum(v["bytes"] for v in per_axis.values()),
            "approximate": False}


def empty() -> dict:
    """No traffic (an engine before its first step)."""
    return {"per_axis": {}, "total_bytes": 0, "approximate": False}


class _Tap(torch.autograd.Function):
    """Identity that counts its gradient's bytes in the backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        count_tensors(ctx.axis, g)
        return g, None


def tap(x, axis: str, forward: bool = True):
    """`x` itself (a view) with its bytes counted as one collective on
    `axis` in the forward (unless `forward` is False), and its
    gradient's bytes as one in the backward where autograd reaches it:
    the operand of a collective and of its transpose."""
    if forward:
        count_tensors(axis, x)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _Tap.apply(x, axis)
