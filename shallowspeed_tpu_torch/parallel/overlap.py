"""Comm/compute overlap: the bucketed in-backward gradient reduction —
counterpart of `shallowspeed_tpu/parallel/overlap.py`.

The source paper's signature move is DDP's: a hook per parameter fires
the reduction of a gradient the moment it is final, so the reduction of
layer i runs while the backward of layer i - 1 does (`pipe.py:302-327`
of the source). The reference compiles it: size-targeted buckets over
the gradient leaves in backward-finalization order, each reduced inside
the backward by a custom-VJP tag (or, for the hand-written MLP
backward, between layer VJPs). One process drives every cell of a grid
here, and a collective is a rank-order sum (`engine.reduce_replicas`,
`parallel.context`), so the same idea becomes:

- **Bucket plans** (`plan_buckets`, `plan_param_buckets`,
  `mlp_leaf_order`): the reference's, leaf for leaf. A bucket closes
  when the next leaf would take it past `OverlapConfig.bucket_bytes`;
  a leaf larger than the target gets a bucket of its own; every leaf
  lands in exactly one bucket. A parameter tree's plan follows the
  reversed JAX flatten order (`weights.sorted_leaves`: the deepest
  leaves' gradients are final first), and `leaf_plan` renames it into
  this package's `weights.leaves` order.
- **Partial sums issued from the backward** (`BucketReducer`). Replica
  r >= 1's gradient of bucket b is added into the running rank-order
  sum as soon as every leaf of b has its gradient for r's last
  microbatch: from an autograd hook over the bucket's leaves
  (`torch.autograd.graph.register_multi_grad_hook`, "all" mode), or,
  in a hand-written backward, as the layer loop emits each leaf
  (`emit`). With gradient accumulation the hook first folds the earlier
  microbatches' f32 sum into the last microbatch's gradient (the
  reference's peeled `acc`). On a CUDA device the adds run on a side
  stream that waits on the main stream at the hook, while the main
  stream runs the rest of r's backward; on the CPU the hooks run the
  same adds in hook order. Replica 0's partial is the accumulator: it
  has nothing to add into, so its backward overlaps nothing.
- **The sums and their order do not change.** Per leaf the result is
  the microbatches' sum in order, then that added into the accumulator
  in rank order, then the engine's 1 / n scale: exactly what the bulk
  reduction computes, so overlap on equals overlap off bit for bit on
  the CPU. Buckets may close in any order; each leaf's sum is its own.
- **Stream safety.** Every gradient the side stream reads is
  `record_stream`-ed (and so is an earlier microbatches' sum it folds
  into), so that the caching allocator cannot hand its memory to the
  main stream under the add; `join` makes the main stream wait for the
  side stream, and every engine calls it before the optimizer step, the
  health pack or any copy of the reduced gradient. A leaf the loss does
  not reach (`pos_emb` under RoPE, norm biases under RMSNorm) fires no
  hook: it counts as a zero gradient, and `finish` issues a bucket no
  hook fired with zeros. Nothing falls back quietly: a side stream that
  cannot be made, or a hook that fails, raises.

The reference's dataflow analysis stays there with `analysis/` (ROADMAP
Queue 1 item 6): `collective_exposure` walks a jaxpr,
`register_program` / `registered` feed the jaxpr lint, and telemetry's
`exposed_comm_frac` belongs to the planes. The engines keep the
reference's `_bucket_sigs` (`bucket_signature` of each bucket).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch.autograd.graph import register_multi_grad_hook

from shallowspeed_tpu_torch.weights import leaves, sorted_leaves, unflatten

MiB = float(1 << 20)


# ------------------------------------------------------------ config


@dataclass(frozen=True)
class OverlapConfig:
    """Per-engine comm/compute interleaving knobs, the reference's.

    bucket_mb: target bucket payload (a bucket closes when adding the
    next leaf would exceed it; a single oversized leaf gets its own
    bucket). double_buffer_hops: the SPMD pipeline only — each stage hop
    is consumed one tick after it is sent (microbatch m sits at stage s
    at tick 2s + m), at the cost of pp - 1 extra warm-up and drain
    ticks."""

    bucket_mb: float = 4.0
    double_buffer_hops: bool = True

    @property
    def bucket_bytes(self) -> int:
        return max(1, int(self.bucket_mb * MiB))


def from_flags(overlap: str, bucket_mb: float) -> OverlapConfig | None:
    """Driver-flag adapter: `--overlap off|on` + `--bucket-mb`."""
    if overlap == "off":
        return None
    return OverlapConfig(bucket_mb=bucket_mb)


# ------------------------------------------------------- bucket plans


def _dtype_of(leaf):
    dtype = getattr(leaf, "dtype", np.float32)
    return dtype if isinstance(dtype, torch.dtype) else np.dtype(dtype)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def leaf_bytes(leaf) -> int:
    """Payload bytes of one array-ish leaf (tensors, numpy arrays,
    anything with a shape and a dtype)."""
    shape = tuple(getattr(leaf, "shape", ()))
    size = _dtype_of(leaf).itemsize
    return int(np.prod(shape, dtype=np.int64)) * size if shape else size


def plan_buckets(leaves_in_order, bucket_bytes: int) -> list[list[int]]:
    """Partition leaf indices into contiguous buckets of at most
    `bucket_bytes` each, in the order given (callers pass leaves in
    backward-finalization order). Every index lands in exactly one
    bucket; a leaf larger than the target gets a bucket of its own."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_b = 0
    for i, leaf in enumerate(leaves_in_order):
        b = leaf_bytes(leaf)
        if cur and cur_b + b > bucket_bytes:
            buckets.append(cur)
            cur, cur_b = [], 0
        cur.append(i)
        cur_b += b
    if cur:
        buckets.append(cur)
    return buckets


def plan_param_buckets(params, bucket_bytes: int):
    """Bucket plan of a parameter tree in backward-finalization order
    (the reversed JAX flatten order). Returns (plan, leaves): `plan`
    indexes `leaves`, the tree's leaves in that flatten order
    (`weights.sorted_leaves`), as the reference's plan indexes its
    flatten order."""
    flat = list(sorted_leaves(params))
    n = len(flat)
    rev = plan_buckets(flat[::-1], bucket_bytes)
    return [[n - 1 - j for j in bucket] for bucket in rev], flat


def leaf_plan(params, bucket_bytes: int) -> list[list[int]]:
    """`plan_param_buckets` of `params` with each index renamed into this
    package's `weights.leaves(params)` order."""
    plan, _ = plan_param_buckets(params, bucket_bytes)
    pos = list(sorted_leaves(unflatten(params,
                                       range(len(list(leaves(params)))))))
    return [[pos[j] for j in bucket] for bucket in plan]


def mlp_leaf_order(params) -> list:
    """The MLP family's leaves in backward-finalization order (layer
    n - 1 first, W before b within a layer), with leaf id 2 i / 2 i + 1:
    the order `plan_buckets` should see and the ids `models.mlp.MLPStage.
    backward` emits."""
    order = []
    for i in range(len(params) - 1, -1, -1):
        order.append((2 * i, params[i]["W"]))
        order.append((2 * i + 1, params[i]["b"]))
    return order


def plan_ids(order, bucket_bytes: int) -> list[list]:
    """The bucket plan of (leaf id, leaf) pairs in backward-finalization
    order, as lists of leaf ids."""
    raw = plan_buckets([leaf for _, leaf in order], bucket_bytes)
    return [[order[j][0] for j in bucket] for bucket in raw]


def bucket_signature(leaves_of_bucket) -> tuple:
    """Signature of one reduction: the sorted (shape, dtype name)
    multiset of its operands."""
    return tuple(sorted((tuple(getattr(x, "shape", ())),
                         _dtype_name(_dtype_of(x)))
                        for x in leaves_of_bucket))


# ----------------------------------------------------------- streams

_SIDE: dict = {}


def side_stream(device):
    """The side CUDA stream of `device` (one a device, made at first
    use), or None for a device that is not a GPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stream = _SIDE.get(index)
    if stream is None:
        stream = _SIDE[index] = torch.cuda.Stream(device=index)
    return stream


def join(device, into=None) -> None:
    """Make the current stream of `into` (default: `device`) wait for
    everything issued on `device`'s side stream so far (nothing to wait
    for on the CPU)."""
    stream = side_stream(device)
    if stream is not None:
        into = stream.device if into is None else torch.device(into)
        torch.cuda.current_stream(into).wait_stream(stream)


# ------------------------------------------------------- the reducer


class BucketReducer:
    """One replica's bucketed reduction for one backward (its last
    microbatch's).

    `plan` lists buckets of leaf keys; `add(key, grad)` adds one leaf's
    final gradient into the rank-order sum (an engine's all-reduce or
    reduce-scatter of that leaf); `earlier` ({key: tensor} or a list),
    when given, holds the replica's f32 sums of its earlier microbatches,
    into which each gradient is folded in place before the add, as the
    bulk path accumulates. On a CUDA `device` every bucket is issued on
    its side stream (`side_stream`), after that stream waits on the
    current one; `BucketReducer.side_buckets` counts the buckets so
    issued. Autograd engines `arm` the reducer before the backward; a
    hand-written backward calls `emit` per leaf. `finish` after the
    backward issues what is left; the engine then calls `join` before it
    reads the sums."""

    side_buckets = 0

    def __init__(self, plan, add, device, earlier=None):
        self.plan = [list(bucket) for bucket in plan]
        self._add = add
        self._earlier = earlier
        self._stream = side_stream(device)
        self._done = [False] * len(self.plan)
        self._bucket_of = {k: bi for bi, bucket in enumerate(self.plan)
                           for k in bucket}
        self._pending: dict = {}
        self._tensors = None
        self._handles: list = []

    def arm(self, tensors: dict) -> None:
        """Hook the autograd leaves `tensors` ({key: leaf}): each bucket
        is issued once every leaf of it that the backward reaches has its
        gradient, a leaf it does not reach counting as zeros. Keys of the
        plan that `tensors` lacks are dropped. Run the backward with
        `torch.autograd.backward(loss, inputs=...)`: the hooks need the
        leaves' accumulation nodes, which `torch.autograd.grad` skips."""
        self._tensors = tensors
        self.plan = [[k for k in bucket if k in tensors]
                     for bucket in self.plan]
        for bi, keys in enumerate(self.plan):
            if keys:
                self._handles.append(register_multi_grad_hook(
                    [tensors[k] for k in keys], partial(self._fired, bi),
                    mode="all"))

    def _fired(self, bi: int, grads) -> None:
        self._issue(bi, [torch.zeros_like(self._tensors[k]) if g is None
                         else g for k, g in zip(self.plan[bi], grads)])

    def emit(self, key, grad) -> None:
        """A hand-written backward's final gradient of leaf `key` (for
        this microbatch): its bucket is issued once all of it has
        come."""
        bi = self._bucket_of[key]
        self._pending[key] = grad
        keys = self.plan[bi]
        if all(k in self._pending for k in keys):
            self._issue(bi, [self._pending.pop(k) for k in keys])

    def _issue(self, bi: int, grads) -> None:
        if self._done[bi]:
            raise RuntimeError(f"bucket {bi} was issued twice")
        self._done[bi] = True
        keys = self.plan[bi]
        stream = self._stream
        if stream is None:
            self._reduce(keys, grads)
            return
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            for k, g in zip(keys, grads):
                g.record_stream(stream)
                if self._earlier is not None:
                    self._earlier[k].record_stream(stream)
            self._reduce(keys, grads)
        BucketReducer.side_buckets += 1

    def _reduce(self, keys, grads) -> None:
        for k, g in zip(keys, grads):
            self._add(k, g.float() if self._earlier is None
                      else self._earlier[k].add_(g))

    def close(self) -> None:
        """Remove the hooks and clear the hooked leaves' `.grad` (also
        after a backward that raised)."""
        for h in self._handles:
            h.remove()
        self._handles = []
        if self._tensors is not None:
            for t in self._tensors.values():
                t.grad = None

    def finish(self) -> None:
        """After the backward: issue every bucket no hook fired (leaves
        the loss does not reach: zeros), then `close`; with `emit`, every
        leaf must have come."""
        for bi, keys in enumerate(self.plan):
            if self._done[bi]:
                continue
            if self._tensors is None:
                raise RuntimeError(f"bucket {bi} ({keys}) never closed: "
                                   f"the backward emitted "
                                   f"{sorted(self._pending)} of it")
            self._issue(bi, [torch.zeros_like(self._tensors[k])
                             for k in keys])
        self.close()

    def backward(self, loss, tensors: dict) -> None:
        """`arm` on `tensors`, the backward of `loss` into them, `finish`;
        the hooks removed whatever happens."""
        self.arm(tensors)
        try:
            torch.autograd.backward(loss, inputs=list(tensors.values()))
            self.finish()
        finally:
            self.close()
