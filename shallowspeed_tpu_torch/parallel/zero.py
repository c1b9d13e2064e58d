"""ZeRO-1 / ZeRO-2 over the dp axis of one controller's grid —
counterpart of `shallowspeed_tpu/parallel/zero.py`.

The reference places each optimizer-state leaf dp-sharded (on its first
divisible dimension) and lets GSPMD partition the update where the
moments live; ZeRO-2 also emits the gradients dp-sharded, through a
reduce-scatter. One process drives every cell here, so the sharding is
explicit:

- `zero2_grad_dim`, the one placement rule: a leaf's first dimension
  that dp divides (None: the leaf stays whole on every cell), and with
  a spec (the tensor- and expert-parallel engines' leaves,
  `parallel.gspmd`) the first such dimension the spec leaves free;
- `shard_state_zero1`: cell c keeps slice c of every state leaf, on its
  device (step counters and undivisible leaves whole on every cell);
- `reduce_scatter`: each replica's gradient partial, as it comes, added
  into every cell's slice in rank order — the order of the dense
  engine's all-reduce, so a slice equals the dense sum's slice bit for
  bit (`scatter_add` one leaf of it, as an overlapped backward's hook
  issues it);
- `ZeroUpdate`: the sharded update with the health modes of
  `make_zero1_update`. The gradient's clipping norm and health pack are
  the whole tree's, each leaf's slices summed in rank order. An
  `elementwise` optimizer (SGD, momentum, Adam, AdamW) then updates
  each cell's slices of the parameters and state on that cell, and an
  all-gather copies every cell's new parameter slices into the other
  replicas. Adafactor is not elementwise (factored row and column
  statistics, RMS clipping and scaling over whole leaves): its small
  factored state and the gradient are gathered, the replica-0
  parameters take the unsharded update, and its state is cut back into
  slices. Either way ZeRO changes where state lives, never the update's
  arithmetic, as GSPMD makes the reference's update the unsharded one;
- `replace_opt_state`: a canonical state (a checkpoint's) cut into the
  engine's slices, and `gather_state` its inverse.
"""

from __future__ import annotations

import torch

from shallowspeed_tpu_torch.telemetry.health import (grad_health,
                                                     leaf_squares, snapshot,
                                                     update_health)
from shallowspeed_tpu_torch.weights import leaves, map_tree, unflatten


def zero2_grad_dim(shape, size: int, spec=None, axis: str = "dp"):
    """The dimension the `axis` axis (of `size` cells) lands on for a
    leaf of `shape` placed by `spec` (per dimension an axis name or
    None; None: unplaced): its first non-empty dimension that the spec
    leaves unsharded and `size` divides, or None if none qualifies or
    the spec already uses `axis` (the leaf stays as placed). THE one
    placement rule of gradients, moments and parameter slices, so they
    can never disagree — the reference's `zero2_grad_dim(spec, shape,
    size, axis)`."""
    entries = tuple(spec or ())
    if axis in entries:
        return None
    entries += (None,) * (len(shape) - len(entries))
    for i, dim in enumerate(shape):
        if entries[i] is None and dim and dim % size == 0:
            return i
    return None


def _dim_of(x, size: int):
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return None
    return zero2_grad_dim(x.shape, size)


def cut(x, size: int, cell: int, dim):
    """Cell `cell`'s piece of a leaf: its slice along `dim`, or the whole
    leaf when `dim` is None (a view either way)."""
    return x if dim is None else x.chunk(size, dim=dim)[cell]


def _owned(x, device):
    """A contiguous copy of `x` on `device` that owns its memory."""
    return x.to(device, copy=True, memory_format=torch.contiguous_format)


def shard_state_zero1(state, cells) -> list:
    """The per-cell optimizer states of a canonical `state` over the
    dp `cells` (their devices, in rank order): cell c's tree holds slice
    c of every tensor leaf along `zero2_grad_dim` as its own tensor on
    its device; 0-d and undivisible leaves are whole copies and step
    counters plain values on every cell."""
    dp = len(cells)

    def piece(c):
        def leaf(x):
            if not isinstance(x, torch.Tensor):
                return x
            return _owned(cut(x, dp, c, _dim_of(x, dp)), cells[c])

        return map_tree(leaf, state)

    return [piece(c) for c in range(dp)]


def state_dims(state, size: int):
    """`zero2_grad_dim` of every leaf of a canonical state (None for step
    counters, 0-d and undivisible leaves), in the state's structure."""
    return map_tree(lambda x: _dim_of(x, size), state)


def gather_state(shards, dims, device):
    """The canonical state of per-cell `shards` (cut by `state_dims`
    `dims`) on `device`: every sliced leaf's slices concatenated in rank
    order, the others cell 0's."""
    def leaf(d, *parts):
        if not isinstance(parts[0], torch.Tensor):
            return parts[0]
        if d is None:
            return parts[0].to(device, copy=True)
        return torch.cat([p.to(device) for p in parts], dim=d)

    return map_tree(leaf, dims, *shards)


def replace_opt_state(shards, state) -> None:
    """Install a canonical `state` (tensors or numpy arrays, a
    checkpoint's or another layout's) into the engine's per-cell
    `shards` in place: each cell's slice copied from the state's, step
    counters replaced."""
    dp = len(shards)
    for c, shard in enumerate(shards):
        def leaf(mine, x):
            if not isinstance(mine, torch.Tensor):
                return int(x) if isinstance(mine, int) else x
            src = torch.as_tensor(x)
            piece = cut(src, dp, c, _dim_of(src, dp))
            mine.copy_(piece.to(mine.device))
            return mine

        shards[c] = map_tree(leaf, shard, state)


class Slices:
    """One gradient leaf of a ZeRO-2 step held as its slices, in rank
    order (the health pack and the clipping norm read `parts`)."""

    def __init__(self, parts):
        self.parts = tuple(parts)


def reduce_scatter(acc, partial_leaves, dims, cells) -> list:
    """Add one replica's gradient partial (a list of leaves in `leaves()`
    order) into the per-cell slice lists `acc` (None for the first
    replica, which starts them), in rank order: cell c's slice of leaf i
    along dims[i], or the whole leaf on every cell where dims[i] is
    None. Returns `acc`."""
    dp = len(cells)
    if acc is None:
        return [[_owned(cut(g, dp, c, d), cells[c])
                 for g, d in zip(partial_leaves, dims)] for c in range(dp)]
    for i, (g, d) in enumerate(zip(partial_leaves, dims)):
        scatter_add(acc, i, g, d, cells)
    return acc


def scatter_add(acc, i: int, g, dim, cells) -> None:
    """Add one replica's gradient `g` of leaf i into every cell's slice
    of it in `acc` (`reduce_scatter`'s per-leaf step; the overlapped
    reduction issues it from a backward hook)."""
    dp = len(cells)
    for c in range(dp):
        acc[c][i].add_(cut(g, dp, c, dim).to(cells[c]))


class ZeroUpdate:
    """The sharded optimizer step of a ZeRO-1/2 engine over the dp cells
    `cells`: holds the per-cell optimizer state (`shards`) of the
    canonical `state` and updates the replicas' parameters (trees in one
    layout, replica r on cell r) from per-cell gradient pieces.
    `health` as the engines take it."""

    def __init__(self, optimizer, params, state, cells, health: str = "off"):
        self.optimizer = optimizer
        self.cells = list(cells)
        self.dp = len(self.cells)
        self.health = health
        self.dims = [_dim_of(p, self.dp) for p in leaves(params)]
        self.state_dims = state_dims(state, self.dp)
        self.shards = shard_state_zero1(state, self.cells)

    def state(self, device):
        """The canonical (unsharded) optimizer state, gathered onto
        `device`."""
        return gather_state(self.shards, self.state_dims, device)

    def pieces(self, tree, cell: int) -> list:
        """Cell `cell`'s pieces (views) of a params-shaped tree's leaves."""
        return [cut(x, self.dp, cell, d)
                for x, d in zip(leaves(tree), self.dims)]

    def whole(self, per_cell) -> list:
        """Each gradient leaf once: its `Slices` over the cells where it
        is sliced, cell 0's copy where it is whole."""
        return [Slices(p[i] for p in per_cell) if d is not None
                else per_cell[0][i] for i, d in enumerate(self.dims)]

    def gather_grads(self, per_cell, template):
        """The gradient tree, gathered whole onto cell 0."""
        dev = self.cells[0]
        return unflatten(template, [
            torch.cat([p[i].to(dev) for p in per_cell], dim=d)
            if d is not None else per_cell[0][i]
            for i, d in enumerate(self.dims)])

    def _clip(self, per_cell):
        """Global-norm clipping over the whole gradient, each sliced
        leaf's slices summed in rank order; scales every cell's pieces
        in place."""
        clip = self.optimizer.grad_clip
        if clip is None:
            return
        norm = torch.sqrt(torch.sum(leaf_squares(self.whole(per_cell))))
        scale = torch.clamp(clip / (norm + 1e-12), max=1.0)
        for p in per_cell:
            for g in p:
                g.mul_(scale.to(g.device, g.dtype))

    @torch.no_grad()
    def __call__(self, replicas: list, per_cell: list):
        """One step: `replicas` the dp parameter trees, `per_cell` each
        cell's gradient pieces (lists in `leaves()` order: slices where
        the leaf is sliced, the whole leaf otherwise). Returns the health
        pack (None with health "off")."""
        opt, dp = self.optimizer, self.dp
        pack = None
        if self.health != "off":
            pack = grad_health(replicas[0], unflatten(
                replicas[0], self.whole(per_cell)))
            old = snapshot(replicas[0])
        ok = pack["nonfinite"] == 0 if self.health == "guard" else None
        self._clip(per_cell)
        if opt.elementwise:
            for c in range(dp):
                args = (self.pieces(replicas[c], c), per_cell[c],
                        self.shards[c])
                _, self.shards[c] = (
                    opt.step(*args, clip=False) if ok is None
                    else opt.guarded_step(*args, ok, clip=False))
            # the all-gather: every replica takes each cell's new slices
            for r, rep in enumerate(replicas):
                for c in range(dp):
                    if c == r:
                        continue
                    for mine, theirs, d in zip(leaves(rep),
                                               leaves(replicas[c]),
                                               self.dims):
                        if d is not None:
                            cut(mine, dp, c, d).copy_(
                                cut(theirs, dp, c, d).to(mine.device))
        else:
            grads = self.gather_grads(per_cell, replicas[0])
            state = self.state(self.cells[0])
            if ok is None:
                _, state = opt.step(replicas[0], grads, state, clip=False)
            else:
                _, state = opt.guarded_step(replicas[0], grads, state, ok,
                                            old_params=old, clip=False)
            del grads
            replace_opt_state(self.shards, state)
            for rep in replicas[1:]:
                for mine, src in zip(leaves(rep), leaves(replicas[0])):
                    mine.copy_(src.to(mine.device))
        if pack is None:
            return None
        if ok is None:
            return update_health(pack, old, replicas[0])
        return update_health(pack, old, replicas[0],
                             skipped=(~ok).to(torch.int32))
