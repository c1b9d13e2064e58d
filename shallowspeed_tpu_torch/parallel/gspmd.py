"""The GSPMD engine family's base — counterpart of
`shallowspeed_tpu/parallel/gspmd.py::GSPMDEngine` — and its placement
machinery.

The reference picks a mesh, annotates each parameter leaf with a
`PartitionSpec`, jits one step and lets XLA insert the collectives. A
process drives its cells of a `parallel.mesh.Grid` of devices here (on
one card every cell is the card, in the tests the CPU), so the
placement and the collectives are explicit:

- **Placement.** `P` is the spec: per dimension an axis name or None.
  `shard` cuts a canonical (one-device) tree into every cell's tree —
  cell c holds, of each leaf, the block its spec names (a replicated
  leaf is a copy per cell) — and `gather` is its inverse. The canonical
  tree is the checkpoint's: "placement, not structure".
- **Replicas, laid out as the reference's.** Replica r trains on rows
  [r B/dp, (r+1) B/dp) of each batch, and every cell of replica r
  holds those rows (the reference's batch spec `P("dp", None)`): each
  tp or ep cell holds them whole, each sp cell its sequence tile at
  global positions. Every cell runs the replicated parts of the model
  (the embedding, the norms, the residual stream, the router and,
  without a tp-sharded head, the head) on its own copy of their leaves,
  and its shards of the others: the tensor-parallel blocks of cell (r,
  s, t), the expert shards of cell (r, s, e), and under FSDP the dp
  pieces of its dp group, gathered in rank order just in time for each
  block and freed after it (a saved-tensor hook re-gathers what the
  backward needs; a piece another process holds comes through the
  group, and its gradient goes back to it in the reduction). A
  replica's cells of this process run block by block in lockstep
  (`tensor.cells_block` over their `tensor.Lanes`) and meet in
  symmetric collectives over their groups, each one autograd node whose
  backward is written by hand (`distributed.Group`: rank-order sums,
  the one-process sum bit for bit): Megatron's f and g and the
  vocabulary-parallel loss over a tp group, the K/V all-gather over an
  sp group (`ops.attention.allgather_tiles`), the expert outputs'
  all-gather over an ep group (`ops.moe.moe_ffn_lanes`; the MoE layer
  routes whole rows, under sp gathered over the group first). Every
  tp and ep cell of a replica so holds the same loss and the same
  gradient of each replicated leaf. Each cell draws its dropout masks
  from its sp tile's key (`dropout_key`), the same on every tp and ep
  cell. The forward and backward run under torch autograd on detached
  aliases of the blocks, so each cell's gradient lands apart.
- **The reduction.** The cells' f32 gradients are summed in rank
  order over dp and sp, block by block (`_walk`) — a dp-sharded (FSDP)
  block's terms reduce-scattered onto the cell that owns it — and
  scaled by 1 / (dp sp); a leaf the tp or ep axis replicates is summed
  in one model column only (each process its own first model index,
  `_col`: the cells of a column compute it alike), never over tp or
  ep. MoE configs at dp > 1 run every replica's forward before one
  backward: the Switch balance loss is not linear in the shards, so
  each layer's f and P are summed over the dp group first (identity
  backward) and every cell adds dp x its weighted loss (the replicas'
  objective, each gradient counted once).
- **The update.** Every cell updates what it holds. Under ZeRO-1/2 each
  leaf is further sliced over dp on the first dimension its spec leaves
  free (`parallel.zero.zero2_grad_dim` with the spec, the reference's
  `_with_axis`), the optimizer state lives in those slices, each cell
  updates its slice and an all-gather copies the slices into the other
  replicas. The gradient's clipping norm and the health pack are the
  whole tree's: each leaf's squares summed over its distinct shards in
  rank order, a replicated leaf counted once. An `elementwise`
  optimizer updates slice by slice; Adafactor's factored statistics,
  RMS clipping and scaling run over whole leaves, so its update is the
  gathered one (`parallel/zero.py`'s answer): the canonical parameters,
  gradient and state gathered, updated, and cut back.

Subclasses (`tensor.TensorParallelEngine`, `fsdp.FSDPEngine`,
`composite.Composite3DEngine`, `expert.ExpertParallelEngine`) differ
only in their grid's axes, their spec tree and their config checks;
`pipeline_lm.PipelineLMEngine` also brings its own layout (`_layout` /
`_canonical`: blocks stacked) and its schedules' `_reduced`.
The attention is the plain one (`ops.attention.attention`), as the
reference's GSPMD engines run XLA attention: no K1-K3 launch on this
family's path.

Launched as several processes (`distributed`), a grid may span them
along any axis: each process `shard`s the canonical tree into its own
cells only and trains on the rows of its cells' replicas
(`local_batch`), one replica a round (the k-th of every process
together, so dp collectives pair up); the collectives above cross
between the processes by send / recv pairs in one global order; each
reduced block is summed on one cell (`_site`) and sent to every other
process that updates with it; `gather` (and so `get_canonical_params` /
`opt_state`) is collective, each block coming from the process that
holds it, and the update runs on this process's cells. The health pack
there sums every block's statistics in the one-process order, each
computed by the process that holds the block and shared
(`telemetry.health.Elsewhere`), so every process holds the same pack and
takes the same guard decision.

Comm overlap (`overlap=`) is refused with the reference's `ValueError`
(`supports_overlap = False`): the reference's GSPMD programs have only
compiler-inserted collectives. `fsdp.FSDPEngine` sets it True and takes
the overlapped step here: replica r >= 1's backward adds each bucket
into the sums from a hook (`parallel.overlap.BucketReducer`; each
dp-sharded leaf's pieces reduce-scattered onto their owner cells, the
replicated leaves in size-targeted buckets), and each block's just-in-
time gather for the next block is issued ahead, on the side stream on a
GPU, while the current block computes. Across processes (dp across
them) the gather ahead posts the other processes' pieces as transfers
in flight while the current block computes (`_Pieces.prefetch`), and
every replica's backward reduces so (`_reduced_in_flight`): a
bucket whose sum another process holds, and a gathered leaf's gradient
of another process's pieces the moment its last use's backward is done
(`_Sink`), go to that process as transfers in flight, and every sum
adds its replicas' terms in rank order at the join.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import moe as M
from shallowspeed_tpu_torch.ops.dropout import dropout as _dropout
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.optim import Adafactor
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.parallel.mesh import Grid, make_grid
from shallowspeed_tpu_torch.parallel.zero import Slices, zero2_grad_dim
from shallowspeed_tpu_torch.telemetry import collectives as C
from shallowspeed_tpu_torch.telemetry.health import (Elsewhere, check_mode,
                                                     engine_snapshot,
                                                     grad_health, note_step,
                                                     snapshot, update_health)
from shallowspeed_tpu_torch.telemetry.trace import tracer
from shallowspeed_tpu_torch.weights import leaves, map_tree, unflatten


# ------------------------------------------------------------- placement


class P:
    """A placement spec, the counterpart of `PartitionSpec`: per
    dimension the name of the grid axis it is cut over, or None (whole);
    missing trailing entries are None. A leaf of trees (not a tuple)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.padded(8) == other.padded(8)

    def __hash__(self):
        return hash(self.padded(8))

    def __repr__(self):
        return f"P{self.entries!r}"

    def padded(self, ndim: int) -> tuple:
        return self.entries + (None,) * (ndim - len(self.entries))

    def axes(self) -> tuple:
        return tuple(a for a in self.entries if a is not None)


def with_axis(spec: P, shape, size: int, axis: str = "dp") -> P:
    """`spec` with `axis` added on the leaf's `zero2_grad_dim` (unchanged
    when none qualifies) — the reference's `_with_axis`."""
    i = zero2_grad_dim(shape, size, spec, axis)
    if i is None:
        return spec
    entries = list(spec.padded(len(shape)))
    entries[i] = axis
    return P(*entries)


def block_shape(shape, spec: P, sizes: dict) -> tuple:
    """The shape of one cell's block of a leaf of `shape`."""
    return tuple(d // sizes[a] if a else d
                 for d, a in zip(shape, spec.padded(len(shape))))


def cut(x, spec: P, sizes: dict, coord: dict):
    """The block of `x` that a cell at `coord` ({axis: index}) holds: a
    view, cut along each dimension the spec names."""
    for i, a in enumerate(spec.padded(x.dim())):
        if a is not None:
            x = x.chunk(sizes[a], dim=i)[coord[a]]
    return x


def assemble(spec: P, ndim: int, sizes: dict, block, device):
    """A whole leaf from its blocks, `block(coord)` giving the block at
    `coord` ({axis: index} over the spec's axes): concatenated in rank
    order along each dimension the spec names, on `device`."""
    axes = [(i, a) for i, a in enumerate(spec.padded(ndim)) if a]

    def rec(k, coord):
        if k == len(axes):
            return block(coord).to(device)
        i, a = axes[k]
        return torch.cat([rec(k + 1, {**coord, a: j})
                          for j in range(sizes[a])], dim=i)

    return rec(0, {})


def _owned(x, device):
    return x.to(device, copy=True, memory_format=torch.contiguous_format)


def shard(tree, specs, grid: Grid) -> dict:
    """{cell coordinate: that cell's tree} of a canonical tree (tensors
    or numpy arrays; other leaves, such as a step counter, pass as they
    are) under the spec tree `specs`: each cell's blocks as tensors of
    its own, on its device; this process's cells only."""
    sizes = grid.shape
    out = {}
    for idx in np.ndindex(grid.devices.shape):
        coord = dict(zip(grid.axis_names, idx))
        dev = grid.devices[idx]
        if not D.is_local(dev):
            continue

        def leaf(x, s):
            if not isinstance(s, P):
                return x
            x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(x))
            return _owned(cut(x, s, sizes, coord), dev)

        out[idx] = map_tree(leaf, tree, specs)
    return out


def gather(shards: dict, specs, grid: Grid, device):
    """The canonical tree of `shard`'s per-cell trees on `device`, each
    leaf a new tensor: its blocks concatenated in rank order, each read
    from the first cell that holds it (non-tensor leaves from the first
    cell). Where `shards` lacks a cell (another process's), its block
    is shared by its owner: collective, every process calls it."""
    sizes, names = grid.shape, grid.axis_names
    first = next(iter(shards.values()))
    flat = {c: list(leaves(t)) for c, t in shards.items()}

    def block(k, i):
        c = tuple(k.get(a, 0) for a in names)
        return D.share(flat[c][i] if c in flat else None, grid.devices[c],
                       device)

    out = []
    for i, (x, s) in enumerate(zip(flat[next(iter(flat))],
                                   _in_order(first, specs))):
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        y = assemble(s, x.dim(), sizes, lambda k, i=i: block(k, i), device)
        out.append(y if s.axes() else y.clone())
    return unflatten(first, out)


class _GatherPieces(torch.autograd.Function):
    """A dp-sharded leaf's pieces gathered in rank order along their dim
    onto the reading cell: this process's pieces (the autograd inputs)
    and the others' received through the dp group. The backward hands
    each local piece its slice of the gradient and leaves every other
    process's slice in `pieces.sink`, the reading cell's contribution to
    that piece, which the reduction moves to the piece's owner."""

    @staticmethod
    def forward(ctx, pieces, *local):
        ctx.pieces = pieces
        return pieces.assemble(list(local))

    @staticmethod
    def backward(ctx, g):
        pc = ctx.pieces
        parts = g.chunk(pc.group.n, dim=pc.dim)
        for j, key in enumerate(pc.keys):
            if j not in pc.group.local:
                prev = pc.sink.get(key)
                pc.sink[key] = parts[j] if prev is None else prev + parts[j]
        if isinstance(pc.sink, _Sink):
            pc.sink.used(pc)
        return (None, *(parts[j] for j in pc.group.local))


class _Sink(dict):
    """A replica's gradients of other processes' FSDP pieces ({gradient
    key: tensor}, `_GatherPieces` fills it). With `ready`, each gathered
    leaf's pieces are handed to it once they are final — when the
    backward of the leaf's last use is done (`uses` counts the gathers
    made under grad) — as {gradient key: tensor}: the overlapped step
    sends them in flight from there."""

    def __init__(self, ready=None):
        super().__init__()
        self.ready = ready
        self.uses: dict = {}

    def gathered(self, pc) -> None:
        if self.ready is not None and torch.is_grad_enabled():
            k = tuple(pc.keys)
            self.uses[k] = self.uses.get(k, 0) + 1

    def used(self, pc) -> None:
        k = tuple(pc.keys)
        if self.ready is None or k not in self.uses:
            return
        self.uses[k] -= 1
        if not self.uses[k]:
            del self.uses[k]
            self.ready({key: self[key] for j, key in enumerate(pc.keys)
                        if j not in pc.group.local})


class _Pieces:
    """One leaf's dp pieces (an FSDP leaf) as a cell reads it: its dp
    group of cells (`distributed.Group`, rank order), this process's
    pieces (`parts`, the group's `local` order), gathered along `dim`
    onto `device` where a block reads the leaf; `keys` each piece's
    gradient key and `sink` where the others' gradients land. With
    `ahead` (`prefetch`), the other processes' pieces are already on
    the wire, and the next gather takes them from there."""

    __slots__ = ("group", "parts", "dim", "device", "keys", "sink", "ahead")

    def __init__(self, group, parts, dim, device, keys, sink):
        self.group, self.parts, self.dim = group, parts, dim
        self.device, self.keys, self.sink = device, keys, sink
        self.ahead = None

    def prefetch(self, seqs: dict) -> None:
        """Post this gather's transfers in flight (`distributed.AHEAD`):
        this process's pieces to every other process of the group, and
        the receives of theirs, each (sender, receiver) pair's in the
        order of `seqs`' counters (every process posts its gathers in
        one order: the same walk)."""
        me = D.process_index()
        by = {}
        for i, c in enumerate(self.group.cells):
            by.setdefault(D.owner(c), []).append(i)
        like = self.parts[0]
        sends, recvs = [], []
        for p, idx in sorted(by.items()):
            if p == me:
                continue
            seq = seqs[(me, p)] = seqs.get((me, p), -1) + 1
            sends.append(D.post_send(D.pack(self.parts), p, seq,
                                     channel=D.AHEAD))
            seq = seqs[(p, me)] = seqs.get((p, me), -1) + 1
            recvs.append((D.post_recv(
                p, seq, like.dtype, (len(idx) * like.numel(),),
                self.device, channel=D.AHEAD), idx))
        self.ahead = (sends, recvs)

    def assemble(self, local):
        if self.ahead is None:
            every = self.group.gather(local, "sum")
        else:
            # the pieces the gather ahead received; a later gather (the
            # backward's regather) goes through the group again
            sends, recvs = self.ahead
            every = dict(zip(self.group.local, local))
            for flight, idx in recvs:
                got = D.unpack(flight.wait(), [self.parts[0]] * len(idx))
                every.update(zip(idx, got))
            for flight in sends:
                flight.wait()
            every = [every[i] for i in range(self.group.n)]
            self.ahead = None
        return torch.cat([p.to(self.device) for p in every], dim=self.dim)

    def gather(self):
        C.count_tensors("dp", self.parts[0])   # the all-gather's operand
        if isinstance(self.sink, _Sink):
            self.sink.gathered(self)
        return _GatherPieces.apply(self, *self.parts)


class _Regather:
    """What the autograd graph keeps of a gathered leaf instead of the
    leaf: its pieces, gathered again when the backward needs it."""

    __slots__ = ("pieces", "dtype")

    def __init__(self, pieces: _Pieces, like):
        self.pieces, self.dtype = pieces, like.dtype

    def gather(self):
        with torch.no_grad():
            return self.pieces.gather().to(self.dtype)


def _pack(t):
    info = getattr(t, "_regather", None)
    return t if info is None else info


def _unpack(x):
    return x.gather() if isinstance(x, _Regather) else x


# ---------------------------------------------------------------- engine


class GSPMDEngine:
    """Data x model parallel trainer for the transformer LM family over a
    `Grid` whose first axis is 'dp'; each subclass names its axes,
    validates the config (`validate`, which sets self.sp / self.tp /
    self.ep) and gives the spec tree (`param_specs`). `params`, when
    given, is a numpy tree to start from instead of drawing `init(cfg,
    seed)` again."""

    # the canonical (one-device) tree is this family's checkpoint layout:
    # its optimizer state interchanges with every engine's as it is
    canonical_opt_identity = True

    # the reference's GSPMD programs have only compiler-inserted
    # collectives, which cannot be bucketed; the FSDP subclass, whose
    # reference builds an explicit overlapped step, sets this True
    supports_overlap = False

    def __init__(self, cfg: T.TransformerConfig, optimizer, seed: int = 0,
                 device=None, *, mesh: Grid | None = None,
                 zero1: bool = False, zero2: bool = False,
                 health: str = "off", overlap=None, params=None):
        if zero1 and zero2:
            raise ValueError("zero2 subsumes zero1")
        check_mode(health)
        if overlap is not None and not self.supports_overlap:
            raise ValueError(
                f"{type(self).__name__} is GSPMD-partitioned — its "
                f"collectives are compiler-inserted and cannot be "
                f"bucketed explicitly; --overlap supports the fsdp, "
                f"context (dense/zero1/zero2), fused-dp, and spmd "
                f"pipeline engines")
        if mesh is not None and device is not None:
            raise ValueError("pass the devices through the mesh or `device`, "
                             "not both")
        if mesh is None:
            mesh = make_grid(self.default_axes, (1,) * len(
                self.default_axes), device)
        if cfg.fp8_dense:
            raise ValueError("cfg.fp8_dense trains on fp8.Fp8TrainEngine; "
                             "the GSPMD engines run the compute dtype")
        self.cfg = cfg
        self.mesh = mesh
        self.optimizer = optimizer
        self.health = health
        self.last_health = None
        self.seed = seed
        self.sp = self.tp = self.ep = 1
        self.validate(cfg, mesh)
        self.names = mesh.axis_names
        self.sizes = mesh.shape
        self.dp = self.sizes["dp"]
        self.model_axis = ("tp" if "tp" in self.names else
                           "ep" if "ep" in self.names else None)
        self.coords = list(np.ndindex(mesh.devices.shape))
        self._dev = {c: mesh.devices[c] for c in self.coords}
        # this process's cells (every cell in one process)
        self._local = [c for c in self.coords if D.is_local(self._dev[c])]
        self._remote = len(self._local) < len(self.coords)
        self.device = self._dev[self._local[0]]
        self.zero = zero1 or zero2
        self._step_count = 0
        self.overlap = overlap
        self._plan = None           # the overlapped step's buckets
        self._bucket_sigs = []

        self._template = self._layout(T.param_shapes(cfg))
        self._index = unflatten(self._template,
                                range(len(list(leaves(self._template)))))
        spec_tree = self.param_specs(cfg)
        self.specs = spec_tree
        self._pspecs = _in_order(self._template, spec_tree)
        self._shapes = [tuple(m.shape) for m in leaves(self._template)]
        self._uspecs = [with_axis(s, shp, self.dp) if self.zero else s
                        for s, shp in zip(self._pspecs, self._shapes)]
        self._fsdp = any("dp" in s.axes() for s in self._pspecs)

        draw = self._layout(T.init_numpy(cfg, seed) if params is None
                            else params)
        draw = unflatten(self._template, _in_order(self._template, draw))
        self._shards = {c: list(leaves(tree)) for c, tree in
                        shard(draw, spec_tree, mesh).items()}
        del draw
        self._init_state()
        self._layout_processes()

    # ------------------------------------------------ subclass surface

    default_axes = ("dp",)

    def validate(self, cfg: T.TransformerConfig, mesh: Grid) -> None:
        raise NotImplementedError

    def param_specs(self, cfg: T.TransformerConfig):
        raise NotImplementedError

    def _layout(self, tree):
        """A canonical (one-device, checkpoint) tree in the engine's own
        layout, the one its specs, cells and optimizer state follow: the
        canonical tree itself here (the pipeline stacks its blocks)."""
        return tree

    def _canonical(self, tree):
        """The inverse of `_layout`."""
        return tree

    # ------------------------------------------------------- placement

    def _coord(self, c) -> dict:
        return dict(zip(self.names, c))

    def _key(self, spec: P, coord: dict) -> tuple:
        """The block a cell at `coord` holds under `spec`: its indices on
        the spec's axes, in grid-axis order."""
        used = spec.axes()
        return tuple((a, coord[a]) for a in self.names if a in used)

    def _piece(self, x, i: int, c):
        """Cell c's update piece of its block `x` of leaf i: its dp slice
        under ZeRO (a view), else the block."""
        us, ps = self._uspecs[i], self._pspecs[i]
        if us is ps:
            return x
        z = us.padded(x.dim()).index("dp")
        return x.chunk(self.dp, dim=z)[c[0]]

    def _state_specs(self, meta_state):
        """The spec of every optimizer-state leaf: a moment's is its
        parameter's; Adafactor's row and column statistics keep the
        parameter's surviving dims' axes (the reference's `_slot`);
        under ZeRO each also takes dp on its first free dimension."""
        specs = unflatten(self._template, self._pspecs)
        if isinstance(self.optimizer, Adafactor):
            from shallowspeed_tpu_torch.weights import sorted_leaves

            def slot(sl, s, shape):
                e = s.padded(len(shape))
                out = {"vr": P(*e[:-1]), "vc": P(*e[:-2], e[-1])}
                return {k: out.get(k, s) for k in sl}

            shapes = list(sorted_leaves(self._template))
            tree = {"slots": tuple(
                slot(sl, s, m.shape) for sl, s, m in
                zip(meta_state["slots"], sorted_leaves(specs), shapes)),
                "t": None}
        else:
            tree = self.optimizer.map_state_trees(meta_state,
                                                  lambda _: specs)
        if not self.zero:
            return tree
        return map_tree(
            lambda x, s: (with_axis(s, x.shape, self.dp)
                          if isinstance(x, torch.Tensor) and x.dim()
                          else s), meta_state, tree)

    def _init_state(self) -> None:
        """Every cell's optimizer state: zeros of its blocks of the
        canonical state, under `_state_specs`."""
        opt = self.optimizer
        meta = unflatten(self._template, list(leaves(self._template)))
        if isinstance(opt, Adafactor):
            meta_state = opt.init(meta, unflatten(self._template,
                                                  self._pspecs))
        else:
            meta_state = opt.init(meta)
        self._sspecs = self._state_specs(meta_state)
        self._states = {}
        for c in self._local:
            dev = self._dev[c]

            def leaf(x, s):
                if not isinstance(x, torch.Tensor):
                    return x
                return torch.zeros(block_shape(x.shape, s or P(), self.sizes),
                                   dtype=x.dtype, device=dev)

            self._states[c] = map_tree(leaf, meta_state, self._sspecs)

    # ------------------------------------------------------- replicas

    def _rep_axis(self):
        """The axis whose cells each run their replica's replicated parts
        on their own copy (tp or ep), None without one."""
        return self.model_axis

    def _layout_processes(self) -> None:
        """Who computes what across processes: each process's replicas
        in order (`_reps`; the k-th of every process runs in round k, so
        collectives over dp pair up), and the model column each process
        sums a replicated leaf's gradient in (`_col`: its first model
        index; the cells of one column compute that gradient alike, so
        it is summed over dp and sp only)."""
        self.rep_axis = self._rep_axis()
        self._mi = (self.names.index(self.rep_axis) if self.rep_axis
                    else None)
        self._si = self.names.index("sp") if "sp" in self.names else None
        owner = {c: D.owner(self._dev[c]) for c in self.coords}
        procs = sorted(set(owner.values()))
        reps = {p: sorted({c[0] for c in self.coords if owner[c] == p})
                for p in procs}
        if (len({len(v) for v in reps.values()}) > 1
                or any(v != list(range(v[0], v[-1] + 1))
                       for v in reps.values())):
            raise ValueError(f"every process must hold cells of as many "
                             f"replicas, consecutive ones, got {reps}")
        self._round = {r: k for v in reps.values() for k, r in enumerate(v)}
        self._reps = reps[D.process_index()]
        self._col_of = {p: (0 if self._mi is None else
                            min(c[self._mi] for c in self.coords
                                if owner[c] == p)) for p in procs}
        self._cols = sorted(set(self._col_of.values()))
        self._col = self._col_of[D.process_index()]
        self._lane_cache, self._dp_groups, self._plans = {}, {}, {}
        # FSDP's gathers ahead in flight: each (sender, receiver) pair's
        # last sequence number (`_Pieces.prefetch`)
        self._ahead_seqs = {}

    def _rep(self, i: int) -> bool:
        """Whether leaf i is replicated over the `rep_axis` (every cell
        of a replica computes its gradient alike)."""
        return (self._mi is not None
                and self.rep_axis not in self._pspecs[i].axes())

    def _cell(self, r, s=0, m=0) -> tuple:
        k = {"dp": r, "sp": s, self.model_axis: m}
        return tuple(k.get(a, 0) for a in self.names)

    def home(self, r: int):
        """Replica r's first cell's device."""
        return self._dev[self._cell(r)]

    def _replica_cells(self, r: int) -> list:
        """Every cell of replica r, in grid order."""
        return [c for c in self.coords if c[0] == r]

    def _groups(self, cells, axis: str, cls=D.Group) -> list:
        """The groups along `axis` of `cells` (this process's cells of a
        replica, its lanes): (group, [lane indices in the group's
        `local` order]) per group, in the lanes' order."""
        k = self.names.index(axis)
        pos = {c: i for i, c in enumerate(cells)}
        out, seen = [], set()
        for c in cells:
            base = c[:k] + c[k + 1:]
            if base in seen:
                continue
            seen.add(base)
            members = [c[:k] + (j,) + c[k + 1:]
                       for j in range(self.sizes[axis])]
            g = cls([self._dev[m] for m in members])
            out.append((g, [pos[members[j]] for j in g.local]))
        return out

    def _lanes_of(self, r: int):
        """(this process's cells of replica r in grid order, their
        `tensor.Lanes`: the tp, sp and ep groups that join them)."""
        got = self._lane_cache.get(r)
        if got is None:
            from shallowspeed_tpu_torch.ops.attention import SpGroup
            from shallowspeed_tpu_torch.parallel.tensor import Lanes

            cs = [c for c in self._local if c[0] == r]
            kw = {a: self._groups(cs, a, SpGroup if a == "sp" else D.Group)
                  for a in ("tp", "sp", "ep") if self.sizes.get(a, 1) > 1}
            got = self._lane_cache[r] = (cs, Lanes(len(cs), **kw))
        return got

    def _dp_group(self, c):
        """Cell c's dp group (the cells that differ from it in dp only)
        and the coordinates of its cells of this process, `local`
        order."""
        got = self._dp_groups.get(c[1:])
        if got is None:
            members = [(j,) + c[1:] for j in range(self.dp)]
            g = D.Group([self._dev[m] for m in members])
            got = self._dp_groups[c[1:]] = (g, [members[j] for j in g.local])
        return got

    def place(self, arr) -> torch.Tensor:
        """A (B, T) token batch (numpy, or a tensor a prefetcher already
        placed) as int64 on the engine's first cell."""
        t = (arr if isinstance(arr, torch.Tensor)
             else torch.as_tensor(np.asarray(arr))).to(self.device,
                                                       torch.long)
        if t.dim() != 2 or t.shape[1] > self.cfg.max_seq:
            raise ValueError(f"token batch {tuple(t.shape)} must be (B, T) "
                             f"with T <= max_seq={self.cfg.max_seq}")
        return t

    def local_batch(self, arr):
        """This process's rows of a global batch every process builds
        alike: the rows of the replicas its cells belong to (the whole
        batch in one process, or where no process holds a replica
        alone)."""
        b = arr.shape[0]
        if b % self.dp:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"dp={self.dp}")
        rows = b // self.dp
        return arr[self._reps[0] * rows:(self._reps[-1] + 1) * rows]

    def _rows(self, *batches) -> dict:
        """{replica: its rows of every (B, T) batch} of this process's
        replicas: the batches hold those replicas' rows (`local_batch`;
        the whole batch in one process)."""
        ts = [self.place(b) for b in batches]
        b, t = ts[0].shape
        n = len(self._reps)
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"dp={self.dp}" + (
                                 f" ({b} local rows for {n} of the "
                                 f"replicas)" if self._remote else ""))
        if t % self.sp:
            raise ValueError(f"sequence length {t} does not split over "
                             f"sp={self.sp}")
        return {r: tuple(x.chunk(n)[k] for x in ts)
                for k, r in enumerate(self._reps)}

    def dropout_key(self, replica: int = 0):
        """The dropout key of this step on `replica` (None when the config
        has no dropout): one key a step, a pure function of (seed, step,
        tile) as `parallel.context` derives it, so a resumed run draws
        the same masks; tile 0 keys (seed, step) as one device does, and
        at sp > 1 a tuple of the replica's sp tile keys. Every tp and ep
        cell of a replica draws from its tile's key."""
        if self.cfg.dropout == 0.0 and self.cfg.attn_dropout == 0.0:
            return None
        keys = tuple(fold_key(self.seed, self._step_count, 0,
                              *([tile] if tile else []))
                     for tile in range(replica * self.sp,
                                       (replica + 1) * self.sp))
        return keys[0] if self.sp == 1 else keys

    def _alias(self, aliases: dict, c, i: int, key: tuple, src):
        """Cell c's compute leaf for block `key` of leaf i, read from cell
        `src` (c itself, or a dp piece's cell): a detached alias of that
        cell's block (its gradient lands on the alias)."""
        a = aliases.get((c, i, key))
        if a is None:
            a = self._shards[src][i].detach().requires_grad_(True)
            aliases[(c, i, key)] = a
        return a

    def _src(self, aliases, sink, c, i: int):
        """What cell c's block reads of leaf i: the alias of its own
        block, or under FSDP the dp pieces to gather (this process's as
        aliases, the others' through the dp group)."""
        spec = self._pspecs[i]
        coord = self._coord(c)
        if "dp" not in spec.axes():
            return self._alias(aliases, c, i, self._key(spec, coord), c)
        g, mine = self._dp_group(c)
        keys = [(c, i, self._key(spec, {**coord, "dp": j}))
                for j in range(self.dp)]
        parts = [self._alias(aliases, c, i, keys[m[0]][2], m) for m in mine]
        return _Pieces(g, parts, spec.padded(len(self._shapes[i])).index("dp"),
                       self._dev[c], keys, sink)

    def _block_src(self, aliases, sink, c, i: int):
        """Block i's tree as cell c's lane reads it."""
        return map_tree(lambda j: self._src(aliases, sink, c, j),
                        self._index["blocks"][i])

    def _top_src(self, aliases, sink, c, keys):
        return {k: map_tree(lambda j: self._src(aliases, sink, c, j),
                            self._index[k]) for k in keys}

    def _materialize(self, src, cast: bool = True):
        """A block's tree of tensors: FSDP pieces gathered (each copy
        marked so that the autograd graph keeps its pieces, not the
        copy), cast to the compute dtype as `cast_params` casts."""
        full = map_tree(lambda s: s.gather() if isinstance(s, _Pieces)
                        else s, src)
        out = T.cast_params(full, self.cfg.compute_dtype) if cast else full
        if self._fsdp:
            for s, t in zip(leaves(src), leaves(out)):
                if isinstance(s, _Pieces):
                    t._regather = _Regather(s, t)
        return out

    def _run_block(self, srcs, xs, cfg, poss, lanes, keys):
        from shallowspeed_tpu_torch.parallel.tensor import cells_block

        return cells_block([self._materialize(s) for s in srcs], xs, cfg,
                           poss, lanes, keys)

    def _gather_ahead(self, src, device):
        """`_materialize(src)` issued ahead of its block, on `device`'s
        side stream on a GPU (it waits for the main stream first);
        `_take` hands it to the main stream. Across processes the other
        processes' pieces are posted as transfers in flight
        (`_Pieces.prefetch`, numbered by `_ahead_seqs`), and `_take`
        gathers them."""
        if self._remote:
            for tree in src:
                for x in leaves(tree):
                    if isinstance(x, _Pieces):
                        x.prefetch(self._ahead_seqs)
            return src, "in flight"
        stream = OV.side_stream(device)
        if stream is None:
            return [self._materialize(x) for x in src], None
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            return [self._materialize(x) for x in src], stream

    def _take(self, ahead):
        """The trees `_gather_ahead` issued, the main stream waiting for
        them and each of their tensors marked as used there (the allocator
        keeps them until the main stream is done with them); across
        processes the trees gathered from the transfers in flight."""
        tree, stream = ahead
        if stream == "in flight":
            return [self._materialize(x) for x in tree]
        if stream is not None:
            main = torch.cuda.current_stream(stream.device)
            main.wait_stream(stream)
            for t in leaves(tree):
                t.record_stream(main)
        return tree

    def _forward(self, aliases, sink, cs, lanes, toks, poss, keys):
        """The final-norm hidden states of this process's cells `cs` of
        one replica (its lanes, in lockstep: `tensor.cells_block`) on
        their token tiles `toks` at positions `poss`, each lane's dropout
        key `keys`, and their MoE terms [[(aux, z, stats) per MoE layer]
        per lane]: the blocks as `transformer.forward_with_aux` runs
        them."""
        from shallowspeed_tpu_torch.parallel.tensor import cells_block

        cfg = self.cfg
        t = toks[0].shape[1] * self.sp
        if t > cfg.max_seq:
            raise ValueError(f"sequence of {t} exceeds max_seq={cfg.max_seq}")
        xs = []
        for c, tok, pos, key in zip(cs, toks, poss, keys):
            emb = self._materialize(self._top_src(aliases, sink, c,
                                                  ("tok_emb", "pos_emb")))
            x = emb["tok_emb"][tok]
            if not cfg.rope:
                x = x + emb["pos_emb"][pos]
            del emb
            if key is not None:
                x = _dropout(x, cfg.dropout, fold_key(key, cfg.n_layers))
            xs.append(x)
        remat = cfg.remat and torch.is_grad_enabled()
        block = (T._remat_block(cfg, self._run_block) if remat
                 else self._run_block)
        # the overlapped FSDP step gathers block i + 1 while block i
        # computes (not under remat: its blocks gather inside the
        # checkpoint, again in the backward)
        dev = self._dev[cs[0]]
        ahead = None
        if self._fsdp and self.overlap is not None and not remat:
            ahead = self._gather_ahead(
                [self._block_src(aliases, sink, c, 0) for c in cs], dev)
        moe = [[] for _ in cs]
        for i in range(cfg.n_layers):
            ks = [None if k is None else fold_key(k, i) for k in keys]
            if ahead is None:
                xs, ms = block([self._block_src(aliases, sink, c, i)
                                for c in cs], xs, cfg, poss, lanes, ks)
            else:
                ps = self._take(ahead)
                ahead = (self._gather_ahead(
                    [self._block_src(aliases, sink, c, i + 1) for c in cs],
                    dev) if i + 1 < cfg.n_layers else None)
                xs, ms = cells_block(ps, xs, cfg, poss, lanes, ks)
                del ps
            for lane, (aux, z, st) in zip(moe, ms):
                if st is not None:
                    lane.append((aux, z, st))
        out = []
        for c, x in zip(cs, xs):
            ln = self._materialize(self._top_src(aliases, sink, c, ("ln_f",)))
            out.append(T._norm(ln["ln_f"], x, cfg))
        return out, moe

    def _token_losses(self, aliases, sink, cs, lanes, hid, tgts,
                      train: bool) -> list:
        """Each lane's mean token loss on its tile (`transformer.
        token_loss`, or `chunked_token_loss` with cfg.xent_chunk;
        vocabulary-parallel over each tp group under a tp-sharded head,
        the same loss on every cell of the group)."""
        cfg = self.cfg
        name = "tok_emb" if cfg.tie_embeddings else "head"
        if self.tp > 1 and not cfg.tie_embeddings:
            from shallowspeed_tpu_torch.parallel.tensor import (
                vocab_parallel_loss)

            heads = [self._materialize(self._top_src(aliases, sink, c,
                                                     (name,))) for c in cs]
            out = [None] * len(cs)
            for g, idx in lanes.tp:
                got = vocab_parallel_loss([heads[k] for k in idx],
                                          [hid[k] for k in idx],
                                          tgts[idx[0]], cfg, g, train)
                for k, loss in zip(idx, got):
                    out[k] = loss
            return out
        out = []
        for c, h, y in zip(cs, hid, tgts):
            if cfg.xent_chunk > 0:
                hp = self._materialize(self._top_src(aliases, sink, c,
                                                     (name,)), cast=False)
                out.append(T.chunked_token_loss(hp, h, y, cfg, train))
            else:
                hp = self._materialize(self._top_src(aliases, sink, c,
                                                     (name,)))
                out.append(T.token_loss(T.head_logits(hp, h, cfg), y, cfg,
                                        train))
        return out

    def _replica_terms(self, aliases, sink, r, rows, train, key):
        """(lanes' cells, final-norm hidden states, token losses — None
        without targets —, MoE terms, balance terms [(f, P) per MoE layer]
        per lane) of this process's cells of replica r on its `rows`
        ((tokens,) or (tokens, targets)): lane (r, s, m) on sequence tile
        s at its global positions, with tile s's dropout key."""
        cs, lanes = self._lanes_of(r)
        tok, tgt = (rows[0], rows[1] if len(rows) > 1 else None)
        t = tok.shape[1] // self.sp
        toks, tgts, poss, keys = [], [], [], []
        for c in cs:
            s = 0 if self._si is None else c[self._si]
            dev = self._dev[c]
            toks.append(tok[:, s * t:(s + 1) * t].to(dev))
            tgts.append(None if tgt is None else
                        tgt[:, s * t:(s + 1) * t].to(dev))
            poss.append(s * t + torch.arange(t, device=dev))
            keys.append(key[s] if isinstance(key, tuple) else key)
        hooks = (torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
                 if self._fsdp and torch.is_grad_enabled()
                 else contextlib.nullcontext())
        with hooks, M.balance_terms() as bal:
            hid, moe = self._forward(aliases, sink, cs, lanes, toks, poss,
                                     keys)
            tls = (None if tgt is None else
                   self._token_losses(aliases, sink, cs, lanes, hid, tgts,
                                      train))
        n = len(cs)
        return cs, hid, tls, moe, [list(bal)[k::n] for k in range(n)]

    def _objectives(self, terms: dict) -> dict:
        """{cell: (objective, loss share)} of the lanes of `terms`
        ({replica: `_replica_terms`}): each lane's token loss plus, for a
        MoE config, dp x the weighted balance loss and the weighted
        z-loss of its routing, in `transformer.loss`'s order — so that
        the lanes' gradients summed over one model column are the
        replicas' (dp sp)-scaled objective's, each counted once — and
        its share of the loss (the balance loss once, not dp times).
        At dp > 1 the balance loss is the global one: each layer's f and
        P summed over the dp group in rank order (`tensor.
        reduce_from_cells`, identity backward) and averaged before their
        product."""
        from shallowspeed_tpu_torch.parallel.tensor import reduce_from_cells

        cfg = self.cfg
        lanes = {c: (tl, moe, bal) for cs, _, tls, moes, bals in
                 terms.values() for c, tl, moe, bal in zip(cs, tls, moes,
                                                           bals)}
        aux = {}
        if cfg.n_experts > 0 and self.dp > 1:
            e = cfg.n_experts
            done = set()
            for c in sorted(lanes):
                g, mine = self._dp_group(c)
                if c[1:] in done:
                    continue
                done.add(c[1:])
                for layer in range(len(lanes[c][2])):
                    fs = reduce_from_cells([lanes[m][2][layer][0]
                                            for m in mine], g, "sum")
                    ps = reduce_from_cells([lanes[m][2][layer][1]
                                            for m in mine], g, "sum")
                    for m, f, p in zip(mine, fs, ps):
                        aux[m] = aux.get(m, 0.0) + e * torch.sum(
                            (f / self.dp) * (p / self.dp))
        out = {}
        for c, (tl, moe, _) in lanes.items():
            total = value = tl
            if moe:
                if c in aux:
                    a = aux[c]
                else:
                    a = 0.0
                    for x, _, _ in moe:
                        a = a + x
                total = total + self.dp * (cfg.moe_aux_weight * a)
                # the loss counts the global balance loss once a replica
                value = (total if self.dp == 1 else
                         value + cfg.moe_aux_weight * a)
                if cfg.moe_z_weight > 0.0:
                    z = 0.0
                    for _, zl, _ in moe:
                        z = z + zl
                    total = total + cfg.moe_z_weight * z
                    value = (total if self.dp == 1 else
                             value + cfg.moe_z_weight * z)
            out[c] = (total, value)
        return out

    def _total(self, objs: dict):
        """The (dp sp)-scaled loss: the objectives of one model column's
        cells (`_cols[0]`) summed in grid order, each shared by its
        process, on the first cell of every process."""
        total = None
        for c in self.coords:
            if self._mi is not None and c[self._mi] != self._cols[0]:
                continue
            x = objs.get(c)
            total = D.add_term(total, None if x is None else
                               x.detach().clone(), self._dev[c],
                               self.device, everywhere=True)
        n = self.dp * self.sp
        return total / n if n > 1 else total

    def _coupled(self) -> bool:
        return self.cfg.n_experts > 0 and self.dp > 1

    def _site(self, u: tuple, m):
        """The cell that sums update block `u` of a leaf: u's indices, dp
        0 where u has none, the model column m of a replicated leaf,
        every other axis 0."""
        k = dict(u)
        return tuple(k.get(a, m if a == self.rep_axis and m is not None
                           else 0) for a in self.names)

    def _add(self, red, i: int, u: tuple, m, piece, src) -> None:
        """Add cell `src`'s gradient term `piece` (None: another
        process's) of leaf i's update block u, model column m, into its
        sum on the sum's cell (`distributed.add_term`: one-process order,
        a move across processes)."""
        site = self._dev[self._site(u, m)]
        acc = red[i].get((u, m))
        if acc is None and piece is not None and D.is_local(site):
            piece = piece.to(site, copy=True)   # autograd may hand two
            #                                     leaves one tensor
        got = D.add_term(acc, piece, src, site)
        if got is not None:
            red[i][(u, m)] = got

    def _walk(self, red, r: int, grads: dict) -> None:
        """Replica r's gradient terms added into `red` in the one-process
        order: its cells in grid order, each leaf, each block it read (a
        dp piece's term reduce-scattered onto its owner); a replicated
        leaf's terms only from the cells of the model columns `_cols`.
        Every process walks every term (`grads` holds its own, keyed
        (cell, leaf, block))."""
        for c in self._replica_cells(r):
            src = self._dev[c]
            local = D.is_local(src)
            coord = self._coord(c)
            for i, (us, ps) in enumerate(zip(self._uspecs, self._pspecs)):
                m = None
                if self._rep(i):
                    m = c[self._mi]
                    if m not in self._cols:
                        continue
                blocks = ([self._key(ps, {**coord, "dp": j})
                           for j in range(self.dp)] if "dp" in ps.axes()
                          else [self._key(ps, coord)])
                for b in blocks:
                    g = None
                    if local:
                        # an unused leaf (pos_emb under RoPE) whose piece
                        # another process holds has no term: zeros, as
                        # autograd gives the local ones
                        g = grads.get((c, i, b))
                        g = (torch.zeros(block_shape(self._shapes[i], ps,
                                                     self.sizes),
                                         device=src) if g is None
                             else g.float())
                    if r == 1 and g is not None:
                        C.count("dp", g.numel() * 4)   # replica 1's partial
                    if us is ps:
                        parts = [(b, g)]
                    else:
                        z = us.padded(len(self._shapes[i])).index("dp")
                        pieces = ([None] * self.dp if g is None
                                  else g.chunk(self.dp, z))
                        parts = [(tuple(sorted(
                            b + (("dp", j),),
                            key=lambda kv: self.names.index(kv[0]))), x)
                                 for j, x in enumerate(pieces)]
                    for u, x in parts:
                        self._add(red, i, u, m, x, src)

    def _sum_plan(self, i: int) -> list:
        """(u, m, sum's cell, [cells to send the sum to]) of leaf i, in
        order: every update block, per model column for a replicated
        leaf; the receivers one cell of each other process that updates
        with the sum (a replicated leaf's: the processes of column m)."""
        plan = self._plans.get(i)
        if plan is None:
            us = self._uspecs[i]
            need = {}
            for c in self.coords:
                p = D.owner(self._dev[c])
                m = self._col_of[p] if self._rep(i) else None
                need.setdefault((self._key(us, self._coord(c)), m),
                                {}).setdefault(p, c)
            plan = []
            for u, m in sorted(need, key=lambda k: (k[0], -1 if k[1] is None
                                                    else k[1])):
                site = self._site(u, m)
                home = D.owner(self._dev[site])
                plan.append((u, m, site, [c for p, c in
                                          sorted(need[(u, m)].items())
                                          if p != home]))
            self._plans[i] = plan
        return plan

    def _finish_sums(self, red) -> list:
        """The walked sums to every process that updates with them (from
        the process that summed each, in plan order), then each leaf's
        blocks as this process uses them: {u: sum} in key order, a
        replicated leaf's from this process's column."""
        if self._remote:
            for i in range(len(red)):
                for u, m, site, recv in self._sum_plan(i):
                    for cell in recv:
                        got = D.move(red[i].get((u, m)), self._dev[site],
                                     self._dev[cell], "sum")
                        if got is not None:
                            red[i][(u, m)] = got
        return [dict(sorted((u, g) for (u, m), g in b.items()
                            if m is None or m == self._col)) for b in red]

    def _reduced(self, tokens, targets):
        """(loss, reduced gradient): `red[i]` {update block key: f32
        gradient} of every leaf i, the replicas' terms summed in rank
        order (`_walk`) and scaled by 1 / (dp sp). Each process runs its
        replicas one a round (the k-th of every process in round k);
        a replica's terms are walked once every replica before it has
        run."""
        rows = self._rows(tokens, targets)
        if self._remote and self._plan is not None:
            return self._reduced_in_flight(rows)
        red = [dict() for _ in self._pspecs]
        objs_all, pending = {}, {}
        nxt = 0

        def grads_of(objs, aliases, sink):
            with torch.enable_grad():
                gs = torch.autograd.grad([x for x, _ in objs.values()],
                                         list(aliases.values()),
                                         allow_unused=True,
                                         materialize_grads=True)
            out = dict(zip(aliases, gs))
            out.update(sink)
            return out

        def walk_done(k):
            nonlocal nxt
            while nxt < self.dp and self._round[nxt] <= k:
                grads = pending.pop(nxt, {})
                self._walk(red, nxt, grads)
                nxt += 1

        if self._coupled():
            aliases, sink, terms = {}, {}, {}
            with torch.enable_grad():
                for r in self._reps:
                    terms[r] = self._replica_terms(
                        aliases, sink, r, rows[r], True, self.dropout_key(r))
                objs = self._objectives(terms)
            del terms
            grads = grads_of(objs, aliases, sink)
            objs_all = {c: v.detach() for c, (_, v) in objs.items()}
            del objs, aliases
            for r in self._reps:
                pending[r] = grads
        else:
            for k, r in enumerate(self._reps):
                aliases, sink = {}, {}
                with torch.enable_grad():
                    objs = self._objectives({r: self._replica_terms(
                        aliases, sink, r, rows[r], True,
                        self.dropout_key(r))})
                if r and self._plan is not None:
                    if r == 1:
                        C.count("dp", sum(a.numel() * 4
                                          for a in aliases.values()))
                    self._reduce_in_backward(r, objs, aliases, red)
                    nxt = max(nxt, r + 1)
                else:
                    pending[r] = grads_of(objs, aliases, sink)
                objs_all.update({c: v.detach() for c, (_, v) in
                                 objs.items()})
                del objs, aliases, sink
                walk_done(k)
            if self._plan is not None:
                cells = {self._dev[c] for c in self.coords}
                for d in {self.home(r) for r in range(1, self.dp)}:
                    for into in cells:
                        OV.join(d, into)
        walk_done(len(self.coords))
        total = self._total(objs_all)
        n = self.dp * self.sp
        if n > 1:
            for blocks in red:
                for g in blocks.values():
                    g.mul_(1.0 / n)
        return total, self._finish_sums(red)

    def _reduce_in_backward(self, r: int, objs, aliases, red) -> None:
        """Replica r's backward with the overlapped reduction (one
        process, a ("dp",) grid): each bucket of `_plan` ((leaf, block
        key) pairs) added into `red` from a hook the moment its gradients
        are final, on r's cell's side stream on a GPU (the caller joins
        it)."""
        def add(k, g):
            i, key = k
            mine = red[i][(key, None)]
            mine.add_(g.to(mine.device))

        tensors = {(i, key): a for (_, i, key), a in aliases.items()}
        ((loss, _),) = objs.values()
        with torch.enable_grad():
            OV.BucketReducer(self._plan, add, self.home(r)).backward(
                loss, tensors)

    def _reduced_in_flight(self, rows):
        """`_reduced` across processes with the overlapped reduction
        (FSDP's: a ("dp",) grid, one cell a replica): every update block
        this process sums a `RankSum` over the replicas in rank order;
        the receives of the other processes' messages posted first, then
        each of this process's replicas' backward, whose buckets (a
        replicated leaf's, from a hook) and gathered leaves' pieces of
        other processes (from `_Sink`) go to the block's summing process
        as they become final, in each (sender, receiver)'s agreed order
        (replica, then bucket); then the join. The forward's gathers one
        block ahead travel in flight too (`_gather_ahead`)."""
        me = D.process_index()
        procs = sorted({D.owner(self._dev[c]) for c in self.coords})

        def owner_of(i, key):
            return D.owner(self._dev[self._site(key, None)])

        def shape_of(i):
            return block_shape(self._shapes[i], self._pspecs[i], self.sizes)

        def layout(r, b, q):
            return [((i, key), r, shape_of(i))
                    for i, key in self._plan[b] if owner_of(i, key) == q]

        xs = OV.CrossSums()
        for bucket in self._plan:
            for i, key in bucket:
                if owner_of(i, key) == me:
                    xs.expect((i, key), self.dp,
                              self._dev[self._site(key, None)])
        seq, msgs = {}, {}
        for r in range(self.dp):
            p = D.owner(self.home(r))
            for b in range(len(self._plan)):
                for q in procs:
                    if q != p and layout(r, b, q):
                        k = seq[(p, q)] = seq.get((p, q), -1) + 1
                        msgs[(r, b, q)] = k
                        if q == me:
                            xs.recv(p, k, layout(r, b, q), self.device)
        bucket_of = {ik: b for b, bucket in enumerate(self._plan)
                     for ik in bucket}
        objs_all = {}
        for r in self._reps:
            def hand(b, got, r=r):
                """Bucket b's terms of replica r ({(leaf, key): term}):
                the local sums', the others' sent."""
                for q in procs:
                    part = [got[ik] for ik, _, _ in layout(r, b, q)
                            if ik in got]
                    if q != me and part:
                        xs.send(q, msgs[(r, b, q)], part)
                for ik, _, _ in layout(r, b, me):
                    if ik in got:
                        xs.put(ik, r, got[ik])

            def ready(pieces, r=r):
                got = {(i, key): g.float() for (_, i, key), g in
                       pieces.items()}
                hand(bucket_of[next(iter(got))], got)

            aliases, sink = {}, _Sink(ready)
            with torch.enable_grad():
                objs = self._objectives({r: self._replica_terms(
                    aliases, sink, r, rows[r], True, self.dropout_key(r))})
            if r == 1:
                C.count("dp", sum(a.numel() * 4 for a in aliases.values()))
            tensors = {(i, key): a for (_, i, key), a in aliases.items()}
            ((loss, _),) = objs.values()
            with torch.enable_grad():
                OV.BucketReducer(
                    self._plan, None, self.home(r),
                    on_bucket=lambda b, keys, terms, hand=hand: hand(
                        b, dict(zip(keys, terms)))).backward(loss, tensors)
            for keys in list(sink.uses):
                # gathered but never reached by the loss (pos_emb under
                # RoPE, norm biases under RMSNorm): zeros, as autograd
                # gives the local pieces
                del sink.uses[keys]
                ready({k: sink[k] if k in sink else torch.zeros(
                    shape_of(k[1]), device=self.home(r))
                       for k in keys if not D.is_local(
                           self._dev[self._site(k[2], None)])})
            objs_all.update({c: v.detach() for c, (_, v) in objs.items()})
            del objs, aliases, sink
        cells = {self._dev[c] for c in self._local}
        for d in {self.home(r) for r in self._reps}:
            for into in cells:
                OV.join(d, into)
        red = [dict() for _ in self._pspecs]
        for (i, key), g in xs.totals().items():
            red[i][(key, None)] = g
        total = self._total(objs_all)
        n = self.dp * self.sp
        if n > 1:
            for blocks in red:
                for g in blocks.values():
                    g.mul_(1.0 / n)
        return total, self._finish_sums(red)

    # --------------------------------------------------------- update

    def _views(self, red):
        """The canonical parameter and gradient trees with each leaf as
        its distinct blocks (`Slices`, rank order; a one-block leaf as
        itself): what the health pack and the clipping norm read."""
        def elsewhere(site):
            # across processes, a block another process holds
            return Elsewhere(D.owner(self._dev[site]), self.device)

        def params_leaf(i):
            spec = self._pspecs[i]
            keys = sorted({self._key(spec, self._coord(c))
                           for c in self.coords})
            m = self._cols[0] if self._rep(i) else None
            sites = [self._site(k, m) for k in keys]
            blocks = [self._shards[c][i] if c in self._shards
                      else elsewhere(c) for c in sites]
            return blocks[0] if len(blocks) == 1 else Slices(blocks)

        def grad_leaf(i):
            blocks = (list(red[i].values()) if not self._remote else
                      [elsewhere(site) if g is None else g for site, g in
                       self._sum_blocks(i, red[i])])
            return blocks[0] if len(blocks) == 1 else Slices(blocks)

        n = len(self._pspecs)
        return (unflatten(self._template, [params_leaf(i) for i in range(n)]),
                unflatten(self._template, [grad_leaf(i) for i in range(n)]))

    def _clip(self, red) -> None:
        """Global-norm clipping of the reduced gradient, as
        `optim.clip_by_global_norm`: each leaf's squares summed over its
        blocks in rank order, the leaves in tree order; every block
        scaled in place."""
        clip = self.optimizer.grad_clip
        if clip is None:
            return
        total = None
        for i, blocks in enumerate(red):
            sq = None
            for site, g in self._sum_blocks(i, blocks):
                # the sum's owner squares it
                sq = D.add_term(sq, None if g is None else torch.sum(
                    torch.square(g.float())), self._dev[site], self.device,
                    everywhere=True)
            total = sq if total is None else total + sq
        scale = torch.clamp(clip / (torch.sqrt(total) + 1e-12), max=1.0)
        for blocks in red:
            for g in blocks.values():
                g.mul_(scale.to(g.device, g.dtype))

    def _sum_blocks(self, i: int, blocks: dict) -> list:
        """(sum's cell, block) of leaf i's reduced gradient, every key of
        the grid in key order (a replicated leaf's first model column):
        the block where this process holds that sum, else None."""
        us = self._uspecs[i]
        m = self._cols[0] if self._rep(i) else None
        keys = sorted({self._key(us, self._coord(c)) for c in self.coords})
        return [(self._site(k, m), blocks[k]
                 if D.is_local(self._dev[self._site(k, m)]) else None)
                for k in keys]

    def _cell_grads(self, red, c) -> list:
        coord, dev = self._coord(c), self._dev[c]
        return [red[i][self._key(us, coord)].to(dev)
                for i, us in enumerate(self._uspecs)]

    @torch.no_grad()
    def _update(self, red):
        """One optimizer step from the reduced gradient; returns the
        health pack (None with health "off")."""
        opt = self.optimizer
        pack = ok = None
        if self.health != "off":
            pview, gview = self._views(red)
            pack = grad_health(pview, gview)
            old = snapshot(pview)
            if self.health == "guard":
                ok = pack["nonfinite"] == 0
        self._clip(red)
        if self._per_cell_update():
            for c in self._local:
                params = unflatten(self._template, [
                    self._piece(x, i, c)
                    for i, x in enumerate(self._shards[c])])
                grads = unflatten(self._template, self._cell_grads(red, c))
                args = (params, grads, self._states[c])
                _, self._states[c] = (
                    opt.step(*args, clip=False) if ok is None
                    else opt.guarded_step(*args, ok, clip=False))
            self._all_gather()
        else:
            self._gathered_update(red, ok)
        if pack is None:
            return None
        pview, _ = self._views(red)
        if ok is None:
            return update_health(pack, old, pview)
        return update_health(pack, old, pview, skipped=(~ok).to(torch.int32))

    def _per_cell_update(self) -> bool:
        """Whether every cell updates its own blocks (an elementwise
        optimizer), or the update runs on the gathered leaves."""
        return self.optimizer.elementwise

    def _all_gather(self) -> None:
        """ZeRO: every cell takes the other dp cells' new slices of each
        leaf it holds whole on the dp axis."""
        if not self.zero or self.dp == 1:
            return
        # the all-gather's operand: the first dp row's new slices
        C.count_tensors("dp", [
            self._shards[c][i].chunk(self.dp, us.padded(len(
                self._shapes[i])).index("dp"))[0]
            for c in self._local if c[0] == 0
            for i, (us, ps) in enumerate(zip(self._uspecs, self._pspecs))
            if us is not ps])
        if self._remote:
            self._all_gather_across()
            return
        for i, (us, ps) in enumerate(zip(self._uspecs, self._pspecs)):
            if us is ps:
                continue
            z = us.padded(len(self._shapes[i])).index("dp")
            for c in self.coords:
                mine = self._shards[c][i]
                for j in range(self.dp):
                    if j != c[0]:
                        src = self._shards[(j,) + c[1:]][i]
                        mine.chunk(self.dp, z)[j].copy_(
                            src.chunk(self.dp, z)[j].to(mine.device))

    def _all_gather_across(self) -> None:
        """`_all_gather` over processes: for every cell, each other dp
        cell's new slices (all leaves packed in one message) moved in
        from that cell, in the grid's order."""
        sliced = [(i, us.padded(len(self._shapes[i])).index("dp"))
                  for i, (us, ps) in enumerate(zip(self._uspecs,
                                                   self._pspecs))
                  if us is not ps]
        if not sliced:
            return
        for c in self.coords:
            for j in range(self.dp):
                if j == c[0]:
                    continue
                src = (j,) + c[1:]
                a, b = self._dev[src], self._dev[c]
                if not (D.is_local(a) or D.is_local(b)):
                    continue
                x = (D.pack([self._shards[src][i].chunk(self.dp, z)[j]
                             for i, z in sliced]) if D.is_local(a) else None)
                got = D.move(x, a, b, "sum")
                if not D.is_local(b):
                    continue
                parts = D.unpack(got, [self._shards[c][i].chunk(
                    self.dp, z)[j] for i, z in sliced])
                for (i, z), part in zip(sliced, parts):
                    self._shards[c][i].chunk(self.dp, z)[j].copy_(part)

    def _gathered_update(self, red, ok) -> None:
        """A non-elementwise optimizer's (Adafactor's) step: the canonical
        parameters, gradient and state gathered onto the first cell,
        updated there, and cut back into every cell."""
        opt = self.optimizer
        params = self._gather_params()
        grads = self._canonical_grads(red)
        state = self.opt_state
        if ok is None:
            _, state = opt.step(params, grads, state, clip=False)
        else:
            _, state = opt.guarded_step(params, grads, state, ok, clip=False)
        del grads
        self._install_params(params)
        self.set_opt_state(state)

    def _canonical_grads(self, red):
        """The reduced gradient as a tree in the engine's layout on the
        first cell."""
        def block(i, us, k):
            key = self._key(us, k)
            src = self._dev[self._site(key, self._cols[0] if self._rep(i)
                                       else None)]
            return D.share(red[i][key] if D.is_local(src) else None, src,
                           self.device)

        return unflatten(self._template, [
            assemble(us, len(self._shapes[i]), self.sizes,
                     lambda k, i=i, us=us: block(i, us, k), self.device)
            for i, us in enumerate(self._uspecs)])

    # ----------------------------------------------------------- steps

    def loss_and_grads(self, tokens, targets):
        """(loss, gradient tree) of one (B, T) batch at the current
        parameters, without updating them: the reduced gradient in the
        canonical layout."""
        loss, red = self._reduced(tokens, targets)
        return loss, self._canonical(self._canonical_grads(red))

    def _split_step(self) -> bool:
        """Whether the reference runs this step as two programs (grads,
        then the sharded update) and so traces "grads" and "update"
        spans inside "step": under ZeRO."""
        return self.zero

    def _step_attrs(self) -> dict:
        """Extra attributes of the reference's "step" span."""
        return {}

    def train_batch_async(self, tokens, targets) -> torch.Tensor:
        """One optimizer step on a (B, T) int token batch; returns the
        loss before the update as a 0-d tensor on the engine's device,
        unread: the caller reads it (`float`) only where it needs the
        value, so the host can queue the next step behind this one."""
        tr = tracer()
        step = self._step_count
        mark = C.mark()
        with tr.span("step", step=step, **self._step_attrs()) as sp:
            if self._split_step():
                with tr.span("grads", step=step) as g:
                    loss, red = self._reduced(tokens, targets)
                    g.fence(loss)
                with tr.span("update", step=step) as u:
                    pack = self._update(red)
                    del red
                    if pack is not None:
                        note_step(self, pack)
                    u.fence(self._states)
            else:
                loss, red = self._reduced(tokens, targets)
                pack = self._update(red)
                del red
                if pack is not None:
                    note_step(self, pack)
            sp.fence(loss)
        self._traffic = C.since(mark)
        self._step_count += 1
        return loss

    def train_batch(self, tokens, targets) -> float:
        """One optimizer step on a (B, T) int token batch; returns the
        loss before the update (`train_batch_async`, read)."""
        return float(self.train_batch_async(tokens, targets))

    _traffic = None

    def telemetry_traffic(self) -> dict:
        """The collective bytes and calls per grid axis of the last step
        (`telemetry.collectives`; no traffic before the first)."""
        return self._traffic or C.empty()

    def health_snapshot(self) -> dict | None:
        """The last step's health pack and the cumulative counters as a
        host dict (call at log points); None before the first step or
        with health='off'."""
        return engine_snapshot(self)

    @torch.no_grad()
    def eval_loss(self, tokens, targets) -> float:
        """The loss without label smoothing or dropout (the MoE terms
        included, as the reference's `T.loss(train=False)`), no
        update."""
        rows = self._rows(tokens, targets)
        terms = {r: self._replica_terms({}, {}, r, rows[r], False, None)
                 for r in self._reps}
        return float(self._total({c: v for c, (_, v) in
                                  self._objectives(terms).items()}))

    @torch.no_grad()
    def logits(self, tokens) -> torch.Tensor:
        """(B, T, vocab) logits on the first cell (a tp-sharded head's
        vocabulary blocks concatenated in rank order), each block shared
        by the process that computed it."""
        cfg = self.cfg
        name = "tok_emb" if cfg.tie_embeddings else "head"
        cut = self.tp > 1 and not cfg.tie_embeddings
        rows = self._rows(tokens)
        mine = {}
        for r in self._reps:
            cs, hid, _, _, _ = self._replica_terms({}, {}, r, rows[r], False,
                                                   None)
            for c, h in zip(cs, hid):
                if cut or self._mi is None or c[self._mi] == 0:
                    hp = self._materialize(self._top_src({}, {}, c, (name,)))
                    mine[c] = T.head_logits(hp, h, cfg)
        outs = []
        for r in range(self.dp):
            tiles = []
            for s in range(self.sp):
                cells = [self._cell(r, s, m)
                         for m in range(self.tp if cut else 1)]
                tiles.append(torch.cat([D.share(mine.get(c), self._dev[c],
                                                self.device)
                                        for c in cells], dim=-1))
            outs.append(torch.cat(tiles, dim=1))
        return torch.cat(outs)

    @torch.no_grad()
    def router_stats(self, tokens) -> dict | None:
        """MoE routing on one batch, as the reference reports it: the
        per-expert share of the (token, k) assignments (pre-drop) and
        the share dropped for capacity, averaged over the layers and the
        replicas (each replica's from its first cell, which routes its
        whole rows). None for a dense config. One extra forward: call it
        at log points only."""
        if self.cfg.n_experts == 0:
            return None
        rows = self._rows(tokens)
        mine = {}
        for r in self._reps:
            cs, _, _, moe, _ = self._replica_terms({}, {}, r, rows[r], False,
                                                   None)
            if cs[0] == self._cell(r):
                m = moe[0]
                mine[r] = (sum(st["load"] for _, _, st in m) / len(m),
                           sum(st["drop_fraction"] for _, _, st in m)
                           / len(m))
        load = drop = None
        for r in range(self.dp):
            src = self.home(r)
            lr, dr = (D.share(mine[r][k] if r in mine else None, src,
                              self.device) for k in range(2))
            load = lr if load is None else load + lr
            drop = dr if drop is None else drop + dr
        load, drop = load / self.dp, drop / self.dp
        return {"expert_load": [round(float(x), 4) for x in load],
                "drop_fraction": round(float(drop), 4)}

    # -------------------------------------------- checkpoint interface

    @torch.no_grad()
    def _gather_params(self):
        """The parameter tree in the engine's layout, gathered from the
        cells onto the first cell (a copy)."""
        return gather({c: unflatten(self._template, x)
                       for c, x in self._shards.items()},
                      self.specs, self.mesh, self.device)

    def get_canonical_params(self):
        """The canonical (one-device) parameter tree, gathered from the
        cells onto the first cell (a copy)."""
        return self._canonical(self._gather_params())

    def resident(self) -> dict:
        """The trees this engine keeps resident, for the memory
        observatory's owners: {"params": every replica's (or cell's)
        parameters, "opt_state": every optimizer state it holds}."""
        return {"params": self._shards, "opt_state": self._states}

    @property
    def params(self):
        """The canonical parameter tree (a gathered copy; assigning a
        tree installs it in every cell)."""
        return self.get_canonical_params()

    @params.setter
    def params(self, tree):
        self.set_canonical_params(tree)

    @property
    def layout_params(self):
        """The parameter tree in the engine's own layout (the reference
        engine's `params`: the pipeline's blocks stacked), a gathered
        copy; assigning a tree in that layout installs it in every
        cell."""
        return self._gather_params()

    @layout_params.setter
    def layout_params(self, tree):
        self._install_params(tree)

    def set_canonical_params(self, params):
        """Install a canonical tree of tensors or numpy arrays (the JAX
        package's layout, a checkpoint's) in every cell, each cell its
        blocks."""
        self._install_params(self._layout(params))

    @torch.no_grad()
    def _install_params(self, params):
        """`set_canonical_params` of a tree already in the engine's
        layout."""
        flat = [x.detach() if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(x))
                for x in _in_order(self._template, params)]
        for c in self._local:
            coord = self._coord(c)
            for mine, x, s in zip(self._shards[c], flat, self._pspecs):
                mine.copy_(cut(x, s, self.sizes, coord).to(mine.device))

    @property
    def opt_state(self):
        """The optimizer state in the engine's layout (the canonical one
        but for the pipeline's stacked blocks), gathered from the cells
        onto the first cell (a copy)."""
        return gather(self._states, self._sspecs, self.mesh, self.device)

    @torch.no_grad()
    def set_opt_state(self, state):
        """Install an optimizer state in the engine's layout (the JAX
        package's numpy leaves with `t` a 0-d array, as a checkpoint
        holds it, or this package's): every cell's blocks copied from
        it, `t` a Python int, in the current state's key order."""
        for c in self._local:
            coord = self._coord(c)

            def leaf(mine, x, s):
                if not isinstance(mine, torch.Tensor):
                    return int(np.asarray(x)) if isinstance(mine, int) else x
                src = x if isinstance(x, torch.Tensor) else torch.from_numpy(
                    np.ascontiguousarray(x))
                mine.copy_(cut(src, s, self.sizes, coord).to(mine.device))
                return mine

            self._states[c] = map_tree(leaf, self._states[c], state,
                                       self._sspecs)

    def cell_bytes(self) -> dict:
        """{cell coordinate: (parameter bytes, optimizer-state bytes)}
        that each of this process's cells holds."""
        def nbytes(xs):
            return sum(x.numel() * x.element_size() for x in xs
                       if isinstance(x, torch.Tensor))

        return {c: (nbytes(self._shards[c]), nbytes(leaves(self._states[c])))
                for c in self._local}


def _in_order(template, tree) -> list:
    """`tree`'s leaves in `template`'s key order (a checkpoint's dicts
    come back key-sorted)."""
    out = []
    map_tree(lambda _, x: out.append(x), template, tree)
    return out
