"""The GSPMD engine family's base — counterpart of
`shallowspeed_tpu/parallel/gspmd.py::GSPMDEngine` — and its placement
machinery.

The reference picks a mesh, annotates each parameter leaf with a
`PartitionSpec`, jits one step and lets XLA insert the collectives. One
process drives a `parallel.mesh.Grid` of devices here (every cell the
card, or the CPU in the tests), so the placement is explicit:

- **Placement.** `P` is the spec: per dimension an axis name or None.
  `shard` cuts a canonical (one-device) tree into every cell's tree —
  cell c holds, of each leaf, the block its spec names (a replicated
  leaf is a copy per cell) — and `gather` is its inverse. The canonical
  tree is the checkpoint's: "placement, not structure".
- **Replicas.** Replica r trains on rows [r B/dp, (r+1) B/dp) of each
  batch on its home cell (dp index r, every other index 0). It reads
  each leaf as the block its home row of cells holds: the tensor-
  parallel shards of cells (r, .., t), the expert shards of cells (r,
  .., e), and under FSDP the dp pieces of every replica's cell,
  gathered in rank order just in time for each block and freed after
  it (a saved-tensor hook re-gathers what the backward needs). The
  replica's forward and backward run under torch autograd on detached
  aliases of those blocks, so each replica's gradient lands apart.
- **Sequence parallelism** (an 'sp' axis) lives inside attention, as in
  `parallel.context`: every other layer is position-wise, the replica's
  whole sequence runs on its home cell and `ops.attention.
  allgather_attention` cuts the queries into sp tiles, one per cell,
  each against the all-gathered K/V. The replica's loss is the sum of
  its tiles' mean losses; each tile draws dropout masks from its own
  key (`dropout_key`).
- **The reduction.** The replicas' f32 gradients are summed in rank
  order, block by block — a dp-sharded (FSDP) block's gradient from
  every replica reduce-scattered onto the cell that owns it — and
  scaled by 1 / (dp sp). MoE configs at dp > 1 run every replica's
  forward before one backward: the Switch balance loss is not linear in
  the shards, so its f and P are summed over the replicas first
  (`ops.moe.balance_terms`).
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

Launched as several processes (`distributed`), only the LM pipeline
(`supports_processes`) takes a grid that spans them: each process
`shard`s the canonical tree into its own cells only, `gather` (and so
`get_canonical_params` / `opt_state`) is collective, each block coming
from the process that holds it, and the update runs on this process's
cells. The other engines of the family raise `NotPorted` there.

Comm overlap (`overlap=`) is refused with the reference's `ValueError`
(`supports_overlap = False`): the reference's GSPMD programs have only
compiler-inserted collectives. `fsdp.FSDPEngine` sets it True and takes
the overlapped step here: replica r >= 1's backward adds each bucket
into the sums from a hook (`parallel.overlap.BucketReducer`; each
dp-sharded leaf's pieces reduce-scattered onto their owner cells, the
replicated leaves in size-targeted buckets), and each block's just-in-
time gather for the next block is issued ahead, on the side stream on a
GPU, while the current block computes.
"""

from __future__ import annotations

import contextlib
from functools import partial

import numpy as np
import torch

from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import moe as M
from shallowspeed_tpu_torch.ops.attention import allgather_attention, attention
from shallowspeed_tpu_torch.ops.dropout import dropout as _dropout
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.optim import Adafactor
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.parallel.mesh import Grid, make_grid
from shallowspeed_tpu_torch.parallel.zero import Slices, zero2_grad_dim
from shallowspeed_tpu_torch.telemetry import collectives as C
from shallowspeed_tpu_torch.telemetry.health import (check_mode,
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


class _Pieces:
    """One leaf's dp pieces (an FSDP leaf, in rank order), gathered along
    `dim` onto `device` where a block reads the leaf."""

    __slots__ = ("parts", "dim", "device")

    def __init__(self, parts, dim, device):
        self.parts = parts
        self.dim = dim
        self.device = device

    def gather(self):
        C.count_tensors("dp", self.parts[0])   # the all-gather's operand
        return torch.cat([p.to(self.device) for p in self.parts],
                         dim=self.dim)


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

    # whether a grid may span processes (the LM pipeline's)
    supports_processes = False

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
        if self._remote and not self.supports_processes:
            D.refuse(f"{type(self).__name__} (the GSPMD engines)")
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
        self._attn_fns = [self._substrates(r) for r in range(self.dp)]

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

    def _src_cell(self, r: int, key: tuple) -> tuple:
        """The cell replica r reads block `key` from: the key's indices,
        dp = r where the key has no dp index, every other axis 0."""
        k = dict(key)
        return tuple(k.get(a, r if a == "dp" else 0) for a in self.names)

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

    def _substrates(self, r: int) -> list:
        """Replica r's attention per model index: the plain attention at
        sp 1, the K/V all-gather over the sp cells above."""
        w = self.cfg.attn_window
        fns = []
        for m in range(self.tp):
            if self.sp == 1:
                fns.append(partial(attention, causal=True, window=w))
                continue
            cells = [self._dev[self._cell(r, s, m)] for s in range(self.sp)]
            fns.append(partial(allgather_attention, devices=cells,
                               causal=True, window=w))
        return fns if self.tp > 1 else fns[0]

    def _cell(self, r, s=0, m=0) -> tuple:
        k = {"dp": r, "sp": s, self.model_axis: m}
        return tuple(k.get(a, 0) for a in self.names)

    def home(self, r: int):
        """Replica r's home device."""
        return self._dev[self._cell(r)]

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

    def _rows(self, *batches) -> list:
        """Each replica's rows of every (B, T) batch, on its home cell."""
        ts = [self.place(b) for b in batches]
        b, t = ts[0].shape
        if b % self.dp:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"dp={self.dp}")
        if t % self.sp:
            raise ValueError(f"sequence length {t} does not split over "
                             f"sp={self.sp}")
        return [tuple(x.chunk(self.dp)[r].to(self.home(r)) for x in ts)
                for r in range(self.dp)]

    def dropout_key(self, replica: int = 0):
        """The dropout key of this step on `replica` (None when the config
        has no dropout): one key a step, a pure function of (seed, step,
        tile) as `parallel.context` derives it, so a resumed run draws
        the same masks; tile 0 keys (seed, step) as one device does, and
        at sp > 1 a tuple of the replica's sp tile keys."""
        if self.cfg.dropout == 0.0 and self.cfg.attn_dropout == 0.0:
            return None
        keys = tuple(fold_key(self.seed, self._step_count, 0,
                              *([tile] if tile else []))
                     for tile in range(replica * self.sp,
                                       (replica + 1) * self.sp))
        return keys[0] if self.sp == 1 else keys

    def _alias(self, aliases: dict, r: int, i: int, key: tuple):
        """Replica r's compute leaf for block `key` of leaf i: a detached
        alias of the cell's block (its gradient lands on the alias)."""
        a = aliases.get((r, i, key))
        if a is None:
            c = self._src_cell(r, key)
            a = self._shards[c][i].detach().requires_grad_(True)
            aliases[(r, i, key)] = a
        return a

    def _src(self, aliases, r: int, i: int, m: int = 0):
        """What replica r's block reads of leaf i at model index m: the
        alias of the block its home row holds, or under FSDP the dp
        pieces to gather."""
        spec = self._pspecs[i]
        coord = {self.model_axis: m}
        if "dp" not in spec.axes():
            return self._alias(aliases, r, i, self._key(spec, coord))
        pieces = [self._alias(aliases, r, i, self._key(spec, {**coord,
                                                               "dp": j}))
                  for j in range(self.dp)]
        return _Pieces(pieces, spec.padded(len(self._shapes[i])).index("dp"),
                       self.home(r))

    def _block_src(self, aliases, r: int, i: int):
        """Block i's tree as replica r's compute reads it: at tp > 1 one
        tree per tp cell (replicated leaves from the home cell), at ep >
        1 the MoE experts as a list of the ep cells' shards."""
        idx = self._index["blocks"][i]
        if self.tp > 1:
            return [map_tree(lambda j, m=m: self._src(aliases, r, j, m), idx)
                    for m in range(self.tp)]
        src = map_tree(lambda j: self._src(aliases, r, j), idx)
        if self.ep > 1 and "moe" in idx:
            moe = idx["moe"]
            src["moe"] = {"gate": src["moe"]["gate"], "experts": [
                {k: self._src(aliases, r, moe[k], e)
                 for k in ("wi", "bi", "wo", "bo")}
                for e in range(self.ep)]}
        return src

    def _top_src(self, aliases, r: int, keys, m: int = 0):
        return {k: map_tree(lambda j: self._src(aliases, r, j, m),
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

    def _run_block(self, src, x, cfg, pos, attn_fn, key):
        return self._block_on(self._materialize(src), x, cfg, pos, attn_fn,
                              key)

    def _block_on(self, p, x, cfg, pos, attn_fn, key):
        """One block on its materialized tree `p`."""
        if self.tp > 1:
            from shallowspeed_tpu_torch.parallel.tensor import tp_block

            return tp_block(p, x, cfg, pos, attn_fn, key)
        return T._block(p, x, cfg, pos, attn_fn, key)

    def _gather_ahead(self, src, device):
        """`_materialize(src)` issued ahead of its block, on `device`'s
        side stream on a GPU (it waits for the main stream first);
        `_take` hands it to the main stream."""
        stream = OV.side_stream(device)
        if stream is None:
            return self._materialize(src), None
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            return self._materialize(src), stream

    @staticmethod
    def _take(ahead):
        """The tree `_gather_ahead` issued, the main stream waiting for
        it and each of its tensors marked as used there (the allocator
        keeps them until the main stream is done with them)."""
        tree, stream = ahead
        if stream is not None:
            main = torch.cuda.current_stream(stream.device)
            main.wait_stream(stream)
            for t in leaves(tree):
                t.record_stream(main)
        return tree

    def _forward(self, aliases, r: int, tok, key=None):
        """Replica r's final-norm hidden states (B/dp, T, d) and its MoE
        terms [(aux, z, stats) per MoE layer], the blocks as
        `transformer.forward_with_aux` runs them."""
        cfg = self.cfg
        t = tok.shape[1]
        if t > cfg.max_seq:
            raise ValueError(f"sequence of {t} exceeds max_seq={cfg.max_seq}")
        emb = self._materialize(self._top_src(aliases, r,
                                              ("tok_emb", "pos_emb")))
        pos = torch.arange(t, device=tok.device)
        x = emb["tok_emb"][tok]
        if not cfg.rope:
            x = x + emb["pos_emb"][pos]
        del emb
        if key is not None:
            x = _dropout(x, cfg.dropout, fold_key(key, cfg.n_layers))
        remat = cfg.remat and torch.is_grad_enabled()
        block = (T._remat_block(cfg, self._run_block) if remat
                 else self._run_block)
        # the overlapped FSDP step gathers block i + 1 while block i
        # computes (not under remat: its blocks gather inside the
        # checkpoint, again in the backward)
        ahead = None
        if self._fsdp and self.overlap is not None and not remat:
            ahead = self._gather_ahead(self._block_src(aliases, r, 0),
                                       self.home(r))
        moe = []
        for i in range(cfg.n_layers):
            k = None if key is None else fold_key(key, i)
            if ahead is None:
                x, (aux, z, st) = block(self._block_src(aliases, r, i), x,
                                        cfg, pos, self._attn_fns[r], k)
            else:
                p = self._take(ahead)
                ahead = (self._gather_ahead(self._block_src(aliases, r,
                                                            i + 1),
                                            self.home(r))
                         if i + 1 < cfg.n_layers else None)
                x, (aux, z, st) = self._block_on(p, x, cfg, pos,
                                                 self._attn_fns[r], k)
                del p
            if st is not None:
                moe.append((aux, z, st))
        ln = self._materialize(self._top_src(aliases, r, ("ln_f",)))
        return T._norm(ln["ln_f"], x, cfg), moe

    def _token_loss(self, aliases, r: int, hid, tgt, train: bool):
        """Replica r's token loss: the sum of its sp tiles' mean losses,
        in tile order (`transformer.token_loss`, or
        `chunked_token_loss` with cfg.xent_chunk; vocabulary-parallel
        under a tp-sharded head)."""
        cfg = self.cfg
        name = "tok_emb" if cfg.tie_embeddings else "head"
        if self.tp > 1 and not cfg.tie_embeddings:
            from shallowspeed_tpu_torch.parallel.tensor import (
                vocab_parallel_loss)

            heads = [self._materialize(self._top_src(aliases, r, (name,),
                                                     m))
                     for m in range(self.tp)]
            fn = partial(vocab_parallel_loss, heads, cfg=cfg, train=train)
        elif cfg.xent_chunk > 0:
            hp = self._materialize(self._top_src(aliases, r, (name,)),
                                   cast=False)
            fn = partial(T.chunked_token_loss, hp, cfg=cfg, train=train)
        else:
            hp = self._materialize(self._top_src(aliases, r, (name,)))

            def fn(h, g):
                return T.token_loss(T.head_logits(hp, h, cfg), g, cfg, train)
        if self.sp == 1:
            return fn(hid, tgt)
        total = None
        for h, g in zip(hid.chunk(self.sp, dim=1), tgt.chunk(self.sp, dim=1)):
            part = fn(h, g)
            total = part if total is None else total + part
        return total

    def _replica_terms(self, aliases, r, tok, tgt, train, key):
        """(token loss, MoE terms, balance terms) of replica r."""
        hooks = (torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
                 if self._fsdp and torch.is_grad_enabled()
                 else contextlib.nullcontext())
        with hooks, M.balance_terms() as bal:
            hid, moe = self._forward(aliases, r, tok, key)
            tl = self._token_loss(aliases, r, hid, tgt, train)
        return tl, moe, list(bal)

    def _objective(self, terms: list):
        """The (dp sp)-scaled objective of the replicas' `terms` (all of
        them, or one replica's when they do not couple): the token losses
        summed in rank order, plus the MoE balance and z-losses at the
        config's weights, in `transformer.loss`'s order. At dp > 1 the
        balance loss is the global one: each layer's f and P summed over
        the replicas (rank order) and averaged before their product."""
        cfg = self.cfg
        n = self.dp * self.sp
        total = None
        for tl, _, _ in terms:
            total = tl if total is None else total + tl
        aux, z = 0.0, 0.0
        if terms[0][1]:
            if self.dp == 1:
                for a, _, _ in terms[0][1]:
                    aux = aux + a
            else:
                e = cfg.n_experts
                for layer in range(len(terms[0][2])):
                    f = p = None
                    for _, _, bal in terms:
                        fr, pr = bal[layer]
                        fr, pr = fr.to(self.device), pr.to(self.device)
                        f = fr if f is None else f + fr
                        p = pr if p is None else p + pr
                    aux = aux + e * torch.sum((f / self.dp) * (p / self.dp))
            for _, moe, _ in terms:
                zr = 0.0
                for _, zl, _ in moe:
                    zr = zr + zl
                z = zr if isinstance(z, float) else z + zr.to(self.device)
            if self.dp > 1:
                z = z / self.dp
        total = total + (n * (cfg.moe_aux_weight * aux) if n > 1
                         else cfg.moe_aux_weight * aux)
        if cfg.moe_z_weight > 0.0:
            total = total + (n * (cfg.moe_z_weight * z) if n > 1
                             else cfg.moe_z_weight * z)
        return total

    def _coupled(self) -> bool:
        return self.cfg.n_experts > 0 and self.dp > 1

    def _reduced(self, tokens, targets):
        """(loss, reduced gradient): `red[i]` {update block key: f32
        gradient} of every leaf i, the replicas' partials summed in rank
        order and scaled by 1 / (dp sp)."""
        rows = self._rows(tokens, targets)
        red = [dict() for _ in self._pspecs]
        losses = []

        def reduce(aliases, grads):
            for (r, i, key), g in zip(aliases, grads):
                g = g.float()
                us, ps = self._uspecs[i], self._pspecs[i]
                if us is ps:
                    parts = [(key, g)]
                else:
                    z = us.padded(g.dim()).index("dp")
                    parts = [(tuple(sorted(key + (("dp", j),),
                                           key=lambda kv: self.names.index(
                                               kv[0]))), piece)
                             for j, piece in enumerate(g.chunk(self.dp, z))]
                for u, piece in parts:
                    mine = red[i].get(u)
                    if mine is None:    # a copy: autograd may hand two
                        #                 leaves one tensor
                        red[i][u] = piece.to(
                            self._dev[self._src_cell(0, u)], copy=True)
                    else:
                        mine.add_(piece.to(mine.device))

        def grads_of(loss, aliases):
            with torch.enable_grad():
                return torch.autograd.grad(loss, list(aliases.values()),
                                           allow_unused=True,
                                           materialize_grads=True)

        def count(aliases):
            # the dp sum's operand: replica 1's f32 gradient partial
            nbytes = sum(a.numel() * 4 for (r, _, _), a in aliases.items()
                         if r == 1)
            if nbytes:
                C.count("dp", nbytes)

        if self._coupled():
            aliases, terms = {}, []
            with torch.enable_grad():
                for r, (tok, tgt) in enumerate(rows):
                    terms.append(self._replica_terms(
                        aliases, r, tok, tgt, True, self.dropout_key(r)))
                loss = self._objective(terms)
            del terms
            count(aliases)
            reduce(list(aliases), grads_of(loss, aliases))
            losses.append(loss.detach())
        else:
            for r, (tok, tgt) in enumerate(rows):
                aliases = {}
                with torch.enable_grad():
                    loss = self._objective([self._replica_terms(
                        aliases, r, tok, tgt, True, self.dropout_key(r))])
                count(aliases)
                if r and self._plan is not None:
                    self._reduce_in_backward(r, loss, aliases, red)
                else:
                    reduce(list(aliases), grads_of(loss, aliases))
                losses.append(loss.detach().to(self.device))
                del loss, aliases
            if self._plan is not None:
                cells = {self._dev[c] for c in self.coords}
                for d in {self.home(r) for r in range(1, self.dp)}:
                    for into in cells:
                        OV.join(d, into)
        total = losses[0]
        for x in losses[1:]:
            total = total + x
        n = self.dp * self.sp
        if n > 1:
            total = total / n
            for blocks in red:
                for g in blocks.values():
                    g.mul_(1.0 / n)
        # every leaf's blocks in rank order (the keys sort row-major)
        return total, [dict(sorted(b.items())) for b in red]

    def _reduce_in_backward(self, r: int, loss, aliases, red) -> None:
        """Replica r's backward with the overlapped reduction: each bucket
        of `_plan` ((leaf, block key) pairs) added into `red` from a hook
        the moment its gradients are final, on r's home cell's side
        stream on a GPU (the caller joins it)."""
        def add(k, g):
            i, key = k
            mine = red[i][key]
            mine.add_(g.to(mine.device))

        tensors = {(i, key): a for (_, i, key), a in aliases.items()}
        with torch.enable_grad():
            OV.BucketReducer(self._plan, add, self.home(r)).backward(
                loss, tensors)

    # --------------------------------------------------------- update

    def _views(self, red):
        """The canonical parameter and gradient trees with each leaf as
        its distinct blocks (`Slices`, rank order; a one-block leaf as
        itself): what the health pack and the clipping norm read."""
        def params_leaf(i):
            spec = self._pspecs[i]
            keys = sorted({self._key(spec, self._coord(c))
                           for c in self.coords})
            blocks = [self._shards[self._src_cell(0, k)][i] for k in keys]
            return blocks[0] if len(blocks) == 1 else Slices(blocks)

        def grad_leaf(i):
            blocks = list(red[i].values())
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
            for key, g in self._sum_blocks(i, blocks):
                # the sum's owner squares it
                sq = D.add_term(sq, None if g is None else torch.sum(
                    torch.square(g.float())), self._dev[self._src_cell(
                        0, key)], self.device, everywhere=True)
            total = sq if total is None else total + sq
        scale = torch.clamp(clip / (torch.sqrt(total) + 1e-12), max=1.0)
        for blocks in red:
            for g in blocks.values():
                g.mul_(scale.to(g.device, g.dtype))

    def _sum_blocks(self, i: int, blocks: dict) -> list:
        """(key, block) of leaf i's reduced gradient, every key of the
        grid in key order: the block where this process holds the sum,
        else None."""
        us = self._uspecs[i]
        keys = sorted({self._key(us, self._coord(c)) for c in self.coords})
        return [(k, blocks[k] if D.is_local(self._dev[self._src_cell(
            0, k)]) else None) for k in keys]

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
            src = self._dev[self._src_cell(0, key)]
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

    def train_batch(self, tokens, targets) -> float:
        """One optimizer step on a (B, T) int token batch; returns the
        loss before the update."""
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
        return float(loss)

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
        terms = [self._replica_terms({}, r, tok, tgt, False, None)
                 for r, (tok, tgt) in enumerate(self._rows(tokens, targets))]
        if self._coupled():
            total = self._objective(terms)
        else:
            total = None
            for t in terms:
                x = self._objective([t]).to(self.device)
                total = x if total is None else total + x
        n = self.dp * self.sp
        return float(total / n if n > 1 else total)

    @torch.no_grad()
    def logits(self, tokens) -> torch.Tensor:
        """(B, T, vocab) logits on the first cell (a tp-sharded head's
        vocabulary blocks concatenated in rank order)."""
        cfg = self.cfg
        name = "tok_emb" if cfg.tie_embeddings else "head"
        n = 1 if cfg.tie_embeddings else self.tp
        outs = []
        for r, (tok,) in enumerate(self._rows(tokens)):
            hid, _ = self._forward({}, r, tok)
            parts = []
            for m in range(n):
                hp = self._materialize(self._top_src({}, r, (name,), m))
                dev = next(iter(leaves(hp))).device
                parts.append(T.head_logits(hp, hid.to(dev), cfg).to(
                    self.device))
            outs.append(torch.cat(parts, dim=-1))
        return torch.cat(outs)

    @torch.no_grad()
    def router_stats(self, tokens) -> dict | None:
        """MoE routing on one batch, as the reference reports it: the
        per-expert share of the (token, k) assignments (pre-drop) and
        the share dropped for capacity, averaged over the layers and the
        replicas. None for a dense config. One extra forward: call it at
        log points only."""
        if self.cfg.n_experts == 0:
            return None
        load = drop = None
        for r, (tok,) in enumerate(self._rows(tokens)):
            _, moe = self._forward({}, r, tok)
            lr = sum(st["load"] for _, _, st in moe) / len(moe)
            dr = sum(st["drop_fraction"] for _, _, st in moe) / len(moe)
            load = lr.to(self.device) if load is None else load + lr.to(
                self.device)
            drop = dr.to(self.device) if drop is None else drop + dr.to(
                self.device)
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
