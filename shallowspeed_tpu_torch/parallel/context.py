"""Data x sequence parallel LM trainer — counterpart of
`shallowspeed_tpu/parallel/context.py::ContextParallelEngine`, over a
(dp, sp) grid of cells (`parallel.mesh.make_context_mesh`); on one card
every cell is the card.

- **The reference's layout.** Cell (r, s) holds its own copy of replica
  r's f32 master parameters (`init(cfg, seed)`, the reference's draw)
  and, unless ZeRO shards it, its own optimizer state, and runs the
  whole model on its tile of each batch: rows [r B/dp, (r+1) B/dp),
  columns [s T/sp, (s+1) T/sp), at global positions (the position
  embeddings and RoPE offset by s T/sp, the reference's
  `axis_index("sp") * t_local`). No cell holds another tile's
  activations. The sp cells of a replica run in lockstep, block by
  block (`transformer.tile_losses`), and meet in the attention
  substrate, which takes each cell's q, k and v tile, its tile index
  and its sp group (`ops.attention.SpGroup`). Each tile trains in
  `accum` microbatches of its rows, each a forward and backward under
  torch autograd (the forward casts to `cfg.compute_dtype` as
  `cast_params` does; the gradients come back to the f32 masters
  through that cast). A tile's loss is its mean token loss plus, for a
  MoE config, its own routing's weighted balance and z-losses (each
  tile routes as its own sequence, the reference's per-device MoE), and
  it draws its dropout masks from its own key (`dropout_key`).
- **The reduction.** The cells' f32 gradient partials are summed in
  rank order over (dp, sp) and scaled by 1 / (dp sp accum), the
  reference's `pmean` over ("dp", "sp") of `tile_loss_and_gsum`'s sums;
  the reported loss is the mean of every tile's mean. Dense: every cell
  gets its own copy of the sum (the all-reduce) and applies the same
  update (`step_replicas_with_health`). ZeRO-1: the same sum, with the
  optimizer state sliced over every cell of the grid and the update
  sharded (`parallel.zero.ZeroUpdate`; the sp cells hold gradient
  partials of their own, so they shard it too, as DeepSpeed-Ulysses
  shards over data x sequence parallel ranks). ZeRO-2: each partial is
  reduce-scattered into per-cell slices as it comes, so no cell keeps
  more than its slice of the sum.

`attn` selects the substrate, as in the reference: "ring" (the plain
`attention` at sp 1, `ops.attention.ring_tiles` above; the only
substrate that takes cfg.attn_dropout, and only at sp 1), "ring-flash"
(`ops.flash_attention.ring_flash_tiles`: K1 with f32 chunk outputs, K2,
K3 on every hop), "ulysses" and "ulysses-flash"
(`ops.attention.ulysses_tiles`, the flash kernels on each cell's head
group with "-flash"; heads and kv heads divisible by sp) and "flash"
(`flash_attention`, sp 1 only). On the card the flash substrates launch
the hand-written K1/K2/K3; on the CPU their plain versions run.

With `health` "monitor" or "guard" each step also computes the health
pack on the reduced gradients (each ZeRO-2 leaf's slices summed in rank
order); under "guard" the update is gated on its `nonfinite == 0`
(`guarded_step`). The canonical state a checkpoint holds is cell 0's
parameters and the unsharded optimizer state (`opt_state` gathers ZeRO's
slices), so checkpoints cross between layouts and packages.

Launched as several processes (`distributed`), the grid's cells may lie
in several processes along either axis: each process holds its own
cells and trains on the rows of the replicas they belong to (the batch
a process passes is those replicas' rows, `local_batch` of the global
one: the reference's `local_rows` where dp spans the processes, the
whole batch where sp does). A substrate whose sp group spans processes
moves its K/V blocks or its all-to-all pieces by send / recv pairs
(`distributed.permute`). The cells' partials and losses reach every
process (`distributed.share`) and are summed there in rank order, the
one-process order, so every process holds the one-process sum bit for
bit; ZeRO-2 sends each process only its cells' slices, and ZeRO's
all-gather shares each cell's new slices. `opt_state` under ZeRO is
collective. The health pack there is every process's own (dense,
ZeRO-1: every process holds the whole sum) or summed from the slices'
statistics their owners share (ZeRO-2), so every process takes the
same guard decision. The overlapped reduction there sends each bucket
of a replica's last backward, the moment it closes, to every process
that sums it (`parallel.overlap.CrossSums`: every process under dense
and ZeRO-1, the owners of its cells' slices under ZeRO-2), as a
transfer in flight while the backward runs on; each process posts the
receives of the others' buckets before its backward and adds every
term in rank order when the step joins.

With `overlap` (`parallel.overlap.OverlapConfig`) the reduction moves
into the backward, bucket by bucket (`parallel.overlap.BucketReducer`):
replica r >= 1's last microbatch runs its backward with hooks that add
each bucket's gradients of its cells, in cell order, its earlier
microbatches' sum folded in, into the accumulator (dense, ZeRO-1) or
every cell's slices of it (ZeRO-2, `zero.scatter_add` per leaf) as soon
as the bucket's last leaf is final on every cell of the replica; on a
GPU on a side stream, which the step joins before it reads the sum.
Replica 0's partials start the accumulator, so its backward overlaps
nothing. The sums are the bulk path's, in its order: overlap on trains
bit for bit as overlap off. `_bucket_sigs` are the reference's: one per
bucket (in the reference's flatten order), under ZeRO-2 one per leaf.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops.attention import (SpGroup, attention,
                                                  ring_tiles,
                                                  ulysses_attention,
                                                  ulysses_tiles)
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                        ring_flash_attention,
                                                        ring_flash_tiles)
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh
from shallowspeed_tpu_torch.parallel.zero import (ZeroUpdate, cut,
                                                  reduce_scatter,
                                                  reduce_scatter_from,
                                                  replace_opt_state,
                                                  scatter_add)
from shallowspeed_tpu_torch.telemetry import collectives as C
from shallowspeed_tpu_torch.telemetry.health import (check_mode,
                                                     engine_snapshot,
                                                     note_step,
                                                     step_replicas_with_health)
from shallowspeed_tpu_torch.telemetry.trace import tracer
from shallowspeed_tpu_torch.weights import (leaves, map_tree,
                                            params_from_numpy, placed_copy,
                                            sorted_leaves, unflatten)

SUBSTRATES = ("ring", "ring-flash", "ulysses", "ulysses-flash", "flash")


def _on(tree, device):
    """A tree's tensors on `device` (the tensors themselves where they
    are already there)."""
    return map_tree(lambda x: x.to(device), tree)


class ContextParallelEngine:
    """Data x sequence parallel trainer for the transformer LM family.
    `mesh` is a (dp, sp) grid of devices (default: one cell on
    `device`); `params`, when given, is a numpy tree to start from
    instead of drawing `init(cfg, seed)` again (a caller that already
    holds the draw); `overlap` an `OverlapConfig` (module docstring)."""

    # params and optimizer state are exposed in the checkpoint's
    # canonical (one-device) layout, as the reference's engine declares
    canonical_opt_identity = True

    def __init__(self, cfg: T.TransformerConfig, optimizer, seed: int = 0,
                 attn: str = "flash", device=None, *, mesh=None,
                 accum: int = 1, zero1: bool = False, zero2: bool = False,
                 health: str = "off", overlap=None, params=None):
        if accum < 1:
            raise ValueError(f"accum must be >= 1, got {accum}")
        if zero1 and zero2:
            raise ValueError("zero2 subsumes zero1")
        check_mode(health)
        if mesh is not None and device is not None:
            raise ValueError("pass the devices through the mesh or `device`, "
                             "not both")
        self.mesh = (make_context_mesh(1, 1, device) if mesh is None
                     else np.asarray(mesh, dtype=object))
        if self.mesh.ndim != 2:
            raise ValueError(f"mesh must be a (dp, sp) grid, got shape "
                             f"{self.mesh.shape}")
        self.dp, self.sp = self.mesh.shape
        self._check_substrate(cfg, attn)
        self.cfg = cfg
        self.attn = attn
        self.optimizer = optimizer
        self.health = health
        self.last_health = None
        self.accum = accum
        self.seed = seed
        # every cell in rank order over (dp, sp): cell c = r sp + s
        self.cells = list(self.mesh.ravel())
        # the cells this process holds (all of them in one process), and
        # the replicas (grid rows) they belong to
        self._mine = [c for c, d in enumerate(self.cells) if D.is_local(d)]
        self._here = sorted({c // self.sp for c in self._mine})
        self._remote = len(self._mine) < len(self.cells)
        self.device = self.cells[self._mine[0]]
        self._attn_fns = [self._substrate(attn, list(row), cfg.attn_window)
                          for row in self.mesh]
        draw = T.init_numpy(cfg, seed) if params is None else params
        self._replicas = [params_from_numpy(draw, d) if D.is_local(d)
                          else None for d in self.cells]
        for p in (x for c in self._mine for x in leaves(self._replicas[c])):
            p.requires_grad_(True)
        state = optimizer.init(self.params)
        self._zero = None
        if zero1 or zero2:
            self._zero = ZeroUpdate(optimizer, self.params, state,
                                    self.cells, health)
            self._states = None
        else:
            self._states = [state if c == self._mine[0] else
                            optimizer.init(p) if p is not None else None
                            for c, p in enumerate(self._replicas)]
        self.zero2 = zero2
        self._step_count = 0
        self.overlap = overlap
        self._plan = None
        self._bucket_sigs = []
        if overlap is not None:
            rep = self.params
            self._plan = OV.leaf_plan(rep, overlap.bucket_bytes)
            plan, flat = OV.plan_param_buckets(rep, overlap.bucket_bytes)
            self._bucket_sigs = (
                [OV.bucket_signature([x]) for x in sorted_leaves(rep)]
                if zero2 else
                [OV.bucket_signature([flat[i] for i in b]) for b in plan])

    def _check_substrate(self, cfg, attn) -> None:
        """The reference engine's refusals, with its messages."""
        if attn not in SUBSTRATES:
            raise ValueError(f"attn={attn!r}; expected one of {SUBSTRATES}")
        if cfg.attn_dropout > 0.0 and not (self.sp == 1 and attn == "ring"):
            raise ValueError(
                "cfg.attn_dropout needs the plain attention substrate "
                "(sp=1, --attn ring); fused substrates cannot mask "
                "probabilities")
        if attn == "flash" and self.sp != 1:
            raise ValueError("--attn flash requires sp=1 (use ring)")
        if attn in ("ulysses", "ulysses-flash"):
            if cfg.n_heads % self.sp:
                raise ValueError(
                    f"--attn {attn} needs n_heads ({cfg.n_heads}) divisible "
                    f"by sp ({self.sp}); use ring")
            if cfg.kv_heads % self.sp:
                raise ValueError(
                    f"--attn {attn} with GQA needs n_kv_heads "
                    f"({cfg.kv_heads}) divisible by sp ({self.sp}); use ring")

    def _substrate(self, attn, cells, window):
        """The attention of one replica: at sp 1 a function of its (q, k,
        v); above, a function of this process's tiles of its sp group
        (`transformer.tile_losses`' `attn_tiles`)."""
        if self.sp == 1:
            if attn == "flash":
                return partial(flash_attention, causal=True, window=window)
            if attn == "ring-flash":
                return partial(ring_flash_attention, devices=cells,
                               causal=True, window=window)
            if attn in ("ulysses", "ulysses-flash"):
                return partial(ulysses_attention, devices=cells, causal=True,
                               window=window,
                               use_flash=attn == "ulysses-flash")
            # the ring of one cell is plain attention
            return partial(attention, causal=True, window=window)
        group = SpGroup(cells)
        if attn == "ring-flash":
            return partial(ring_flash_tiles, group=group, causal=True,
                           window=window)
        if attn in ("ulysses", "ulysses-flash"):
            return partial(ulysses_tiles, group=group, causal=True,
                           window=window, use_flash=attn == "ulysses-flash")
        return partial(ring_tiles, group=group, causal=True, window=window)

    # ------------------------------------------------- replicas and state

    @property
    def params(self):
        """Cell 0's parameter tree (the canonical one); in a process that
        does not hold cell 0, its first cell's (the copies are equal bit
        for bit)."""
        return self._replicas[self._mine[0]]

    @params.setter
    def params(self, tree):
        self._replicas[self._mine[0]] = tree

    def param_copies(self) -> list:
        """The live parameter trees of this process's cells (what a fault
        plan's `nan@N` poisons in place, on every copy)."""
        return [self._replicas[c] for c in self._mine]

    def resident(self) -> dict:
        """The trees this engine keeps resident, for the memory
        observatory's owners: {"params": every cell's parameters,
        "opt_state": every optimizer state it holds}."""
        return {"params": self._replicas,
                "opt_state": (self._states if self._zero is None
                              else self._zero.shards)}

    @property
    def attn_fn(self):
        return self._attn_fns[0]

    @attn_fn.setter
    def attn_fn(self, fn):
        self._attn_fns = [fn] * self.dp

    @property
    def opt_state(self):
        """The optimizer state in the canonical layout: cell 0's, or
        under ZeRO the cells' slices gathered onto the home cell (a
        copy)."""
        if self._zero is not None:
            return self._zero.state(self.device)
        return self._states[self._mine[0]]

    def place(self, arr) -> torch.Tensor:
        """A (B, T) token batch (numpy, or a tensor a prefetcher already
        placed) as int64 on the engine's home device."""
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
        batch in one process, or where sp spans every process)."""
        b = arr.shape[0]
        if b % self.dp:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"dp={self.dp}")
        rows = b // self.dp
        return arr[self._here[0] * rows:(self._here[-1] + 1) * rows]

    def _tiles(self, tokens, targets=None) -> dict:
        """{cell: (tokens, targets) tile on the cell} of this process's
        cells: the batch is the rows of `_here`'s replicas (the whole
        batch in one process), cut into them and each replica's rows into
        its sp columns."""
        tok = self.place(tokens)
        tgt = None if targets is None else self.place(targets)
        b, t = tok.shape
        n = len(self._here)
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"dp={self.dp}" + (
                                 f" ({b} local rows for {n} of the "
                                 f"replicas)" if self._remote else ""))
        if t % self.sp:
            raise ValueError(f"sequence length {t} does not split over "
                             f"sp={self.sp}")
        rows = dict(zip(self._here, zip(
            tok.chunk(n), [None] * n if tgt is None else tgt.chunk(n))))
        out = {}
        for c in self._mine:
            r, s = divmod(c, self.sp)
            x, y = rows[r]
            dev = self.cells[c]
            out[c] = (x.chunk(self.sp, dim=1)[s].to(dev),
                      None if y is None else
                      y.chunk(self.sp, dim=1)[s].to(dev))
        return out

    def _row(self, r: int) -> list:
        """This process's cells of replica r, in tile order."""
        return [c for c in self._mine if c // self.sp == r]

    def dropout_key(self, microbatch: int = 0, replica: int = 0):
        """The dropout key of this step's `microbatch` on `replica` (None
        when the config has no dropout): a pure function of (seed, step,
        microbatch, tile), so a resumed run draws the same masks. Tile 0
        keys (seed, step, microbatch) as one device does; at sp > 1 a
        tuple of the replica's sp tile keys."""
        if self.cfg.dropout == 0.0 and self.cfg.attn_dropout == 0.0:
            return None
        keys = tuple(fold_key(self.seed, self._step_count, microbatch,
                              *([tile] if tile else []))
                     for tile in range(replica * self.sp,
                                       (replica + 1) * self.sp))
        return keys[0] if self.sp == 1 else keys

    def _losses(self, r, cs, params, toks, tgts, key=None,
                train=True) -> list:
        """The losses of replica r's cells `cs` (this process's, in tile
        order) on their tiles: `transformer.loss` at sp 1, else each
        tile's loss from the lockstep forward over the group
        (`transformer.tile_losses`) at global positions."""
        cfg, fn = self.cfg, self._attn_fns[r]
        if self.sp == 1:
            (c,) = cs
            return [T.loss(params[0], toks[0], tgts[0], cfg, attn_fn=fn,
                           dropout_key=key, train=train)]
        t = toks[0].shape[1]
        tiles = [c % self.sp for c in cs]
        return T.tile_losses(params, toks, tgts, cfg, fn,
                             [s * t for s in tiles],
                             None if key is None else [key[s] for s in tiles],
                             train)

    def _replica_grads(self, r, tiles, add=None, on_bucket=None) -> dict:
        """{cell: (loss sum, f32 gradient partial in `leaves()` order)} of
        this process's cells of replica r over their tiles: `accum`
        microbatches, each one lockstep forward and backward of the
        cells. With `add` (the overlapped reduction's per-leaf add into
        the sum, keyed (cell, leaf)) or `on_bucket` (its whole-bucket
        hand-off across processes, `BucketReducer`'s) the last
        microbatch's backward issues its buckets through it, its earlier
        microbatches' sums folded in, and the partials come back None."""
        cs = self._row(r)
        params = [self._replicas[c] for c in cs]
        flat = [list(leaves(p)) for p in params]
        chunks = [[x.chunk(self.accum) for x in tiles[c]] for c in cs]
        loss_sum, gsum = None, None
        for mu in range(self.accum):
            with torch.enable_grad():
                losses = self._losses(r, cs, params,
                                      [ch[0][mu] for ch in chunks],
                                      [ch[1][mu] for ch in chunks],
                                      self.dropout_key(mu, r))
                if (add is not None or on_bucket is not None) \
                        and mu == self.accum - 1:
                    plan = [[(c, i) for c in cs for i in bucket]
                            for bucket in self._plan]
                    earlier = None if gsum is None else {
                        (c, i): g for c, gs in zip(cs, gsum)
                        for i, g in enumerate(gs)}
                    OV.BucketReducer(plan, add, self.cells[cs[0]],
                                     earlier=earlier,
                                     on_bucket=on_bucket).backward(
                        losses, {(c, i): x for c, fl in zip(cs, flat)
                                 for i, x in enumerate(fl)})
                    return {c: ((l.detach() if loss_sum is None
                                 else loss_sum[k] + l.detach()), None)
                            for k, (c, l) in enumerate(zip(cs, losses))}
                # unused leaves (pos_emb under rope, norm biases under
                # rmsnorm) get zero gradients, as jax.grad gives them
                grads = torch.autograd.grad(
                    losses, [x for fl in flat for x in fl],
                    allow_unused=True, materialize_grads=True)
            losses = [l.detach() for l in losses]
            n = len(flat[0])
            grads = [grads[k * n:(k + 1) * n] for k in range(len(cs))]
            if gsum is None:
                loss_sum = losses
                gsum = [[g.float() for g in gs] for gs in grads]
            else:
                loss_sum = [a + b for a, b in zip(loss_sum, losses)]
                for acc, gs in zip(gsum, grads):
                    for a, g in zip(acc, gs):
                        a.add_(g)
            del grads
        return {c: (l, g) for c, l, g in zip(cs, loss_sum, gsum)}

    @property
    def _sum_axis(self) -> str:
        """The grid axis the gradient sum's traffic is booked on."""
        return "dp" if self.dp > 1 else "sp"

    def _reduced(self, tokens, targets):
        """(loss, reduced gradient) of one batch at the current
        parameters: the cells' partials summed in rank order over (dp,
        sp) and scaled by 1 / (dp sp accum) — one leaf list on the home
        cell, or under ZeRO-2 each cell's slice list (`reduce_scatter`)."""
        tiles = self._tiles(tokens, targets)
        b = next(iter(tiles.values()))[0].shape[0]
        if b % self.accum:
            raise ValueError(
                f"--accum {self.accum} must divide the per-device batch "
                f"rows ({b} here = batch / dp; sp shards the sequence "
                f"dim, not rows)")
        if self._remote:
            return (self._reduced_in_flight(tiles) if self._plan is not None
                    else self._reduced_across(tiles))
        total, acc = None, None
        for r in range(self.dp):
            add = (None if r == 0 or self._plan is None
                   else self._adder(acc))
            parts = self._replica_grads(r, tiles, add)
            for c in self._row(r):
                loss, part = parts.pop(c)
                loss = loss.to(self.device)
                total = loss if total is None else total + loss
                if c == 1:      # the sum's (reduce-scatter's) operand
                    C.count_tensors(self._sum_axis, part if part is not None
                                    else list(leaves(self._replicas[c])))
                if add is not None:
                    continue
                if self.zero2:
                    acc = reduce_scatter(acc, part, self._zero.dims,
                                         self.cells)
                elif acc is None:
                    acc = part
                else:
                    for a, g in zip(acc, part):
                        a.add_(g.to(a.device))
                del part
        if self._plan is not None:
            for d in set(self.cells[self.sp:]):
                for into in set(self.cells):
                    OV.join(d, into)
        return self._scaled(total, acc)

    def _scaled(self, total, acc):
        n = self.dp * self.sp * self.accum
        if n > 1:
            total = total / n
            for g in (acc if not self.zero2 else [
                    g for cell in acc if cell is not None for g in cell]):
                g.mul_(1.0 / n)
        return total, acc

    def _reduced_across(self, tiles):
        """`_reduced` over processes: this process's partials first (the
        processes compute side by side), then every cell's loss and
        partial, in rank order, shared by its owner and summed here as
        one process sums them — under ZeRO-2 only this process's cells'
        slices (`reduce_scatter_from`)."""
        parts = {}
        for r in self._here:
            parts.update(self._replica_grads(r, tiles))
        like = list(leaves(self.params))
        total, acc = None, None
        for c, src in enumerate(self.cells):
            loss, part = parts.pop(c, (None, None))
            total = D.add_term(total, loss, src, self.device,
                               everywhere=True)
            if c == 1 and part is not None:
                C.count_tensors(self._sum_axis, part)
            if self.zero2:
                acc = reduce_scatter_from(acc, part, src, self._zero.dims,
                                          self.cells, like)
                continue
            acc = D.add_term(acc, None if part is None else D.pack(part),
                             src, self.device, everywhere=True)
            del part
        if self.zero2:
            return self._scaled(total, acc)
        total, (acc,) = self._scaled(total, [acc])
        return total, D.unpack(acc, like)

    def _reduced_in_flight(self, tiles):
        """`_reduced_across` with the overlapped reduction: every sum this
        process holds (each leaf, or under ZeRO-2 its cells' slices of
        each) a `RankSum` over the cells in rank order; the receives of
        the other processes' bucket messages posted first, then this
        process's replicas' backwards, each bucket put into the local
        sums and sent to every other process that sums it as it closes
        (`CrossSums`), then the join."""
        like = list(leaves(self.params))
        n, sp = len(self.cells), self.sp
        me = D.process_index()
        procs = sorted({D.owner(c) for c in self.cells})
        dims = self._zero.dims if self.zero2 else None

        def sums_of(q):
            """The sums process q holds, (sum key, shape) in order."""
            if not self.zero2:
                return [((None, i), x.shape) for i, x in enumerate(like)]
            return [((d, i), cut(x, n, d, dims[i]).shape)
                    for d in range(n) if D.owner(self.cells[d]) == q
                    for i, x in enumerate(like)]

        def layout(cs, bucket, q):
            """Message (replica's cells `cs`, `bucket`) -> process q:
            (sum key, rank, shape) of every term, the sender's order."""
            keys = dict(sums_of(q))
            return [(key, c, keys[key]) for c in cs for i in bucket
                    for key in (keys if self.zero2 else [(None, i)])
                    if key[1] == i]

        xs = OV.CrossSums()
        for key, _ in sums_of(me):
            xs.expect(key, n, self.device if key[0] is None
                      else self.cells[key[0]])
        # every message's place in its (sender, receiver) order: replica,
        # then bucket
        seq, msgs = {}, {}
        for r in range(self.dp):
            for b, bucket in enumerate(self._plan):
                for p in procs:
                    cs = [c for c in range(r * sp, (r + 1) * sp)
                          if D.owner(self.cells[c]) == p]
                    for q in procs:
                        if q == p or not cs:
                            continue
                        k = seq[(p, q)] = seq.get((p, q), -1) + 1
                        msgs[(r, b, p, q)] = k
                        if q == me:
                            xs.recv(p, k, layout(cs, bucket, me),
                                    self.device)
        parts = {}
        for r in self._here:
            cs = self._row(r)

            def on_bucket(b, keys, terms, r=r, cs=cs):
                got = dict(zip(keys, terms))
                for q in procs:
                    if q != me:
                        xs.send(q, msgs[(r, b, me, q)], [
                            got[(c, key[1])] if key[0] is None else cut(
                                got[(c, key[1])], n, key[0], dims[key[1]])
                            for key, c, _ in layout(cs, self._plan[b], q)])
                for key, c, _ in layout(cs, self._plan[b], me):
                    x = got[(c, key[1])]
                    xs.put(key, c, x if key[0] is None else
                           cut(x, n, key[0], dims[key[1]]))

            parts.update(self._replica_grads(r, tiles, on_bucket=on_bucket))
            if 1 in cs:     # the sum's (reduce-scatter's) operand
                C.count_tensors(self._sum_axis,
                                list(leaves(self._replicas[1])))
        for c in self._mine:
            for into in {self.cells[d] for d in self._mine}:
                OV.join(self.cells[c], into)
        got = xs.totals()
        total = None
        for c, src in enumerate(self.cells):
            loss = parts.pop(c, (None, None))[0]
            total = D.add_term(total, loss, src, self.device,
                               everywhere=True)
        if self.zero2:
            acc = [[got[(c, i)] for i in range(len(like))]
                   if c in self._mine else None for c in range(n)]
        else:
            acc = [got[(None, i)] for i in range(len(like))]
        return self._scaled(total, acc)

    def _adder(self, acc):
        """The overlapped reduction's add of a cell's final gradient of
        leaf i (key (cell, i)) into `acc`: the dense sum's leaf, or every
        cell's slice of it under ZeRO-2."""
        def add(key, g):
            i = key[1]
            if self.zero2:
                scatter_add(acc, i, g, self._zero.dims[i], self.cells)
            else:
                acc[i].add_(g.to(acc[i].device))

        return add

    def loss_and_grads(self, tokens, targets):
        """(loss, gradient tree) of one (B, T) batch at the current
        parameters, without updating them: the reduced gradient in the
        canonical layout (ZeRO-2's slices gathered)."""
        loss, acc = self._reduced(tokens, targets)
        if self.zero2:
            return loss, self._zero.gather_grads(acc, self.params)
        return loss, unflatten(self.params, acc)

    def _totals(self, grads) -> list:
        """The reduced gradient as every cell's own copy (a cell of
        another process: a copy here, whose pieces only the whole-tree
        clipping norm reads)."""
        home = self._mine[0]
        return [grads if c == home else map_tree(
            lambda g, d=(d if D.is_local(d) else self.device): g.to(
                d, copy=True), grads) for c, d in enumerate(self.cells)]

    def train_batch_async(self, tokens, targets) -> torch.Tensor:
        """One optimizer step on a (B, T) int token batch; returns the
        loss before the update as a 0-d tensor on the engine's device,
        unread (`float` it only where the value is needed: log points,
        `data.prefetch.sync_every`). Spans as the reference's: "step",
        and inside it "grads" and "update" under ZeRO (the reference's
        split programs)."""
        tr = tracer()
        step = self._step_count
        mark = C.mark()
        with tr.span("step", step=step) as sp:
            if self._zero is not None:
                with tr.span("grads", step=step) as g:
                    if self.zero2:
                        loss, acc = self._reduced(tokens, targets)
                    else:
                        loss, grads = self.loss_and_grads(tokens, targets)
                    g.fence(loss)
                with tr.span("update", step=step) as u:
                    if not self.zero2:
                        totals = self._totals(grads)
                        del grads
                        acc = [self._zero.pieces(totals[c], c)
                               for c in range(len(self.cells))]
                        del totals
                    pack = self._zero(self._replicas, acc)
                    u.fence(self._zero.shards)
            else:
                loss, grads = self.loss_and_grads(tokens, targets)
                totals = self._totals(grads)
                del grads
                if self.health == "off":
                    for c in self._mine:
                        _, self._states[c] = self.optimizer.step(
                            self._replicas[c], totals[c], self._states[c])
                    pack = None
                else:
                    pack = step_replicas_with_health(
                        self.optimizer, self._replicas, totals,
                        self._states, self.health)
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

    def train_run(self, tokens, targets) -> torch.Tensor:
        """S optimizer steps on (S, B, T) int token and target arrays
        (this process's rows, as `local_batch` gives them), placed on
        the engine's device once, up front; returns the (S,) losses as
        one device tensor, unread. Each step is `train_batch_async` on
        its slice, so the run equals S `train_batch` calls bit for bit.
        Dense engine and health "off" only, as the reference's."""
        if self._zero is not None:
            raise AssertionError(
                "train_run needs the dense engine (zero1/zero2 step on the "
                "host between grad programs)")
        if self.health != "off":
            raise AssertionError(
                "train_run fuses many steps into one dispatch; the "
                "per-step health pack (and the guard) lives in the "
                "train_batch path — build the engine with health='off' "
                "for fused runs")
        toks, tgts = (torch.as_tensor(np.asarray(x)).to(self.device,
                                                        torch.long)
                      for x in (tokens, targets))
        if toks.dim() != 3 or tgts.shape != toks.shape:
            raise ValueError(f"train_run takes (S, B, T) tokens and "
                             f"targets; got {tuple(toks.shape)}, "
                             f"{tuple(tgts.shape)}")
        return torch.stack([self.train_batch_async(a, b)
                            for a, b in zip(toks, tgts)])

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
        """Plain NLL (no label smoothing) of a batch, no update: the mean
        of every tile's mean, on the canonical parameters (`params`) on
        every cell (the copies are equal; an averaged-weights swap sets
        that one tree only)."""
        tiles = self._tiles(tokens, targets)
        losses = {}
        for r in self._here:
            cs = self._row(r)
            losses.update(zip(cs, self._losses(
                r, cs, [_on(self.params, self.cells[c]) for c in cs],
                [tiles[c][0] for c in cs], [tiles[c][1] for c in cs],
                train=False)))
        total = None
        for c, src in enumerate(self.cells):
            loss = D.share(losses.pop(c, None), src, self.device)
            total = loss if total is None else total + loss
        n = self.dp * self.sp
        return float(total / n if n > 1 else total)

    @torch.no_grad()
    def logits(self, tokens) -> torch.Tensor:
        """(B, T, vocab) logits on the home cell (the rows of this
        process's replicas), each tile through its cell's forward."""
        tiles = self._tiles(tokens)
        out = {}
        for r in self._here:
            cs = self._row(r)
            params = [_on(self.params, self.cells[c]) for c in cs]
            toks = [tiles[c][0] for c in cs]
            if self.sp == 1:
                got = [T.forward(params[0], toks[0], self.cfg,
                                 attn_fn=self._attn_fns[r])]
            else:
                t = toks[0].shape[1]
                got = T.tile_logits(params, toks, self.cfg,
                                    self._attn_fns[r],
                                    [(c % self.sp) * t for c in cs])
            out.update(zip(cs, got))
        rows = []
        for r in range(self.dp):
            row = [D.share(out.pop(c, None), self.cells[c], self.device)
                   for c in range(r * self.sp, (r + 1) * self.sp)]
            if r in self._here:
                rows.append(torch.cat(row, dim=1))
        return torch.cat(rows)

    @torch.no_grad()
    def router_stats(self, tokens) -> dict | None:
        """MoE routing on one batch, as the reference reports it: the
        per-expert share of the (token, k) assignments (pre-drop) and
        the share dropped for capacity, each averaged over the layers
        and then over every (dp, sp) tile (each tile routes its own
        rows), every tile's shared by its process. None for a dense
        config. One extra forward, no dropout: call it at log points
        only."""
        if self.cfg.n_experts == 0:
            return None
        tiles = self._tiles(tokens)
        mine = {}
        for r in self._here:
            cs = self._row(r)
            params = [_on(self.params, self.cells[c]) for c in cs]
            toks = [tiles[c][0] for c in cs]
            if self.sp == 1:
                got = [T.forward_with_aux(params[0], toks[0], self.cfg,
                                          attn_fn=self._attn_fns[r],
                                          with_stats=True)[2]]
            else:
                t = toks[0].shape[1]
                got = T.tile_router_stats(params, toks, self.cfg,
                                          self._attn_fns[r],
                                          [(c % self.sp) * t for c in cs])
            for c, st in zip(cs, got):
                mine[c] = torch.cat([st["load"],
                                     st["drop_fraction"].reshape(1)])
        total = None
        for c, src in enumerate(self.cells):
            st = D.share(mine.pop(c, None), src, self.device)
            total = st if total is None else total + st
        total = total / (self.dp * self.sp)
        return {"expert_load": [round(float(x), 4) for x in total[:-1]],
                "drop_fraction": round(float(total[-1]), 4)}

    # -------------------------------------------- checkpoint interface

    def get_canonical_params(self):
        return self.params

    def set_canonical_params(self, params):
        """Replace every cell's parameters by a tree of tensors or numpy
        arrays (the JAX package's layout) of the same structure, each
        cell its own copy. The new trees keep the current key order (a
        checkpoint's dicts come back key-sorted), which the optimizer's
        and the gradient clipping's leaf order follow."""
        def conv(device):
            def leaf(_, x):
                t = (x.detach() if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(x)))
                return t.to(device, copy=True).requires_grad_(True)

            return leaf

        self._replicas = [None if rep is None else
                          map_tree(conv(d), rep, params)
                          for rep, d in zip(self._replicas, self.cells)]

    def set_opt_state(self, state):
        """Install an optimizer state in the canonical layout, the JAX
        package's (numpy leaves, `t` a 0-d int32 array, as a checkpoint
        holds it) or this package's: leaves placed on each cell's device
        (the first cell takes a tensor state as it is), `t` a Python int,
        in the current state's key order; under ZeRO cut into the cells'
        slices."""
        if self._zero is not None:
            replace_opt_state(self._zero.shards, state)
            return
        if any(isinstance(x, np.ndarray) for x in leaves(state)):
            state = placed_copy(state, self.device)
        home = self._mine[0]
        self._states = [
            None if mine is None else
            map_tree(lambda _, x: x, mine,
                     state if c == home else placed_copy(state, d))
            for c, (mine, d) in enumerate(zip(self._states, self.cells))]
