"""Data x sequence parallel LM trainer — counterpart of
`shallowspeed_tpu/parallel/context.py::ContextParallelEngine`, over a
(dp, sp) grid of devices (`parallel.mesh.make_context_mesh`) that one
process drives; on one card every cell is the card.

- **Replicas.** Replica r keeps its own f32 master parameters (`init(cfg,
  seed)`, the reference's draw) on its home cell (r, 0), and, unless
  ZeRO shards it, its own optimizer state. It trains on rows
  [r B/dp, (r+1) B/dp) of each batch, in `accum` microbatches, each its
  own forward and backward under torch autograd (the forward casts to
  `cfg.compute_dtype` as `cast_params` does; the gradients come back to
  the f32 masters through that cast).
- **Sequence parallelism lives inside attention.** Every other layer is
  position-wise, so the replica's whole (B/dp, T) sequence runs through
  the model on its home cell, and only the attention substrate cuts q,
  k and v into sp tiles, one per cell (r, s), and runs the ring or the
  all-to-all among them. Positions are global, so RoPE needs no
  offset. The replica's loss is the sum of its sp tiles' mean losses in
  tile order (the reference's per-tile loss), and each tile draws its
  dropout masks from its own key (`dropout_key`).
- **The reduction.** The replicas' f32 gradient partials are summed in
  rank order as they come and scaled by 1 / (dp sp accum), the
  reference's `tile_loss_and_gsum` scaling; the reported loss is the
  mean of every tile's mean. Dense: every replica gets its own copy of
  the sum (the all-reduce) and applies the same update
  (`step_replicas_with_health`). ZeRO-1: the same sum, with the
  optimizer state sliced over the dp cells and the update sharded
  (`parallel.zero.ZeroUpdate`). ZeRO-2: each partial is reduce-
  scattered into per-cell slices as it comes, so no cell keeps more than
  its slice of the sum.

`attn` selects the substrate, as in the reference: "ring" (the plain
`attention` at sp 1, `ops.attention.ring_attention` above; the only
substrate that takes cfg.attn_dropout, and only at sp 1), "ring-flash"
(`ops.flash_attention.ring_flash_attention`: K1 with f32 chunk
outputs, K2, K3 on every hop), "ulysses" and "ulysses-flash"
(`ops.attention.ulysses_attention`, the flash kernels on each cell's
head group with "-flash"; heads and kv heads divisible by sp) and
"flash" (`flash_attention`, sp 1 only). On the card the flash
substrates launch the hand-written K1/K2/K3; on the CPU their plain
versions run.

With `health` "monitor" or "guard" each step also computes the health
pack on the reduced gradients (each ZeRO-2 leaf's slices summed in rank
order); under "guard" the update is gated on its `nonfinite == 0`
(`guarded_step`). The canonical state a checkpoint holds is replica 0's
parameters and the unsharded optimizer state (`opt_state` gathers ZeRO's
slices), so checkpoints cross between layouts and packages.

A MoE config at sp > 1 routes each sp tile as its own sequence, with
that tile's capacity, as the reference's tiles do (the tile count
passed down to `ops.moe.moe_ffn` as `moe_tiles`): the replica's loss
adds every tile's weighted balance and z-losses to its tiles' token
losses. (`parallel.expert.
ExpertParallelEngine` routes whole rows over a (dp, sp, ep) grid.)

With `overlap` (`parallel.overlap.OverlapConfig`) the reduction moves
into the backward, bucket by bucket (`parallel.overlap.BucketReducer`):
replica r >= 1's last microbatch runs its backward with hooks that add
each bucket's gradients, its earlier microbatches' sum folded in, into
the accumulator (dense, ZeRO-1) or every cell's slices of it (ZeRO-2,
`zero.scatter_add` per leaf) as soon as the bucket's last leaf is
final; on a GPU on a side stream, which the step joins before it reads
the sum. Replica 0's partial is the accumulator, so its backward
overlaps nothing. The sums are the bulk path's, in its order: overlap on
trains bit for bit as overlap off. `_bucket_sigs` are the reference's:
one per bucket (in the reference's flatten order), under ZeRO-2 one per
leaf.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops.attention import (attention, ring_attention,
                                                  ulysses_attention)
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                        ring_flash_attention)
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh
from shallowspeed_tpu_torch.parallel.zero import (ZeroUpdate, reduce_scatter,
                                                  replace_opt_state,
                                                  scatter_add)
from shallowspeed_tpu_torch.telemetry.health import (check_mode,
                                                     engine_snapshot,
                                                     note_step,
                                                     step_replicas_with_health)
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
        self.cells = list(self.mesh[:, 0])      # each replica's home cell
        self.device = self.cells[0]
        self._attn_fns = [self._substrate(attn, list(row), cfg.attn_window)
                          for row in self.mesh]
        draw = T.init_numpy(cfg, seed) if params is None else params
        self._replicas = [params_from_numpy(draw, d) for d in self.cells]
        for p in (x for rep in self._replicas for x in leaves(rep)):
            p.requires_grad_(True)
        state = optimizer.init(self._replicas[0])
        self._zero = None
        if zero1 or zero2:
            self._zero = ZeroUpdate(optimizer, self._replicas[0], state,
                                    self.cells, health)
            self._states = None
        else:
            self._states = [state] + [optimizer.init(p)
                                      for p in self._replicas[1:]]
        self.zero2 = zero2
        self._step_count = 0
        self.overlap = overlap
        self._plan = None
        self._bucket_sigs = []
        if overlap is not None:
            rep = self._replicas[0]
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
        """The attention function of one replica, over its sp cells."""
        if attn == "flash":
            return partial(flash_attention, causal=True, window=window)
        if attn == "ring-flash":
            return partial(ring_flash_attention, devices=cells, causal=True,
                           window=window)
        if attn in ("ulysses", "ulysses-flash"):
            return partial(ulysses_attention, devices=cells, causal=True,
                           window=window, use_flash=attn == "ulysses-flash")
        if self.sp == 1:      # the ring of one cell is plain attention
            return partial(attention, causal=True, window=window)
        return partial(ring_attention, devices=cells, causal=True,
                       window=window)

    # ------------------------------------------------- replicas and state

    @property
    def params(self):
        """Replica 0's parameter tree (the canonical one)."""
        return self._replicas[0]

    @params.setter
    def params(self, tree):
        self._replicas[0] = tree

    @property
    def attn_fn(self):
        return self._attn_fns[0]

    @attn_fn.setter
    def attn_fn(self, fn):
        self._attn_fns = [fn] * self.dp

    @property
    def opt_state(self):
        """The optimizer state in the canonical layout: replica 0's, or
        under ZeRO the cells' slices gathered onto the home cell (a
        copy)."""
        if self._zero is not None:
            return self._zero.state(self.device)
        return self._states[0]

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

    def _rows(self, tokens, targets) -> list:
        """Each replica's (tokens, targets) rows on its home cell."""
        tok, tgt = self.place(tokens), self.place(targets)
        b, t = tok.shape
        if b % self.dp:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"dp={self.dp}")
        if t % self.sp:
            raise ValueError(f"sequence length {t} does not split over "
                             f"sp={self.sp}")
        return [(x.to(d), y.to(d)) for x, y, d in
                zip(tok.chunk(self.dp), tgt.chunk(self.dp), self.cells)]

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

    def _loss(self, r, params, tok, tgt, key=None, train=True):
        """Replica r's loss on (tok, tgt): the sum of its sp tiles'
        losses, in tile order (`transformer.loss` itself at sp 1); a
        tile's loss is its mean token loss plus, for a MoE config, its
        weighted balance and z-losses."""
        cfg, fn = self.cfg, self._attn_fns[r]
        if self.sp == 1:
            return T.loss(params, tok, tgt, cfg, attn_fn=fn,
                          dropout_key=key, train=train)
        hid, (aux, z) = T.forward_with_aux(params, tok, cfg, fn, key,
                                           head=False, moe_tiles=self.sp)
        head = "tok_emb" if cfg.tie_embeddings else "head"
        hp = T.cast_params({head: params[head]}, cfg.compute_dtype)
        total = None
        for h, g in zip(hid.chunk(self.sp, dim=1), tgt.chunk(self.sp, dim=1)):
            part = (T.chunked_token_loss(params, h, g, cfg, train)
                    if cfg.xent_chunk > 0 else
                    T.token_loss(T.head_logits(hp, h, cfg), g, cfg, train))
            total = part if total is None else total + part
        if cfg.n_experts > 0:
            total = total + cfg.moe_aux_weight * aux
            if cfg.moe_z_weight > 0.0:
                total = total + cfg.moe_z_weight * z
        return total

    def _replica_grads(self, r, tok, tgt, add=None):
        """(loss sum, f32 gradient partial in `leaves()` order) of replica
        r's rows: `accum` microbatches, each its own forward and
        backward. With `add` (the overlapped reduction's per-leaf add
        into the sum) the last microbatch's backward issues its buckets
        through it, its earlier microbatches' sum folded in, and the
        partial comes back None."""
        params = self._replicas[r]
        flat = list(leaves(params))
        loss_sum, gsum = None, None
        for mu, (tok_mu, tgt_mu) in enumerate(zip(tok.chunk(self.accum),
                                                  tgt.chunk(self.accum))):
            with torch.enable_grad():
                loss = self._loss(r, params, tok_mu, tgt_mu,
                                  self.dropout_key(mu, r))
                if add is not None and mu == self.accum - 1:
                    OV.BucketReducer(self._plan, add, self.cells[r],
                                     earlier=gsum).backward(
                        loss, dict(enumerate(flat)))
                    loss = loss.detach()
                    return (loss if loss_sum is None else loss_sum + loss,
                            None)
                # unused leaves (pos_emb under rope, norm biases under
                # rmsnorm) get zero gradients, as jax.grad gives them
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
            loss = loss.detach()
            if gsum is None:
                loss_sum, gsum = loss, [g.float() for g in grads]
            else:
                loss_sum = loss_sum + loss
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
            del grads
        return loss_sum, gsum

    def _reduced(self, tokens, targets):
        """(loss, reduced gradient) of one batch at the current
        parameters: the replicas' partials summed in rank order and
        scaled by 1 / (dp sp accum) — one leaf list on the home cell, or
        under ZeRO-2 each cell's slice list (`reduce_scatter`)."""
        rows = self._rows(tokens, targets)
        b = rows[0][0].shape[0]
        if b % self.accum:
            raise ValueError(
                f"--accum {self.accum} must divide the per-device batch "
                f"rows ({b} here = batch / dp; sp shards the sequence "
                f"dim, not rows)")
        total, acc = None, None
        for r, (tok, tgt) in enumerate(rows):
            add = (None if r == 0 or self._plan is None
                   else self._adder(acc))
            loss, part = (self._replica_grads(r, tok, tgt) if add is None
                          else self._replica_grads(r, tok, tgt, add=add))
            loss = loss.to(self.device)
            total = loss if total is None else total + loss
            if add is not None:
                continue
            if self.zero2:
                acc = reduce_scatter(acc, part, self._zero.dims, self.cells)
            elif acc is None:
                acc = part
            else:
                for a, g in zip(acc, part):
                    a.add_(g.to(a.device))
            del part
        if self._plan is not None:
            for d in set(self.cells[1:]):
                for into in set(self.cells):
                    OV.join(d, into)
        n = self.dp * self.sp * self.accum
        if n > 1:
            total = total / n
            for g in (acc if not self.zero2 else
                      [g for cell in acc for g in cell]):
                g.mul_(1.0 / n)
        return total, acc

    def _adder(self, acc):
        """The overlapped reduction's per-leaf add of a replica's final
        gradient into `acc`: the dense sum's leaf, or every cell's slice
        of it under ZeRO-2."""
        def add(i, g):
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

    def train_batch(self, tokens, targets) -> float:
        """One optimizer step on a (B, T) int token batch; returns the
        loss before the update."""
        if self.zero2:
            loss, acc = self._reduced(tokens, targets)
            pack = self._zero(self._replicas, acc)
        else:
            loss, grads = self.loss_and_grads(tokens, targets)
            totals = [grads] + [map_tree(lambda g, d=d: g.to(d, copy=True),
                                         grads) for d in self.cells[1:]]
            del grads
            if self._zero is not None:
                pack = self._zero(self._replicas, [
                    self._zero.pieces(totals[c], c) for c in range(self.dp)])
            elif self.health == "off":
                for r, g in enumerate(totals):
                    _, self._states[r] = self.optimizer.step(
                        self._replicas[r], g, self._states[r])
                pack = None
            else:
                pack = step_replicas_with_health(
                    self.optimizer, self._replicas, totals, self._states,
                    self.health)
        if pack is not None:
            note_step(self, pack)
        self._step_count += 1
        return float(loss)

    def health_snapshot(self) -> dict | None:
        """The last step's health pack and the cumulative counters as a
        host dict (call at log points); None before the first step or
        with health='off'."""
        return engine_snapshot(self)

    @torch.no_grad()
    def eval_loss(self, tokens, targets) -> float:
        """Plain NLL (no label smoothing) of a batch, no update: the mean
        of every tile's mean, on replica 0's parameters (the replicas are
        equal; an averaged-weights swap sets replica 0 only)."""
        total = None
        for r, (tok, tgt) in enumerate(self._rows(tokens, targets)):
            loss = self._loss(r, _on(self.params, self.cells[r]), tok, tgt,
                              train=False).to(self.device)
            total = loss if total is None else total + loss
        n = self.dp * self.sp
        return float(total / n if n > 1 else total)

    @torch.no_grad()
    def logits(self, tokens) -> torch.Tensor:
        """(B, T, vocab) logits on the home cell, each replica's rows
        through its substrate."""
        tok = self.place(tokens)
        if tok.shape[0] % self.dp or tok.shape[1] % self.sp:
            raise ValueError(f"token batch {tuple(tok.shape)} does not "
                             f"split over (dp={self.dp}, sp={self.sp})")
        return torch.cat([
            T.forward(_on(self.params, d), x.to(d), self.cfg,
                      attn_fn=self._attn_fns[r],
                      moe_tiles=self.sp).to(self.device)
            for r, (x, d) in enumerate(zip(tok.chunk(self.dp), self.cells))])

    # -------------------------------------------- checkpoint interface

    def get_canonical_params(self):
        return self.params

    def set_canonical_params(self, params):
        """Replace every replica's parameters by a tree of tensors or
        numpy arrays (the JAX package's layout) of the same structure,
        each replica its own copy. The new trees keep the current key
        order (a checkpoint's dicts come back key-sorted), which the
        optimizer's and the gradient clipping's leaf order follow."""
        def conv(device):
            def leaf(_, x):
                t = (x.detach() if isinstance(x, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(x)))
                return t.to(device, copy=True).requires_grad_(True)

            return leaf

        self._replicas = [map_tree(conv(d), rep, params)
                          for rep, d in zip(self._replicas, self.cells)]

    def set_opt_state(self, state):
        """Install an optimizer state in the canonical layout, the JAX
        package's (numpy leaves, `t` a 0-d int32 array, as a checkpoint
        holds it) or this package's: leaves placed on each replica's
        device (replica 0 takes a tensor state as it is), `t` a Python
        int, in the current state's key order; under ZeRO cut into the
        cells' slices."""
        if self._zero is not None:
            replace_opt_state(self._zero.shards, state)
            return
        if any(isinstance(x, np.ndarray) for x in leaves(state)):
            state = placed_copy(state, self.device)
        self._states = [map_tree(lambda _, x: x, self._states[0], state)] + [
            map_tree(lambda _, x: x, mine, placed_copy(state, d))
            for mine, d in zip(self._states[1:], self.cells[1:])]
