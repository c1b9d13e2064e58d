"""The compiled-GPipe pipeline engine — counterpart of
`shallowspeed_tpu/parallel/spmd_pipeline.py`.

The reference runs every stage as the same SPMD program under
`shard_map` over a (dp, pp) mesh: the stage id is the 'pp' axis index,
the stage-to-stage hop a `lax.ppermute`, and the clock `n_mu + pp - 1`
forward ticks then as many backward ticks, bubble ticks computed and
masked out. Here the grid is one device, so the stage axis is a batch
axis: every stage's parameters are padded to a common layer count L and
width Wmax and stacked, a tick is one batched product over the
(replica, stage) axis per layer, and the hop is a shift along the stage
axis (`torch.roll`).

- Heterogeneous stage widths are zero-padded; zero padding is exact for
  linear + ReLU (padded rows and columns contribute 0), the softmax head
  masks padded logits to -1e30 before the block's max (the last stage's
  own block: one replica's microbatch), and padded gradient entries stay
  zero, so the optimizer never moves them.
- The head's VJP is taken from `probs` (`head_grad`), as the reference's
  SPMD engine takes it, not recomputed from the logits as `MLPStage`
  does; this engine is held against `spmd_pipeline.py`, not `mlp.py`.
- At forward tick t stage s holds microbatch t - k s, and at backward
  tick t it holds microbatch n_mu - 1 - (t - k (pp - 1 - s)), which is
  the one it held at forward tick (ticks - 1 - t) for every s, with
  ticks = n_mu + k (pp - 1): each backward tick reads one forward
  tick's stash. The stride k is 1, or 2 with double-buffered hops.
- DP: each replica keeps its own stacked copy of the parameters and
  optimizer state; the replicas' accumulated gradients are summed in
  rank order and every replica applies the same update.

Every cell of the grid must be one device (the stage axis is a tensor
axis). With `health` "monitor" or "guard" each batch also computes the
health pack over the whole {"W", "b"} stacks (every stage at once, the
reference's psum over 'pp'); under "guard" all stages skip in
lockstep.

With `overlap` (`parallel.overlap.OverlapConfig`), the reference's two
pieces. (1) `double_buffer_hops`: a hop is consumed one tick after it
is sent — microbatch m sits at stage s at tick 2s + m, pp - 1 more
warm-up and drain ticks, each tick's compute independent of the hop
sent beside it (`schedule_info`'s `hop_double_buffer`). (2) The
bucketed reduction of the last backward tick (only stage 0 still
active; every other stage's sums are final): in its layer loop each
bucket of per-layer leaves (ids 2 l / 2 l + 1, the reference's plan)
is added into replica 0's sum, every stage at once, the moment the
layer's sums are final — on a GPU on a side stream, which the step
joins before the update. The sums and their order are the bulk path's:
bit for bit the same training in both hop modes.
"""

from __future__ import annotations

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch.data.dataset import stack_epoch
from shallowspeed_tpu_torch.engine import reduce_replicas, replicate
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.telemetry.health import (check_mode,
                                                     engine_snapshot,
                                                     note_step,
                                                     step_replicas_with_health)
from shallowspeed_tpu_torch.models.mlp import init_linear_np, stage_layer_sizes
from shallowspeed_tpu_torch.weights import map_tree, placed_copy, to_host


def _pad_to(arr: np.ndarray, shape) -> np.ndarray:
    out = np.zeros(shape, arr.dtype)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


class StageStack:
    """Stage-stacked, width-padded parameters + static per-stage metadata.

    Layout: W (pp, L, Wmax, Wmax), b (pp, L, 1, Wmax); flags (pp, L):
    `valid` (the layer exists on this stage) and `relu` (the layer has
    a ReLU — all but the last stage's final linear).
    """

    def __init__(self, sizes: list[int], pp: int):
        self.sizes = list(sizes)
        self.pp = pp
        self.wmax = max(sizes)
        per_stage = [stage_layer_sizes(sizes, s, pp) for s in range(pp)]
        self.n_linears = [len(ls) - 1 for ls in per_stage]
        self.L = max(self.n_linears)
        self.in_dim = per_stage[0][0]
        self.out_dim = per_stage[-1][-1]

    def init(self):
        pp, L, wmax = self.pp, self.L, self.wmax
        W = np.zeros((pp, L, wmax, wmax), np.float32)
        b = np.zeros((pp, L, 1, wmax), np.float32)
        valid = np.zeros((pp, L), np.float32)
        relu = np.zeros((pp, L), np.float32)
        for s in range(pp):
            local = stage_layer_sizes(self.sizes, s, pp)
            for i in range(len(local) - 1):
                layer = init_linear_np(local[i], local[i + 1])
                W[s, i] = _pad_to(layer["W"], (wmax, wmax))
                b[s, i] = _pad_to(layer["b"], (1, wmax))
                valid[s, i] = 1.0
                is_last_linear = (s == pp - 1) and (i == len(local) - 2)
                relu[s, i] = 0.0 if is_last_linear else 1.0
        head_mask = np.zeros((wmax,), np.float32)
        head_mask[: self.out_dim] = 1.0
        return {"W": W, "b": b}, {"valid": valid, "relu": relu,
                                  "head_mask": head_mask}

    def unstack_params(self, stacked) -> list[list[dict]]:
        """Back to the per-stage list-of-{'W','b'} layout (unpadded
        numpy), for checkpoint interchange with the other engines."""
        W, b = to_host(stacked["W"]), to_host(stacked["b"])
        out = []
        for s in range(self.pp):
            local = stage_layer_sizes(self.sizes, s, self.pp)
            layers = []
            for i in range(len(local) - 1):
                layers.append({
                    "W": W[s, i, : local[i + 1], : local[i]].copy(),
                    "b": b[s, i, :, : local[i + 1]].copy(),
                })
            out.append(layers)
        return out

    def stack_layers(self, layers) -> dict:
        """Re-pad a canonical flat layer list into the stage-stacked
        {'W','b'} layout (host numpy) — for params and for the
        canonical optimizer moments alike."""
        W = np.zeros((self.pp, self.L, self.wmax, self.wmax), np.float32)
        b = np.zeros((self.pp, self.L, 1, self.wmax), np.float32)
        i = 0
        for s in range(self.pp):
            for l in range(self.n_linears[s]):
                W[s, l] = _pad_to(to_host(layers[i]["W"]), (self.wmax, self.wmax))
                b[s, l] = _pad_to(to_host(layers[i]["b"]), (1, self.wmax))
                i += 1
        assert i == len(layers), (i, len(layers))
        return {"W": W, "b": b}


class SPMDPipelineEngine:
    """GPipe training with the stage axis batched on one device.

    The same interface as `FusedDPEngine` (train_batch / stage_epoch /
    train_epoch / infer), so the driver swaps engines freely.
    """

    def __init__(self, sizes, optimizer, mesh, n_mubatches: int,
                 mubatch_size: int, global_batch_size: int,
                 health: str = "off", overlap=None):
        check_mode(health)
        self.health = health
        self.last_health = None
        mesh = np.asarray(mesh, dtype=object)
        self.dp, self.pp = mesh.shape
        if len(set(mesh.reshape(-1))) != 1:
            raise NotPorted("the SPMD pipeline engine over several devices",
                            "Queue 1 item 5b, the multi-process launch")
        self.device = mesh[0, 0]
        self.n_mu = n_mubatches
        self.mubs = mubatch_size  # per-replica microbatch rows
        self.stack = StageStack(sizes, self.pp)
        self.optimizer = optimizer
        self.wmax = self.stack.wmax
        self.out_dim = self.stack.out_dim
        self.gbs = global_batch_size
        self.overlap = overlap
        self.stride = 2 if (overlap is not None
                            and overlap.double_buffer_hops) else 1
        self.ticks = self.n_mu + self.stride * (self.pp - 1)
        self._plan = None
        self._bucket_sigs = []
        if overlap is not None:
            w = self.wmax
            order = []
            for l in range(self.stack.L - 1, -1, -1):
                order.append((2 * l, torch.empty((w, w), device="meta")))
                order.append((2 * l + 1, torch.empty((1, w), device="meta")))
            self._plan = OV.plan_ids(order, overlap.bucket_bytes)
            by_id = dict(order)
            self._bucket_sigs = [OV.bucket_signature([by_id[i] for i in b])
                                 for b in self._plan]

        params_h, meta_h = self.stack.init()
        self._install(params_h)
        self._opt_states = [optimizer.init(p) for p in self._replicas]
        dev, L = self.device, self.stack.L
        valid = torch.from_numpy(meta_h["valid"] > 0)
        relu = torch.from_numpy(meta_h["relu"] > 0)
        # per layer, over the flattened (replica, stage) axis: None where
        # every stage agrees (the op is skipped), else a (dp*pp, 1, 1) mask
        flat = lambda m: m.repeat(self.dp).view(-1, 1, 1).to(dev)  # noqa: E731
        self._valid = [None if valid[:, l].all() else flat(valid[:, l])
                       for l in range(L)]
        self._norelu = [None if relu[:, l].all() else flat(~relu[:, l])
                        for l in range(L)]
        self._relu_host = relu
        self._head_mask = torch.from_numpy(meta_h["head_mask"] > 0).to(dev)
        # per backward tick: None when every stage holds a microbatch,
        # else the (dp*pp, 1, 1) mask of those that do (built once: a
        # host-to-device copy per tick would cost a stall each)
        self._bwd_active = []
        for t in range(self.ticks):
            active = self._active(t)
            self._bwd_active.append(None if all(active) else torch.tensor(
                active * self.dp, device=dev).view(-1, 1, 1))

    def _install(self, params_h):
        """The stacked (dp, pp, L, ...) parameters, one copy per replica;
        each replica's tree is a view of its slice, so the optimizer's
        in-place update moves the stack the ticks read."""
        def rep(a):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            return t.unsqueeze(0).repeat(self.dp, *([1] * t.dim()))

        self._W, self._b = rep(params_h["W"]), rep(params_h["b"])
        self._replicas = [{"W": self._W[r], "b": self._b[r]}
                          for r in range(self.dp)]

    # ----------------------------------------------------------- the step

    def _layer_fwd(self, W, b, l, h):
        """One layer's padded forward for every (replica, stage) at once:
        W (B, L, w, w), b (B, L, 1, w), h (B, mubs, w). Returns (h_next,
        keep), keep = where the VJP passes the gradient (z > 0 under a
        ReLU, everywhere without one)."""
        z = torch.baddbmm(b[:, l], h, W[:, l].transpose(1, 2))
        keep = z > 0
        if self._norelu[l] is not None:
            keep = keep | self._norelu[l]
        a = torch.where(keep, z, 0.0)
        if self._valid[l] is not None:
            a = torch.where(self._valid[l], a, h)
        return a, keep

    def _head(self, logits):
        """Softmax over the valid class columns: padded logits masked to
        -1e30, the block's global max, a 1e-7 denominator epsilon."""
        ml = torch.where(self._head_mask, logits, -1e30)
        e = torch.exp(ml - ml.amax(dim=(-2, -1), keepdim=True))
        return e / (e.sum(dim=-1, keepdim=True) + 1e-7)

    def _active(self, t: int) -> list[bool]:
        """Which stages hold a microbatch at backward tick t."""
        return [0 <= t - self.stride * (self.pp - 1 - s) < self.n_mu
                for s in range(self.pp)]

    def schedule_info(self) -> dict:
        """The executed schedule, the reference's: GPipe over n_mu
        microbatches and pp stages; with double-buffered hops microbatch
        m sits at stage s at tick 2s + m (pp - 1 more warm-up and drain
        ticks)."""
        return {"schedule": "gpipe", "n_mu": self.n_mu, "pp": self.pp,
                "vpp": 1, "hop_double_buffer": self.stride == 2}

    def _hop(self, out, inflight, shift):
        """(the next tick's stage inputs, what is in flight): this tick's
        `out` shifted one stage along the stage axis, or with double-
        buffered hops the previous tick's (`inflight`; zeros at the first
        tick)."""
        if self.stride == 1:
            return torch.roll(out, shift, dims=1), None
        sent = torch.zeros_like(out) if inflight is None else inflight
        return torch.roll(sent, shift, dims=1), out

    @torch.no_grad()
    def _step(self, xs, ys):
        """One GPipe batch. xs (dp, n_mu, mubs, wmax) width-padded, ys
        (dp, n_mu, mubs, out_dim) compact, on the device."""
        dp, pp, n_mu, L = self.dp, self.pp, self.n_mu, self.stack.L
        B, mubs, w = dp * pp, self.mubs, self.wmax
        W = self._W.flatten(0, 1)
        b = self._b.flatten(0, 1)
        ticks = self.ticks

        # ---------------- forward phase
        cur = torch.zeros(dp, pp, mubs, w, device=self.device)
        cur[:, 0] = xs[:, 0]
        inflight = None
        stashes = []
        for t in range(ticks):
            h = cur.view(B, mubs, w)
            ins, keeps = [], []
            for l in range(L):
                ins.append(h)
                h, keep = self._layer_fwd(W, b, l, h)
                keeps.append(keep)
            probs = self._head(h.view(dp, pp, mubs, w)[:, pp - 1])
            stashes.append((ins, keeps, probs))
            # the hop: stage s + 1 receives stage s's output; stage 0
            # takes its own next microbatch (the last stage's output,
            # shifted round to it, is never read)
            cur, inflight = self._hop(h.view(dp, pp, mubs, w), inflight, 1)
            if t + 1 < n_mu:
                cur[:, 0] = xs[:, t + 1]

        # ---------------- backward phase (reversed microbatch order; the
        # last stage leads)
        gW = torch.zeros_like(W)
        gb = torch.zeros_like(b)
        gW4, gb4 = gW.view(dp, pp, L, w, w), gb.view(dp, pp, L, 1, w)
        cur = torch.zeros(dp, pp, mubs, w, device=self.device)
        inflight = red = None
        for t in range(ticks):
            if t == ticks - 1 and self._plan is not None:
                # the peeled last tick: each bucket into replica 0's sum
                # as soon as its layers' sums are final
                red = OV.BucketReducer(self._plan, _add_replicas,
                                       self.device)
            ins, keeps, probs = stashes[ticks - 1 - t]
            act = self._bwd_active[t]
            if t < n_mu:    # the last stage holds microbatch n_mu - 1 - t
                y = ys[:, n_mu - 1 - t]
                target = torch.nn.functional.pad(y, (0, w - y.shape[-1]))
                cur[:, pp - 1] = self.head_grad(probs, target)
            d = cur.view(B, mubs, w)
            for l in range(L - 1, -1, -1):
                d_act = torch.where(keeps[l], d, 0.0)
                dW = torch.bmm(d_act.transpose(1, 2), ins[l])
                db = d_act.sum(dim=1, keepdim=True)
                d_prev = torch.bmm(d_act, W[:, l])
                valid = self._valid[l]
                d = d_prev if valid is None else torch.where(valid, d_prev, d)
                m = (act if valid is None else valid if act is None
                     else valid & act)
                if m is None:
                    gW[:, l].add_(dW)
                    gb[:, l].add_(db)
                else:
                    gW[:, l].add_(torch.where(m, dW, 0.0))
                    gb[:, l].add_(torch.where(m, db, 0.0))
                if red is not None:
                    red.emit(2 * l, gW4[:, :, l])
                    red.emit(2 * l + 1, gb4[:, :, l])
            if act is not None:
                d = torch.where(act, d, 0.0)
            # the hop back: stage s - 1 receives stage s's input gradient
            cur, inflight = self._hop(d.view(dp, pp, mubs, w), inflight, -1)

        if red is None:
            totals = reduce_replicas(
                [{"W": gW4[r], "b": gb4[r]} for r in range(dp)],
                [self.device] * dp)
        else:
            red.finish()
            OV.join(self.device)
            totals = replicate({"W": gW4[0], "b": gb4[0]}, [self.device] * dp)
        if self.health == "off":
            for r, g in enumerate(totals):
                _, self._opt_states[r] = self.optimizer.step(
                    self._replicas[r], g, self._opt_states[r])
            return
        note_step(self, step_replicas_with_health(
            self.optimizer, self._replicas, totals, self._opt_states,
            self.health))

    def health_snapshot(self) -> dict | None:
        """The last batch's health pack and the cumulative counters as a
        host dict; None before the first batch or with health='off'."""
        return engine_snapshot(self)

    def head_grad(self, probs, target):
        """MSELoss head then the softmax VJP expressed through `probs`."""
        g0 = -2.0 * (target - probs) / self.gbs
        gg = probs * g0
        return gg - probs * gg.sum(dim=-1, keepdim=True)

    # ------------------------------------------------------------- data

    def _pad_batch(self, arr):
        out = np.zeros(arr.shape[:-1] + (self.wmax,), np.float32)
        out[..., : arr.shape[-1]] = arr
        return out

    def _place(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)
                                ).to(self.device)

    def stage_batch(self, datasets, batch_id):
        """(dp, n_mu, mubs, *) stacks on the device: inputs width-padded,
        targets compact."""
        stacks = [ds.load_mubatch_stack(batch_id) for ds in datasets]
        xs = np.stack([s[0] for s in stacks])
        ys = np.stack([s[1] for s in stacks])
        return self._place(self._pad_batch(xs)), self._place(ys)

    def train_batch(self, batch_id, datasets):
        self._step(*self.stage_batch(datasets, batch_id))

    def stage_epoch(self, datasets, n_batches=None):
        """The whole epoch on the device in one copy: (n_batches, dp,
        n_mu, mubs, *)."""
        xs, ys = stack_epoch(datasets, n_batches)
        return self._place(self._pad_batch(xs)), self._place(ys)

    def train_epoch(self, staged):
        xs, ys = staged
        for i in range(xs.shape[0]):
            self._step(xs[i], ys[i])

    @torch.no_grad()
    def infer(self, x: np.ndarray) -> torch.Tensor:
        """Forward a (rows, in_dim) batch split into dp equal row blocks,
        one per replica, stage after stage; (rows, out_dim) probs."""
        dp, pp, w = self.dp, self.pp, self.wmax
        assert len(x) % dp == 0, (len(x), dp)
        h = self._place(self._pad_batch(x.reshape(x.shape[0], -1)))
        h = h.view(dp, -1, w)
        for s in range(pp):
            for l in range(self.stack.n_linears[s]):
                h = torch.baddbmm(self._b[:, s, l], h,
                                  self._W[:, s, l].transpose(1, 2))
                if self._relu_host[s, l]:
                    h = torch.where(h > 0, h, 0.0)
        out = self._head(h)
        return out.reshape(-1, w)[:, : self.out_dim]

    # -------------------------------------------------- state interface

    @property
    def params(self):
        """Replica 0's stacked {'W', 'b'} (the replicas are bit-identical)."""
        return self._replicas[0]

    @property
    def opt_state(self):
        return self._opt_states[0]

    def replicas(self) -> list:
        return list(self._replicas)

    @property
    def unstacked_params(self):
        return self.stack.unstack_params(self.params)

    def get_canonical_params(self):
        return [layer for stage_p in self.unstacked_params
                for layer in stage_p]

    def set_canonical_params(self, layers):
        self._install(self.stack.stack_layers(layers))

    def canon_export_tree(self, tree):
        """Params-shaped tree (Adam's moments, stacked and padded) ->
        canonical flat layer list; padding is zeros in, zeros out, so
        unpadded moments round-trip exactly."""
        return [layer for stage in self.stack.unstack_params(tree)
                for layer in stage]

    def canon_import_tree(self, tree):
        """Inverse of `canon_export_tree` (host numpy)."""
        return self.stack.stack_layers(tree)

    def set_opt_state(self, state):
        self._opt_states = [
            map_tree(lambda _, x: x, old, placed_copy(state, self.device))
            for old in self._opt_states]


def _add_replicas(_, g) -> None:
    """A layer's W or b sums (`g`, their (dp, pp, ...) view, as the last
    tick emits them) of replicas 1.. added into replica 0's in rank
    order, every stage at once."""
    for r in range(1, g.shape[0]):
        g[0].add_(g[r])
