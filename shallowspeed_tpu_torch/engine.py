"""The data-parallel MLP trainer — counterpart of
`shallowspeed_tpu/engine.py`'s `FusedDPEngine`.

The reference compiles a dp x 1 batch step into one XLA program under
`shard_map`: a grad-accumulating scan over the microbatch stack per
replica, a `psum` over 'dp', the optimizer update. Here one controller
drives the replicas of a (dp, 1) grid of devices (`parallel/mesh.py`):

- each replica r keeps its own copy of the parameters and optimizer
  state on its cell's device, and runs the microbatches of its own
  shard, one block per microbatch (the softmax's max is the block's, so
  replicas are never concatenated before it);
- the replicas' accumulated gradients are summed in rank order (the
  all-reduce) and every replica applies the same update to its copy,
  so the copies stay bit-identical (`utils.assert_replicas_in_sync`);
- `stage_epoch` places a whole epoch on the device in one copy and
  `train_epoch` / `train_run` step through it with no host copy per
  batch.

Sequential training (`--dp 1 --pp 1`) is the dp = 1 case. With
`health` "monitor" or "guard" each step also computes the health pack
(`telemetry/health.py`) on the reduced gradients; under "guard" every
replica's update is gated on its `nonfinite == 0`.

With `overlap` (`parallel.overlap.OverlapConfig`) replica r >= 1's last
microbatch reduces inside its hand-written backward: `MLPStage.backward`
emits each layer's (dW, db) as the layer loop makes them, and each
bucket of `overlap.mlp_leaf_order`'s plan, its earlier microbatches'
sum folded in, is added into replica 0's sum the moment it is complete
(on a GPU on a side stream, which the step joins before the update).
Replica 0's sum is the accumulator, so its backward overlaps nothing.
The sums and their order are the bulk path's: bit for bit the same
training.
"""

from __future__ import annotations

import numpy as np
import torch

from shallowspeed_tpu_torch.data.dataset import stack_epoch
from shallowspeed_tpu_torch.models.mlp import MLPStage, accumulate_grads
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.telemetry.health import (check_mode,
                                                     engine_snapshot,
                                                     note_step,
                                                     step_replicas_with_health)
from shallowspeed_tpu_torch.weights import (map_tree, params_from_numpy,
                                            placed_copy)


def reduce_replicas(accs, devices):
    """The all-reduce of one controller: the replicas' gradient trees
    summed in rank order on replica 0's device (in place into
    `accs[0]`), then `replicate`d."""
    total = accs[0]
    for acc in accs[1:]:
        map_tree(lambda t, g: t.add_(g.to(t.device)), total, acc)
    return replicate(total, devices)


def replicate(total, devices):
    """One tree per replica on its device: replica 0 the sum itself, the
    others their own copies, since the optimizer may scale its gradients
    in place (clipping)."""
    return [total] + [map_tree(lambda g, d=d: g.to(d, copy=True), total)
                      for d in devices[1:]]


def layer_leaves(tree) -> dict:
    """A layer list's {"W", "b"} leaves by `overlap.mlp_leaf_order` id."""
    return {k: leaf for k, leaf in OV.mlp_leaf_order(tree)}


class FusedDPEngine:
    """Data-parallel trainer over the replicas of a (dp, 1) grid.

    The same semantics as `PipelineExecutor` with pp = 1 and any
    schedule: zero, n_mu x (fwd, bwd-acc), all-reduce, step.
    """

    # the pp = 1 layout IS canonical, so moments interchange as-is
    canonical_opt_identity = True

    def __init__(self, stage: MLPStage, optimizer, mesh,
                 health: str = "off", overlap=None):
        check_mode(health)
        assert stage.n_stages == 1
        self.health = health
        self.last_health = None
        self.stage = stage
        self.optimizer = optimizer
        self.devices = list(np.asarray(mesh, dtype=object).reshape(-1))
        self.dp = len(self.devices)
        self.device = self.devices[0]
        host = stage.init()
        self._replicas = [params_from_numpy(host, d) for d in self.devices]
        self._opt_states = [optimizer.init(p) for p in self._replicas]
        self.overlap = overlap
        self._plan = None
        self._bucket_sigs = []
        if overlap is not None:
            order = OV.mlp_leaf_order(self._replicas[0])
            self._plan = OV.plan_ids(order, overlap.bucket_bytes)
            by_id = dict(order)
            self._bucket_sigs = [OV.bucket_signature([by_id[i] for i in b])
                                 for b in self._plan]

    # ------------------------------------------------------------- steps

    @torch.no_grad()
    def _step(self, xs, ys):
        """One batch: xs[r], ys[r] replica r's (n_mu, mubs, d) stacks on
        its device."""
        accs = []
        for r, (p, x, y) in enumerate(zip(self._replicas, xs, ys)):
            acc = None
            n_mu = x.shape[0]
            for m in range(n_mu):
                _, stash = self.stage.forward(p, x[m])
                if r and self._plan is not None and m == n_mu - 1:
                    # the peeled last microbatch: buckets into replica
                    # 0's sum between layer VJPs
                    red = OV.BucketReducer(
                        self._plan, self._adder(accs[0]), self.devices[r],
                        earlier=None if acc is None else layer_leaves(acc))
                    self.stage.backward(p, stash, y[m], emit=red.emit)
                    red.finish()
                    acc = None
                    break
                _, grads = self.stage.backward(p, stash, y[m])
                acc = grads if acc is None else accumulate_grads(acc, grads)
            if acc is not None:
                accs.append(acc)
        if self._plan is None:
            totals = reduce_replicas(accs, self.devices)
        else:
            for d in set(self.devices[1:]):
                OV.join(d, self.device)
            totals = replicate(accs[0], self.devices)
        if self.health == "off":
            for r, g in enumerate(totals):
                _, self._opt_states[r] = self.optimizer.step(
                    self._replicas[r], g, self._opt_states[r])
            return
        note_step(self, step_replicas_with_health(
            self.optimizer, self._replicas, totals, self._opt_states,
            self.health))

    @staticmethod
    def _adder(total):
        """The overlapped reduction's add of a leaf's final gradient into
        replica 0's sum `total`."""
        by_id = layer_leaves(total)

        def add(k, g):
            t = by_id[k]
            t.add_(g.to(t.device))

        return add

    def health_snapshot(self) -> dict | None:
        """The last step's health pack and the cumulative counters as a
        host dict (one fetch); None before the first step or with
        health='off'."""
        return engine_snapshot(self)

    def _place(self, arr, device):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)
                                ).to(device)

    def train_batch(self, batch_id: int, datasets):
        """datasets: the dp per-rank Dataset shards; replica r trains on
        shard r's (n_mu, mubs, d) stack of this batch."""
        stacks = [ds.load_mubatch_stack(batch_id) for ds in datasets]
        self._step([self._place(s[0], d) for s, d in zip(stacks, self.devices)],
                   [self._place(s[1], d) for s, d in zip(stacks, self.devices)])

    @torch.no_grad()
    def infer(self, x: np.ndarray) -> torch.Tensor:
        """Forward a (rows, 784) batch split into dp equal row blocks,
        one per replica (rows % dp == 0); the blocks' outputs in order,
        on replica 0's device."""
        assert len(x) % self.dp == 0, (len(x), self.dp)
        n = len(x) // self.dp
        outs = [self.stage.infer(p, self._place(x[r * n:(r + 1) * n], d))
                for r, (p, d) in enumerate(zip(self._replicas, self.devices))]
        return torch.cat([o.to(self.device) for o in outs])

    # ------------------------------------------------------ epoch staging

    def stage_epoch(self, datasets, n_batches: int | None = None):
        """Place the whole epoch on the devices once: per replica, the
        (n_batches, n_mu, mubs, d) inputs and targets of its shard."""
        xs, ys = stack_epoch(datasets, n_batches)
        return ([self._place(xs[:, r], d) for r, d in enumerate(self.devices)],
                [self._place(ys[:, r], d) for r, d in enumerate(self.devices)])

    def train_epoch(self, staged):
        """A full epoch over pre-staged device data."""
        self.train_run(staged, 1)

    def train_run(self, staged, n_epochs: int):
        """n_epochs over pre-staged device data (the same batches each
        epoch: the reference indexes deterministically, no shuffling),
        with no host copy per batch."""
        xs, ys = staged
        for _ in range(n_epochs):
            for b in range(xs[0].shape[0]):
                self._step([x[b] for x in xs], [y[b] for y in ys])

    # -------------------------------------------------- state interface

    @property
    def params(self):
        """Replica 0's parameters (the replicas are bit-identical)."""
        return self._replicas[0]

    @property
    def opt_state(self):
        return self._opt_states[0]

    def replicas(self) -> list:
        """Every replica's parameters, for `assert_replicas_in_sync`."""
        return list(self._replicas)

    def get_canonical_params(self):
        """The pp = 1 params ARE the canonical flat layer list."""
        return self.params

    def set_canonical_params(self, layers):
        """Install a canonical layer list (tensors or numpy) into every
        replica, in each replica's key order."""
        self._replicas = [
            map_tree(lambda _, x, d=d: placed_copy(x, d), p, layers)
            for p, d in zip(self._replicas, self.devices)]

    def set_opt_state(self, state):
        """Install one optimizer state (numpy as a checkpoint holds it,
        or tensors) into every replica, each its own copy."""
        self._opt_states = [
            map_tree(lambda _, x: x, old, placed_copy(state, d))
            for old, d in zip(self._opt_states, self.devices)]
