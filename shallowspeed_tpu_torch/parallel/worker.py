"""The pipeline VM executor — counterpart of
`shallowspeed_tpu/parallel/worker.py`.

One `PipelineExecutor` drives every stage of the pipeline from one
process, as the reference's single controller does. Each stage gets a
`StageRuntime` pinned to one column of the (dp, pp) grid
(`parallel/mesh.py`); the executor advances all stages' instruction
streams with a make-progress loop over FIFO channels, and raises
`pipeline deadlock` when no stream can move.

- `Send`/`Recv` are tensor copies onto the consumer stage's device
  (`tensor.to(device)`), enqueued on the channel in order.
- DP lives inside each stage: a buffer is one tensor per replica, each
  replica computes on its own block (the softmax's max is the block's),
  `BackwardGradAcc` keeps per-replica partial sums, and
  `BackwardGradAllReduce` sums the replicas in rank order and hands
  every replica the same total.
- Activation stashes live in a per-stage dict keyed by mubatch_id,
  sized by the schedule (GPipe: n_mu; 1F1B: pipeline depth).

With `health` "monitor" or "guard" every stage computes its LOCAL
health pack on its reduced gradients and finishes it at its update;
`health_snapshot` merges the stages' packs (`merge_packs`). Under
"guard" the first OptimizerStep of a batch waits until every stage has
reduced, then one host read of the stages' sentinels decides the skip
for all stages (they skip in lockstep).

Telemetry as the reference's VM: a "batch" span around the loop and
one span per compute instruction ("OptimizerStep", "Forward",
"BackwardGradAcc", "BackwardGradAllReduce", with stage / mu / batch
attributes), each fenced on its outputs at the `spans` level; the
measured comm bytes (`comm_bytes`: "dp_psum", the stage's gradient at
each all-reduce, and "pp_p2p", each send's buffer) and the batch's
per-axis traffic (`telemetry_traffic`).
"""

from __future__ import annotations

from collections import deque
from typing import Sequence

import numpy as np
import torch

from shallowspeed_tpu_torch import distributed as D
from shallowspeed_tpu_torch.engine import reduce_replicas
from shallowspeed_tpu_torch.models.mlp import MLPStage, accumulate_grads
from shallowspeed_tpu_torch.parallel.instructions import (
    BackwardGradAcc,
    BackwardGradAllReduce,
    Forward,
    LoadMuBatchInput,
    LoadMuBatchTarget,
    OptimizerStep,
    RecvActivations,
    RecvOutputGrad,
    SendActivations,
    SendInputGrad,
    ZeroGrad,
)
from shallowspeed_tpu_torch.telemetry import collectives as C
from shallowspeed_tpu_torch.telemetry.health import (check_mode, fetch_pack,
                                                     grad_health,
                                                     merge_packs, param_l2,
                                                     snapshot,
                                                     update_health)
from shallowspeed_tpu_torch.telemetry.trace import tracer
from shallowspeed_tpu_torch.weights import (map_tree, params_from_numpy,
                                            placed_copy)


class StageRuntime:
    """State of one pipeline stage over its dp replicas: per replica
    the params, optimizer state and gradient accumulator on its device;
    the activation stashes and the comm buffers (each buffer one tensor
    per replica)."""

    def __init__(self, stage: MLPStage, devices, optimizer,
                 health: str = "off"):
        self.health = health
        self.last_pack = None     # this STAGE's local health pack
        self._nf_batches = None   # device-side: batches with non-finite
        #                           gradients on this stage
        self.stage = stage
        self.devices = list(devices)
        self.dp = len(self.devices)
        self.optimizer = optimizer
        host = stage.init()
        self.replicas = [params_from_numpy(host, d) for d in self.devices]
        self.opt_states = [optimizer.init(p) for p in self.replicas]
        self.grad_acc: list | None = None     # per replica
        self.reduced_grads: list | None = None  # per replica, after AllReduce
        self.stash: dict[int, list] = {}
        self.input_buffers: list = []
        self.output_buffers: list = []

    def zero_grad(self):
        self.grad_acc = [None] * self.dp
        self.reduced_grads = None

    @torch.no_grad()
    def forward(self, xs, mubatch_id: int, training: bool = True):
        outs, stashes = [], []
        for p, x in zip(self.replicas, xs):
            out, stash = self.stage.forward(p, x)
            outs.append(out)
            stashes.append(stash)
        if training:
            self.stash[mubatch_id] = stashes
        return outs

    @torch.no_grad()
    def backward(self, douts, mubatch_id: int, allreduce: bool):
        stashes = self.stash.pop(mubatch_id)
        dxs = []
        for r, (p, st, d) in enumerate(zip(self.replicas, stashes, douts)):
            dx, grads = self.stage.backward(p, st, d)
            acc = self.grad_acc[r]
            self.grad_acc[r] = (grads if acc is None
                                else accumulate_grads(acc, grads))
            dxs.append(dx)
        if allreduce:
            self.reduced_grads = reduce_replicas(self.grad_acc, self.devices)
            if self.health != "off":
                self.last_pack = grad_health(self.replicas[0],
                                             self.reduced_grads[0])
                bad = (self.last_pack["nonfinite"] > 0).to(torch.int32)
                self._nf_batches = (bad if self._nf_batches is None
                                    else self._nf_batches + bad)
        return dxs

    def optimizer_step(self, ok: bool | None = None):
        """The stage's update; under guard `ok` is the executor's global
        decision (a host bool), and a false one leaves every tensor as
        it was."""
        assert self.reduced_grads is not None, \
            "OptimizerStep before BackwardGradAllReduce"
        if self.health != "off":
            norm, old = param_l2(self.replicas[0]), snapshot(self.replicas[0])
        else:
            old = None
        for r, g in enumerate(self.reduced_grads):
            if self.health == "guard":
                _, self.opt_states[r] = self.optimizer.guarded_step(
                    self.replicas[r], g, self.opt_states[r], ok)
            else:
                _, self.opt_states[r] = self.optimizer.step(
                    self.replicas[r], g, self.opt_states[r])
        if old is not None:
            skipped = None if self.health != "guard" else int(not ok)
            upd = update_health({"param_norm": norm}, old,
                                self.replicas[0], skipped=skipped)
            self.last_pack = {**(self.last_pack or {}), **upd}
        self.reduced_grads = None


class PipelineExecutor:
    """Single-controller interpreter for per-stage instruction streams:
    per-stage program counters advance whenever not blocked on an empty
    channel, sends enqueue device-to-device copies, and the loop ends
    when every stream is drained."""

    def __init__(self, mesh, stages: Sequence[MLPStage], optimizer,
                 health: str = "off"):
        check_mode(health)
        self.health = health
        self.health_skipped = 0     # batches skipped under "guard"
        self._guard_ok: bool | None = None
        mesh = np.asarray(mesh, dtype=object)
        if not all(D.is_local(d) for d in mesh.reshape(-1)):
            D.refuse("the per-stage instruction VM (train --engine vm)")
        self.dp, self.pp = mesh.shape
        assert len(stages) == self.pp
        self.device = mesh[0, 0]
        self.runtimes = [StageRuntime(stage, mesh[:, s], optimizer, health)
                         for s, stage in enumerate(stages)]
        self._infer_outputs: list = []
        self.comm_bytes: dict = {}   # measured, cumulative (the reference's)
        self._traffic = None

    @property
    def last(self) -> StageRuntime:
        return self.runtimes[-1]

    # ------------------------------------------------------------- data

    @staticmethod
    def _stacked(datasets, batch_id, mubatch_id, target: bool, devices):
        """One replica's microbatch per shard, each on its replica's
        device."""
        return [torch.from_numpy(np.ascontiguousarray(
            (ds.load_micro_batch_target if target
             else ds.load_micro_batch_input)(batch_id, mubatch_id),
            np.float32)).to(d) for ds, d in zip(datasets, devices)]

    # ------------------------------------------------------------ execute

    def execute(self, schedules, batch_id: int, datasets,
                training: bool = True):
        """Run one batch. `schedules`: one Schedule per stage. `datasets`:
        the dp per-rank Dataset shards."""
        progs = [list(_flatten(s.steps())) for s in schedules]
        pcs = [0] * self.pp
        self._infer_outputs = []
        # channels keyed (src, dst) hold in-flight buffers (FIFO)
        channels: dict[tuple[int, int], deque] = {}

        def chan(src, dst):
            return channels.setdefault((src, dst), deque())

        total = sum(len(p) for p in progs)
        done = 0
        mark = C.mark()
        with tracer().span("batch", batch=batch_id,
                           training=training) as sp:
            while done < total:
                progress = False
                for s in range(self.pp):
                    rt = self.runtimes[s]
                    while pcs[s] < len(progs[s]):
                        cmd = progs[s][pcs[s]]
                        if isinstance(cmd, RecvActivations) \
                                and not chan(s - 1, s):
                            break
                        if isinstance(cmd, RecvOutputGrad) \
                                and not chan(s + 1, s):
                            break
                        if isinstance(cmd, OptimizerStep) \
                                and self.health == "guard" \
                                and self._guard_ok is None \
                                and any(r.reduced_grads is None
                                        for r in self.runtimes):
                            # the guarded update needs every stage's
                            # sentinel: the batch's first step waits
                            # until all stages have reduced (a reduction
                            # never waits on a step, so this cannot
                            # deadlock)
                            break
                        self._dispatch(cmd, rt, s, batch_id, datasets, chan,
                                       training)
                        pcs[s] += 1
                        done += 1
                        progress = True
                if not progress:
                    raise RuntimeError(f"pipeline deadlock at pcs={pcs}")
            sp.fence(*[rt.replicas[0] for rt in self.runtimes])
        self._traffic = C.since(mark)

    def _count(self, kind: str, axis: str, nbytes: int) -> None:
        """One measured transfer: into `comm_bytes` under the reference's
        key and into the per-axis traffic."""
        self.comm_bytes[kind] = self.comm_bytes.get(kind, 0) + nbytes
        if axis is not None:     # None: nothing moved (one replica)
            C.count(axis, nbytes)

    def _dispatch(self, cmd, rt: StageRuntime, s: int, batch_id, datasets,
                  chan, training):
        tr = tracer()
        if isinstance(cmd, ZeroGrad):
            rt.zero_grad()
            self._guard_ok = None    # a fresh batch, a fresh decision
        elif isinstance(cmd, OptimizerStep):
            with tr.span("OptimizerStep", stage=s, batch=batch_id) as sp:
                ok = None
                if self.health == "guard":
                    if self._guard_ok is None:
                        # one host read a batch: every stage's sentinel
                        # combined into the decision all stages share
                        nf = sum(int(r.last_pack["nonfinite"])
                                 for r in self.runtimes)
                        self._guard_ok = nf == 0
                        self.health_skipped += int(nf > 0)
                    ok = self._guard_ok
                rt.optimizer_step(ok)
                sp.fence(rt.replicas[0])
        elif isinstance(cmd, LoadMuBatchInput):
            rt.input_buffers[cmd.buffer_id] = self._stacked(
                datasets, batch_id, cmd.mubatch_id, False, rt.devices)
        elif isinstance(cmd, LoadMuBatchTarget):
            rt.output_buffers[cmd.buffer_id] = self._stacked(
                datasets, batch_id, cmd.mubatch_id, True, rt.devices)
        elif isinstance(cmd, Forward):
            with tr.span("Forward", stage=s, mu=cmd.mubatch_id,
                         batch=batch_id) as sp:
                out = rt.forward(rt.input_buffers[cmd.buffer_id],
                                 cmd.mubatch_id, training)
                rt.output_buffers[cmd.buffer_id] = out
                sp.fence(out)
            if not training and rt is self.last:
                self._infer_outputs.append(out)
        elif isinstance(cmd, (BackwardGradAcc, BackwardGradAllReduce)):
            reduce = isinstance(cmd, BackwardGradAllReduce)
            with tr.span(type(cmd).__name__, stage=s, mu=cmd.mubatch_id,
                         batch=batch_id) as sp:
                dx = rt.backward(rt.output_buffers[cmd.buffer_id],
                                 cmd.mubatch_id, reduce)
                rt.input_buffers[cmd.buffer_id] = dx
                sp.fence(dx)
            if reduce:
                # the stage's whole gradient entered the dp all-reduce
                self._count("dp_psum", "dp" if self.dp > 1 else None,
                            C.tensor_bytes(rt.replicas[0]))
        elif isinstance(cmd, SendActivations):
            nxt = self.runtimes[s + 1]
            buf = rt.output_buffers[cmd.buffer_id]
            self._count("pp_p2p", "pp", C.tensor_bytes(buf))
            chan(s, s + 1).append(
                [t.to(d) for t, d in zip(buf, nxt.devices)])
        elif isinstance(cmd, RecvActivations):
            rt.input_buffers[cmd.buffer_id] = chan(s - 1, s).popleft()
        elif isinstance(cmd, SendInputGrad):
            prv = self.runtimes[s - 1]
            buf = rt.input_buffers[cmd.buffer_id]
            self._count("pp_p2p", "pp", C.tensor_bytes(buf))
            chan(s, s - 1).append(
                [t.to(d) for t, d in zip(buf, prv.devices)])
        elif isinstance(cmd, RecvOutputGrad):
            rt.output_buffers[cmd.buffer_id] = chan(s + 1, s).popleft()
        else:
            raise TypeError(f"unknown instruction {cmd!r}")

    def allocate_buffers(self, num_buffers: int):
        """Buffers are slots (half input, half output) per stage."""
        for rt in self.runtimes:
            n = num_buffers // 2
            rt.input_buffers = [None] * n
            rt.output_buffers = [None] * n

    # --------------------------------------------------------- conveniences

    def train_batch(self, schedule_cls, n_mubatches: int, batch_id: int,
                    datasets):
        scheds = [schedule_cls(n_mubatches, self.pp, s) for s in range(self.pp)]
        self.allocate_buffers(max(s.num_buffers for s in scheds))
        self.execute(scheds, batch_id, datasets, training=True)

    def infer_batch(self, schedule_cls, n_mubatches: int, batch_id: int,
                    datasets) -> torch.Tensor:
        """Forward-only streaming; the last stage's outputs for all
        microbatches in microbatch order, each microbatch's replicas in
        rank order, on the last stage's replica-0 device."""
        scheds = [schedule_cls(n_mubatches, self.pp, s) for s in range(self.pp)]
        self.allocate_buffers(max(s.num_buffers for s in scheds))
        self.execute(scheds, batch_id, datasets, training=False)
        dev = self.last.devices[0]
        return torch.cat([t.to(dev) for out in self._infer_outputs
                          for t in out])

    def telemetry_traffic(self) -> dict:
        """The last batch's bytes and calls per grid axis: the dp
        all-reduces' and the pp sends' (`comm_bytes` keeps the
        reference's cumulative measured counters)."""
        return self._traffic or C.empty()

    def health_snapshot(self) -> dict | None:
        """The last batch's health pack: the stages' local packs fetched
        and merged (`merge_packs`: norms as the root of the summed
        squares, groups prefixed `s<i>.`), with the cumulative
        counters. None before the first batch or with health='off'."""
        merged = merge_packs([fetch_pack(rt.last_pack)
                              for rt in self.runtimes])
        if merged is None:
            return None
        # batches with non-finite gradients: the worst stage's count (a
        # backward's NaN reaches a contiguous run of stages)
        nf = [int(rt._nf_batches) for rt in self.runtimes
              if rt._nf_batches is not None]
        if nf:
            merged["nonfinite_steps_total"] = max(nf)
        if self.health == "guard":
            merged["skipped"] = int(self._guard_ok is False)
            merged["skipped_total"] = self.health_skipped
        return merged

    @property
    def params(self):
        """Replica 0's per-stage parameter lists."""
        return [rt.replicas[0] for rt in self.runtimes]

    @property
    def opt_state(self):
        return [rt.opt_states[0] for rt in self.runtimes]

    @property
    def optimizer(self):
        return self.runtimes[0].optimizer

    def resident(self) -> dict:
        """The trees this engine keeps resident, for the memory
        observatory's owners: {"params": every replica's (or cell's)
        parameters, "opt_state": every optimizer state it holds}."""
        return {"params": [rt.replicas for rt in self.runtimes],
                "opt_state": [rt.opt_states for rt in self.runtimes]}

    def replicas(self) -> list:
        """Per replica, its per-stage parameter lists."""
        return [[rt.replicas[r] for rt in self.runtimes]
                for r in range(self.dp)]

    # -------------------------------------------------- checkpoint interface

    def get_canonical_params(self):
        """Concatenate per-stage layer lists into the whole-model flat list."""
        return [layer for rt in self.runtimes for layer in rt.replicas[0]]

    def set_canonical_params(self, layers):
        i = 0
        for rt in self.runtimes:
            n = rt.stage.n_linears
            rt.replicas = [
                map_tree(lambda _, x, d=d: placed_copy(x, d), p,
                         list(layers[i:i + n]))
                for p, d in zip(rt.replicas, rt.devices)]
            i += n
        assert i == len(layers), (i, len(layers))

    def set_opt_state(self, states):
        assert len(states) == len(self.runtimes), (
            f"{len(states)} per-stage states for {len(self.runtimes)} stages")
        for rt, st in zip(self.runtimes, states):
            rt.opt_states = [map_tree(lambda _, x: x, old, placed_copy(st, d))
                             for old, d in zip(rt.opt_states, rt.devices)]

    def canon_opt_export(self):
        """Merge the per-stage optimizer states into the canonical
        whole-model state (the pp = 1 layout): every params-shaped
        moment tree is a per-stage layer list, so the canonical moment
        is their concatenation in stage order, the transform
        `get_canonical_params` applies to the params. Step counters come
        from stage 0 (all stages step in lockstep)."""
        states = self.opt_state
        per_stage = []
        for st in states:
            trees: list = []
            self.optimizer.map_state_trees(
                st, lambda t: (trees.append(t), t)[1])
            per_stage.append(trees)
        k = len(per_stage[0])
        if k == 0:  # stateless / counter-only: any stage's copy
            return states[0]
        merged = iter([
            [layer for stage in per_stage for layer in stage[i]]
            for i in range(k)])
        return self.optimizer.map_state_trees(
            states[0], lambda _t: next(merged))

    def canon_opt_import(self, canon):
        """Split a canonical whole-model state back into per-stage
        states (the inverse of `canon_opt_export`)."""
        out, lo = [], 0
        for rt in self.runtimes:
            hi = lo + rt.stage.n_linears
            out.append(self.optimizer.map_state_trees(
                canon, lambda tree, lo=lo, hi=hi: list(tree[lo:hi])))
            lo = hi
        return out


def _flatten(steps_gen):
    for step in steps_gen:
        yield from step
