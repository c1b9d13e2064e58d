"""Pipeline schedules as pure data — a copy of
`shallowspeed_tpu/parallel/schedules.py` (the port imports nothing of
the JAX package), so both packages emit the same instruction streams.

A `Schedule` ABC with stage/microbatch predicates and a `steps()`
generator yielding lists of instructions, plus four concrete
schedules: naive, GPipe, inference and PipeDream-Flush (1F1B, which
caps in-flight activation stashes at `num_stages - stage_id` instead of
GPipe's `num_micro_batches`). Schedules never touch devices or
tensors, so pipeline logic is testable for any (num_stages, stage_id)
with no device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

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


class Schedule(ABC):
    """Reference: `pipe.py:141-181`."""

    def __init__(self, num_micro_batches: int, num_stages: int, stage_id: int):
        assert stage_id < num_stages
        self.num_stages = num_stages
        self.stage_id = stage_id
        self.num_micro_batches = num_micro_batches

    @abstractmethod
    def steps(self):
        """Generator of instruction lists covering one full batch."""

    @property
    @abstractmethod
    def num_buffers(self):
        """Comm buffers needed (multiple of 2: input + output buffers)."""

    @property
    def is_first_stage(self):
        return self.stage_id == 0

    @property
    def is_last_stage(self):
        return self.stage_id == self.num_stages - 1

    def is_first_mubatch(self, mubatch_id):
        return mubatch_id == 0

    def is_last_mubatch(self, mubatch_id):
        return mubatch_id == self.num_micro_batches - 1

    def is_valid_stage_id(self, stage_id):
        return 0 <= stage_id < self.num_stages

    # -- shared per-microbatch building blocks ---------------------------

    def _fwd_cmds(self, mubatch_id, buffer_id=0, send=True):
        cmds = []
        if self.is_first_stage:
            cmds.append(LoadMuBatchInput(buffer_id=buffer_id, mubatch_id=mubatch_id))
        else:
            cmds.append(RecvActivations(buffer_id=buffer_id))
        cmds.append(Forward(buffer_id=buffer_id, mubatch_id=mubatch_id))
        if send and not self.is_last_stage:
            # Last stage discards its forward output: backward needs only the
            # targets + stashed activations (`pipe.py:262-264`).
            cmds.append(SendActivations(buffer_id=buffer_id))
        return cmds

    def _bwd_cmds(self, mubatch_id, allreduce, buffer_id=0):
        cmds = []
        if self.is_last_stage:
            cmds.append(LoadMuBatchTarget(buffer_id=buffer_id, mubatch_id=mubatch_id))
        else:
            cmds.append(RecvOutputGrad(buffer_id=buffer_id))
        bwd_cls = BackwardGradAllReduce if allreduce else BackwardGradAcc
        cmds.append(bwd_cls(buffer_id=buffer_id, mubatch_id=mubatch_id))
        if not self.is_first_stage:
            cmds.append(SendInputGrad(buffer_id=buffer_id))
        return cmds


class NaiveParallelSchedule(Schedule):
    """No interleaving: FWD then immediately BWD per microbatch, one stage
    active at a time. Reference: `pipe.py:184-222`."""

    def steps(self):
        yield [ZeroGrad()]
        for mubatch_id in range(self.num_micro_batches):
            yield self.steps_mubatch(mubatch_id)
        yield [OptimizerStep()]

    def steps_mubatch(self, mubatch_id):
        cmds = self._fwd_cmds(mubatch_id)
        if not self.is_last_stage:
            cmds.append(RecvOutputGrad(buffer_id=0))
        else:
            cmds.append(LoadMuBatchTarget(buffer_id=0, mubatch_id=mubatch_id))
        bwd_cls = (BackwardGradAllReduce if self.is_last_mubatch(mubatch_id)
                   else BackwardGradAcc)
        cmds.append(bwd_cls(buffer_id=0, mubatch_id=mubatch_id))
        if not self.is_first_stage:
            cmds.append(SendInputGrad(buffer_id=0))
        return cmds

    @property
    def num_buffers(self):
        return 2


class GPipeSchedule(Schedule):
    """All-FWD phase then all-BWD phase (reversed microbatch order), with the
    DP all-reduce interleaved into the final backward. Reference:
    `pipe.py:225-272`."""

    def steps(self):
        yield [ZeroGrad()]
        for mubatch_id in range(self.num_micro_batches):
            yield self.steps_FWD_mubatch(mubatch_id)
        for mubatch_id in reversed(range(self.num_micro_batches)):
            yield from self.steps_BWD_mubatch(mubatch_id)
        yield [OptimizerStep()]

    def steps_FWD_mubatch(self, mubatch_id):
        return self._fwd_cmds(mubatch_id)

    def steps_BWD_mubatch(self, mubatch_id):
        # AllReduce rides the first-loaded microbatch — the last one processed
        # in the reversed BWD order (`pipe.py:246-248`).
        yield self._bwd_cmds(mubatch_id, allreduce=self.is_first_mubatch(mubatch_id))

    @property
    def num_buffers(self):
        return 2


class InferenceSchedule(Schedule):
    """FWD-only pipeline streaming, used for evaluation. Reference:
    `pipe.py:275-294`."""

    def steps(self):
        for mubatch_id in range(self.num_micro_batches):
            yield self._fwd_cmds(mubatch_id)

    @property
    def num_buffers(self):
        return 2


class PipeDreamSchedule(Schedule):
    """PipeDream-Flush (1F1B, non-interleaved), fully implemented.

    The reference declares this schedule in its CLI and README but ships only
    `raise NotImplementedError` (`pipe.py:297-299`, `train.py:53,72`,
    `README.md:16`). Here it is real: each stage runs
    `min(num_stages - stage_id - 1, n_mu)` warmup forwards, then a steady
    1F1B phase, then drains the remaining backwards, then a flush
    (OptimizerStep) — same synchronous semantics as GPipe (identical final
    grads; verified in tests), but activation stashes are bounded by pipeline
    depth instead of microbatch count.

    BWD consumes microbatches in FIFO order (0,1,2,...), so the DP all-reduce
    rides the *last* microbatch id, unlike GPipe's reversed order where it
    rides microbatch 0.
    """

    def steps(self):
        yield [ZeroGrad()]
        n_mu = self.num_micro_batches
        num_warmup = min(self.num_stages - self.stage_id - 1, n_mu)
        num_steady = n_mu - num_warmup

        for mubatch_id in range(num_warmup):
            yield self._fwd_cmds(mubatch_id)

        for i in range(num_steady):
            fwd_mu = num_warmup + i
            bwd_mu = i
            yield self._fwd_cmds(fwd_mu)
            yield self._bwd_cmds(bwd_mu, allreduce=self.is_last_mubatch(bwd_mu))

        for bwd_mu in range(num_steady, n_mu):
            yield self._bwd_cmds(bwd_mu, allreduce=self.is_last_mubatch(bwd_mu))

        yield [OptimizerStep()]

    @property
    def num_buffers(self):
        return 2

    def max_stashed_mubatches(self):
        """Peak in-flight activation stashes on this stage — the 1F1B memory
        bound: min(num_stages - stage_id, n_mu)."""
        return min(self.num_stages - self.stage_id, self.num_micro_batches)
