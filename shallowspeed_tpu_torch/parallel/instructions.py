"""The pipeline VM instruction set (ISA) — pure data, no side effects.
A copy of `shallowspeed_tpu/parallel/instructions.py` (the port imports
nothing of the JAX package): schedules emit these, the executor
(`parallel/worker.py`) interprets them, so a schedule is testable with
no device.

Device semantics in this package: Send/Recv pairs are tensor copies
onto the consumer stage's device (`tensor.to(device)`) issued from one
controller; BackwardGradAllReduce sums the replicas' accumulated
gradients in rank order on the controller, in place of the
reference's `lax.psum` over the 'dp' mesh axis.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "PipeInstr", "ZeroGrad", "OptimizerStep", "BufferPipeInstr",
    "RecvActivations", "SendActivations", "RecvOutputGrad", "SendInputGrad",
    "MuBatchPipeInstr", "Forward", "BackwardGradAcc", "BackwardGradAllReduce",
    "LoadInstruction", "LoadMuBatchInput", "LoadMuBatchTarget",
]


class PipeInstr:
    """Base of the ISA (`pipe.py:12-13`)."""


@dataclass
class ZeroGrad(PipeInstr):
    """Reset the gradient accumulator — starts a new accumulation phase
    (`pipe.py:16-23`)."""


@dataclass
class OptimizerStep(PipeInstr):
    """Apply the optimizer to (params, accumulated grads) (`pipe.py:26-32`)."""


@dataclass
class BufferPipeInstr(PipeInstr):
    buffer_id: int


@dataclass
class RecvActivations(BufferPipeInstr):
    """Receive activations from the previous stage into an input buffer
    (`pipe.py:40-47`)."""


@dataclass
class SendActivations(BufferPipeInstr):
    """Send this stage's forward output to the next stage (`pipe.py:50-57`)."""


@dataclass
class RecvOutputGrad(BufferPipeInstr):
    """Receive d(loss)/d(output) from the next stage into an output buffer
    (`pipe.py:60-67`)."""


@dataclass
class SendInputGrad(BufferPipeInstr):
    """Send d(loss)/d(input) to the previous stage (`pipe.py:70-77`)."""


@dataclass
class MuBatchPipeInstr(PipeInstr):
    buffer_id: int
    mubatch_id: int


@dataclass
class Forward(MuBatchPipeInstr):
    """Stage forward on one microbatch; stash activations under mubatch_id
    (`pipe.py:86-93`)."""


@dataclass
class BackwardGradAcc(MuBatchPipeInstr):
    """Stage backward on one microbatch; sum-accumulate grads locally
    (`pipe.py:96-104`)."""


@dataclass
class BackwardGradAllReduce(MuBatchPipeInstr):
    """Like BackwardGradAcc, then reduce the accumulated grads across the
    dp replicas (`pipe.py:107-115`; see the module docstring)."""


@dataclass
class LoadInstruction(MuBatchPipeInstr):
    """Base for host-data loads; executors pass the current batch_id
    (`pipe.py:118-120`, `pipe.py:456-462`)."""


@dataclass
class LoadMuBatchInput(LoadInstruction):
    """Load microbatch inputs X into an input buffer (`pipe.py:123-129`)."""


@dataclass
class LoadMuBatchTarget(LoadInstruction):
    """Load microbatch targets y into an output buffer (`pipe.py:132-138`)."""
