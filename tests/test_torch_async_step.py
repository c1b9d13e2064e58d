"""The port's asynchronous step, `train_run` and the context engine's
`router_stats`, on the CPU.

- `train_batch_async` on every engine family (the context engine dense,
  ZeRO-1, ZeRO-2 and at accum 2; the tp, FSDP, composite and ep GSPMD
  engines; the LM pipeline under gpipe, 1f1b and zb): three steps with
  the losses read only after the last equal three `train_batch` calls
  bit for bit, losses and parameters, and each loss is a 0-d tensor on
  the engine's device.
- `ContextParallelEngine.train_run`: S steps equal S `train_batch`
  calls bit for bit at dp 2 x sp 2, and the JAX engine's `train_run`
  within the trajectories' bound; its ZeRO and health refusals carry
  the reference's messages.
- `ContextParallelEngine.router_stats` against the JAX context engine's
  at dp 2 x sp 1 and dp 2 x sp 2 (abs 1e-4, as `tests/test_torch_moe.py`
  holds the ep engine's), None for a dense config.
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (MODEL, MOE_MODEL, OPTS, PIPE_MODEL,
                          TRAJECTORY_TOL, batch, engines, worst)

from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import (make_context_mesh,
                                                  make_grid,
                                                  make_pipeline_mesh)
from shallowspeed_tpu_torch.weights import leaves


def _adamw():
    return O.AdamW(1e-2, weight_decay=0.01, grad_clip=1.0)


def _context(dp=2, sp=1, attn="ring", **kw):
    return ContextParallelEngine(T.TransformerConfig(**MODEL), _adamw(),
                                 seed=5, attn=attn,
                                 mesh=make_context_mesh(dp, sp, "cpu"), **kw)


def _gspmd(kind, shape, model=MODEL):
    from shallowspeed_tpu_torch.parallel.composite import Composite3DEngine
    from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine
    from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine
    from shallowspeed_tpu_torch.parallel.tensor import TensorParallelEngine

    cls, names = {"tp": (TensorParallelEngine, ("dp", "tp")),
                  "fsdp": (FSDPEngine, ("dp",)),
                  "3d": (Composite3DEngine, ("dp", "sp", "tp")),
                  "ep": (ExpertParallelEngine, ("dp", "ep"))}[kind]
    return cls(T.TransformerConfig(**model), _adamw(), 5,
               mesh=make_grid(names, shape, "cpu"))


def _pipeline(schedule):
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    return PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), _adamw(),
                            make_pipeline_mesh(1, 2, 1, "cpu"),
                            n_mubatches=2, seed=5, schedule=schedule)


ENGINES = {
    "context-dense": lambda: _context(),
    "context-zero1": lambda: _context(zero1=True),
    "context-zero2": lambda: _context(zero2=True),
    "context-accum2": lambda: _context(dp=1, accum=2),
    "context-sp2": lambda: _context(dp=1, sp=2),
    "tp": lambda: _gspmd("tp", (1, 2)),
    "fsdp": lambda: _gspmd("fsdp", (2,)),
    "3d": lambda: _gspmd("3d", (1, 1, 2)),
    "ep": lambda: _gspmd("ep", (1, 2), MOE_MODEL),
    "pp-gpipe": lambda: _pipeline("gpipe"),
    "pp-1f1b": lambda: _pipeline("1f1b"),
    "pp-zb": lambda: _pipeline("zb"),
}


def _params(eng) -> list:
    return [x.detach().clone() for x in leaves(eng.get_canonical_params())]


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_async_step_equals_train_batch(name):
    """Three async steps, read after the last, against three
    `train_batch` calls from the same draw: the same losses and
    parameters bit for bit; every loss a 0-d, detached tensor on the
    engine's device; the step counter advanced as by `train_batch`."""
    sync, lazy = ENGINES[name](), ENGINES[name]()
    vocab = sync.cfg.vocab
    batches = [batch(vocab, 30 + k, b=4, t=32) for k in range(3)]
    want = [sync.train_batch(tok, tgt) for tok, tgt in batches]
    got = [lazy.train_batch_async(tok, tgt) for tok, tgt in batches]
    for loss in got:
        assert isinstance(loss, torch.Tensor) and loss.dim() == 0
        assert loss.device == torch.device(lazy.device)
        assert not loss.requires_grad
    assert [float(x) for x in got] == want
    assert lazy._step_count == sync._step_count == 3
    for a, b in zip(_params(lazy), _params(sync)):
        assert torch.equal(a, b)


# ----------------------------------------------------------- train_run

def _stack(vocab, steps, b=4, t=32):
    pairs = [batch(vocab, 40 + k, b=b, t=t) for k in range(steps)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def test_train_run_equals_train_batch_calls():
    """S = 3 steps of `train_run` at dp 2 x sp 2 against three
    `train_batch` calls: losses and parameters bit for bit, the losses
    one (S,) device tensor, the step counter advanced by S."""
    run, ref = _context(2, 2), _context(2, 2)
    toks, tgts = _stack(run.cfg.vocab, 3)
    losses = run.train_run(toks, tgts)
    assert isinstance(losses, torch.Tensor) and losses.shape == (3,)
    assert losses.device == torch.device(run.device)
    want = [ref.train_batch(a, b) for a, b in zip(toks, tgts)]
    assert losses.tolist() == want
    assert run._step_count == 3
    for a, b in zip(_params(run), _params(ref)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optname", ["momentum", "adafactor"])
def test_train_run_matches_the_jax_engine(optname):
    """`train_run` against the JAX engine's (one `lax.scan` over the
    steps) at dp 2 x sp 2: losses relative and parameters absolute
    within the trajectories' bound, and the optimizer's step counter."""
    opt, slots = OPTS[optname]
    je, te = engines(2, 2, "ring", opt)
    toks, tgts = _stack(te.cfg.vocab, 3)
    jl = np.asarray(jax.device_get(je.train_run(toks, tgts)))
    tl = te.train_run(toks, tgts).numpy()
    assert np.all(np.abs(tl - jl) / np.abs(jl) <= TRAJECTORY_TOL), (tl, jl)
    assert worst(te.params, jax.device_get(je.params),
                 absolute=True) <= TRAJECTORY_TOL
    jstate = jax.device_get(je.opt_state)
    assert te.opt_state["t"] == int(jstate["t"]) == 3
    for key in slots:
        assert worst(te.opt_state[key], jstate[key]) <= TRAJECTORY_TOL


@pytest.mark.parametrize("kw", [dict(zero1=True), dict(zero2=True),
                                dict(health="monitor"),
                                dict(health="guard")],
                         ids=["zero1", "zero2", "monitor", "guard"])
def test_train_run_refusals_are_the_references(kw):
    """ZeRO and the health modes refuse `train_run` with the JAX
    engine's assertion and its message; the step counter stays."""
    je, te = engines(1, 1, "ring", OPTS["momentum"][0], **kw)
    toks, tgts = _stack(te.cfg.vocab, 2)
    with pytest.raises(AssertionError) as jerr:
        je.train_run(toks, tgts)
    with pytest.raises(AssertionError) as terr:
        te.train_run(toks, tgts)
    assert str(terr.value) == str(jerr.value)
    assert te._step_count == 0


# --------------------------------------------------------- router_stats

@pytest.mark.parametrize("dp,sp", [(2, 1), (2, 2)])
def test_router_stats_match_the_jax_engine(dp, sp):
    """The per-expert load and the drop fraction, tile-averaged over the
    (dp, sp) grid, against the JAX context engine's on the same draw
    and batch (capacity factor 1: some assignments drop)."""
    kw = dict(MOE_MODEL, moe_capacity_factor=1.0)
    je, te = engines(dp, sp, "ring", OPTS["momentum"][0], kw=kw)
    tok, _ = batch(kw["vocab"], 50, b=4, t=32)
    jr, tr = je.router_stats(tok), te.router_stats(tok)
    assert len(tr["expert_load"]) == kw["n_experts"]
    assert tr["expert_load"] == pytest.approx(jr["expert_load"], abs=1e-4)
    assert tr["drop_fraction"] == pytest.approx(jr["drop_fraction"],
                                                abs=1e-4)
    assert tr["drop_fraction"] > 0.0


def test_router_stats_none_for_a_dense_config():
    assert _context(2, 2).router_stats(batch(MODEL["vocab"], 1, b=4)[0]) \
        is None
