"""MoE in the port's `PipelineLMEngine`, and expert parallelism inside its
stages (a (dp, pp, ep) grid of the CPU), against the JAX package's
engine on the same host mesh, weights and batch: MoE at pp with one
microbatch and microbatched, `eval_loss` with the balance and z-losses,
ep x pp against the dp-only pipeline and against JAX, the ep shards'
distinct experts, ZeRO-1 at ep, and the reference constructor's
refusals of these layouts, message for message.

Tolerances (f32): the loss 1e-5 relative, each gradient leaf 1e-4
relative (`torch_parity.LOSS_TOL` / `GRAD_TOL`); trajectories and eval
losses 1e-4 (`TRAJECTORY_TOL`)."""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (GSPMD_OPTS, LOSS_TOL, PIPE_MODEL, TRAJECTORY_TOL,
                          batch, check_pipeline_loss_and_grads, jax_mesh,
                          pipeline_engines, pipeline_trajectory, worst)

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.pipeline_lm import PipelineLMEngine as JP
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_grid, make_pipeline_mesh
from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

MOE = dict(PIPE_MODEL, n_experts=4, moe_z_weight=1e-3)


@pytest.mark.parametrize("dp,schedule,n_mu", [(1, "gpipe", 1),
                                              (1, "1f1b", 1),
                                              (2, "1f1b", 2)])
def test_loss_and_grads_match_jax(dp, schedule, n_mu):
    """Every stage's blocks route their microbatch and add their
    weighted balance and z-losses; 1f1b seeds every stage's objective,
    not only the last's."""
    je, te = pipeline_engines(dp, 2, kw=MOE, schedule=schedule, n_mu=n_mu)
    check_pipeline_loss_and_grads(je, te)


def test_eval_loss_includes_the_aux():
    """`eval_loss` is the NLL plus the weighted aux, as the reference's
    and the one-device engine's (n_mu 1: the same routing groups)."""
    je, te = pipeline_engines(1, 2, kw=MOE, n_mu=1)
    one = ContextParallelEngine(T.TransformerConfig(**MOE), O.SGD(0.1),
                                seed=5, attn="ring", device="cpu")
    tok, tgt = batch(96, 9, b=4)
    want = je.eval_loss(tok, tgt)
    got = te.eval_loss(tok, tgt)
    assert abs(got - want) <= TRAJECTORY_TOL * abs(want)
    assert abs(one.eval_loss(tok, tgt) - want) <= TRAJECTORY_TOL * abs(want)
    nll = ContextParallelEngine(
        T.TransformerConfig(**dict(MOE, moe_aux_weight=0.0,
                                   moe_z_weight=0.0)),
        O.SGD(0.1), seed=5, attn="ring", device="cpu").eval_loss(tok, tgt)
    assert nll < got


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_ep_pp_matches_the_dp_only_pipeline(schedule):
    """dp 2 x pp 2 x ep 2 is dp 4 x pp 2 with the experts cut over ep:
    each row its own routing group, so the same losses and parameters
    over three steps."""
    opt, _ = GSPMD_OPTS["momentum"]
    kw = T.TransformerConfig(**MOE)
    ep = PipelineLMEngine(kw, opt(O), make_pipeline_mesh(2, 2, ep=2,
                                                         devices="cpu"),
                          n_mubatches=2, schedule=schedule)
    dp = PipelineLMEngine(kw, opt(O), make_pipeline_mesh(4, 2,
                                                         devices="cpu"),
                          n_mubatches=2, schedule=schedule)
    for step in range(3):
        tok, tgt = batch(96, 40 + step, b=8)
        le, ld = ep.train_batch(tok, tgt), dp.train_batch(tok, tgt)
        assert abs(le - ld) <= TRAJECTORY_TOL * abs(ld), step
    assert worst(ep.get_canonical_params(), dp.get_canonical_params(),
                 absolute=True) <= TRAJECTORY_TOL


@pytest.mark.parametrize("name,dp,schedule,ekw,optname", [
    ("gpipe", 1, "gpipe", {}, "sgd"),
    ("1f1b-zero1", 2, "1f1b", {"zero1": True}, "momentum")],
    ids=["gpipe", "1f1b-zero1"])
def test_ep_pp_trajectory_matches_jax(name, dp, schedule, ekw, optname):
    """ep x pp against the reference's explicit all-to-all: three steps
    of losses, parameters and optimizer state; ZeRO-1 slices the
    moments over dp on top of the (pp, ep) placement."""
    opt, slots = GSPMD_OPTS[optname]
    je, te = pipeline_engines(dp, 2, ep=2, opt=opt, kw=MOE,
                              schedule=schedule, n_mu=1, **ekw)
    pipeline_trajectory(je, te, slots, b=2 * dp)


def test_ep_shards_hold_different_experts():
    """The expert leaves carry ep in their spec, each ep cell holds its
    own experts, and after a step the canonical experts differ across
    the expert axis (they are shards, not replicas)."""
    eng = PipelineLMEngine(T.TransformerConfig(**MOE), O.SGD(0.1),
                           make_pipeline_mesh(2, 2, ep=2, devices="cpu"),
                           n_mubatches=2)
    i = eng._index["blocks"]["moe"]["wi"]
    assert "ep" in eng._pspecs[i].axes()
    assert eng._shards[(0, 0, 0)][i].shape[1] == 2
    assert not torch.equal(eng._shards[(0, 0, 0)][i],
                           eng._shards[(0, 0, 1)][i])
    eng.train_batch(*batch(96, 1, b=8))
    wi = np.stack([b["moe"]["wi"].numpy()
                   for b in eng.get_canonical_params()["blocks"]])
    assert not np.allclose(wi[:, 0], wi[:, 1])
    assert not np.allclose(wi[:, 1], wi[:, 3])


_REFUSED = {
    "ep-dense": (("dp", "pp", "ep"), (1, 2, 2), {}, {}),
    "ep-divide": (("dp", "pp", "ep"), (1, 2, 2), {"n_experts": 3}, {}),
    "ep-ring": (("dp", "pp", "ep"), (1, 2, 2), {"n_experts": 4},
                {"attn": "ring"}),
    "ep-vpp": (("dp", "pp", "ep"), (1, 2, 2), {"n_experts": 4},
               {"virtual_pp": 2}),
    "ep-zero2": (("dp", "pp", "ep"), (2, 2, 2), {"n_experts": 4},
                 {"zero2": True}),
    "ep-fsdp": (("dp", "pp", "ep"), (2, 2, 2), {"n_experts": 4},
                {"fsdp": True}),
    "ep-zb": (("dp", "pp", "ep"), (1, 2, 2), {"n_experts": 4},
              {"schedule": "zb"}),
    "moe-zb": (("dp", "pp"), (1, 2), {"n_experts": 4}, {"schedule": "zb"}),
    "moe-tp": (("dp", "pp", "tp"), (1, 2, 2), {"n_experts": 4}, {}),
    "sp-flash": (("dp", "pp", "sp"), (1, 2, 2), {}, {"attn": "flash"}),
    "sp-vpp": (("dp", "pp", "sp"), (1, 2, 2), {}, {"attn": "ring",
                                                   "virtual_pp": 2}),
    "sp-ulysses-heads": (("dp", "pp", "sp"), (1, 2, 4), {},
                         {"attn": "ulysses-flash"}),
    "zb-vpp": (("dp", "pp"), (1, 2), {}, {"schedule": "zb",
                                          "virtual_pp": 2}),
    "vpp-layers": (("dp", "pp"), (1, 2), {}, {"virtual_pp": 3}),
}


@pytest.mark.parametrize("name", list(_REFUSED))
def test_refusals_match_the_reference(name):
    """The reference constructor's asserts on the MoE, ep, sp and vpp
    layouts, message for message."""
    names, shape, extra, ekw = _REFUSED[name]
    kw = dict(PIPE_MODEL, **extra)
    with pytest.raises(AssertionError) as want:
        JP(JT.TransformerConfig(**kw), JO.SGD(0.1), jax_mesh(names, shape),
           n_mubatches=2, **ekw)
    with pytest.raises(AssertionError) as got:
        PipelineLMEngine(T.TransformerConfig(**kw), O.SGD(0.1),
                         make_grid(names, shape, "cpu"), n_mubatches=2,
                         **ekw)
    assert str(got.value) == str(want.value)


def test_decode_refuses_an_ep_grid():
    """The pipelined decode takes no ep (or sp) axis above 1, with the
    reference's message; restored into an ep 1 pipeline the same
    parameters decode."""
    je, te = pipeline_engines(1, 2, ep=2, kw=MOE)
    prompt = batch(96, 2, b=2, t=4)[0]
    with pytest.raises(AssertionError) as want:
        je.generate(prompt, 4, temperature=0.0)
    with pytest.raises(AssertionError) as got:
        te.generate(prompt, 4, temperature=0.0)
    assert str(got.value) == str(want.value)
    plain = PipelineLMEngine(T.TransformerConfig(**MOE), O.SGD(0.1),
                             make_pipeline_mesh(1, 2, devices="cpu"),
                             n_mubatches=2)
    plain.set_canonical_params(jax.device_get(je.get_canonical_params()))
    assert plain.generate(prompt, 4, temperature=0.0).shape == (2, 4)


def test_loss_at_init_matches_the_dp_only_pipeline_at_ep_grid_one():
    """An ep grid of size 1 with a MoE config is the (dp, pp) pipeline:
    the expert leaves cut over one cell."""
    kw = T.TransformerConfig(**MOE)
    tok, tgt = batch(96, 3, b=4)
    a = PipelineLMEngine(kw, O.SGD(0.1), make_grid(("dp", "pp", "ep"),
                                                   (1, 2, 1), "cpu"),
                         n_mubatches=2)
    b = PipelineLMEngine(kw, O.SGD(0.1), make_pipeline_mesh(1, 2,
                                                            devices="cpu"),
                         n_mubatches=2)
    la, lb = a.loss_and_grads(tok, tgt)[0], b.loss_and_grads(tok, tgt)[0]
    assert abs(float(la) - float(lb)) <= LOSS_TOL * abs(float(lb))
