"""Sequence parallelism inside the stages of the port's
`PipelineLMEngine` (a (dp, pp, sp) grid of the CPU) against the JAX
package's on the same host mesh, weights and batch: gpipe and 1f1b at
pp 2 x sp 2 on `ring`, `ring-flash` and `ulysses-flash` once each (the
JAX side runs its Pallas kernels in interpret mode), global RoPE
positions (the one-device engine's loss and gradient), chunked
cross-entropy, ZeRO-2 and MoE at sp (each tile routed as its own
sequence), and the K1/K2/K3 calls of each substrate and schedule
against `chip_smoke.pp_launches_per_step`, the formula the card's
launch counters are held to.

Tolerances (f32): the loss 1e-5 relative, each gradient leaf 1e-4
relative (`torch_parity.LOSS_TOL` / `GRAD_TOL`); trajectories 1e-4
(`TRAJECTORY_TOL`)."""

import chip_smoke
import pytest
from torch_parity import (GRAD_TOL, GSPMD_OPTS, LOSS_TOL, PIPE_MODEL, batch,
                          check_pipeline_loss_and_grads, pipeline_engines,
                          pipeline_trajectory, worst)

from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

CASES = [("gpipe", "ring", 2), ("1f1b", "ring", 2),
         ("gpipe", "ring-flash", 1), ("1f1b", "ulysses-flash", 1)]


@pytest.mark.parametrize("schedule,attn,n_mu", CASES,
                         ids=[f"{s}-{a}" for s, a, _ in CASES])
def test_loss_and_grads_match_jax(schedule, attn, n_mu):
    """pp 2 x sp 2: each stage's attention over its two sp cells; 1f1b
    skips its inactive ticks where the reference runs them masked, with
    the same values."""
    je, te = pipeline_engines(1, 2, sp=2, schedule=schedule, attn=attn,
                              n_mu=n_mu)
    check_pipeline_loss_and_grads(je, te)


@pytest.mark.parametrize("name,dp,kw,ekw,optname", [
    ("dp2-gpipe", 2, PIPE_MODEL, {}, "momentum"),
    ("xent-chunk-1f1b", 1, dict(PIPE_MODEL, xent_chunk=16),
     {"schedule": "1f1b"}, "sgd"),
    ("zero2", 2, PIPE_MODEL, {"zero2": True, "n_mu": 1}, "momentum"),
], ids=["dp2-gpipe", "xent-chunk-1f1b", "zero2"])
def test_trajectory_matches_jax(name, dp, kw, ekw, optname):
    """Three steps of losses, parameters and optimizer state at dp x pp 2
    x sp 2: data parallel, chunked cross-entropy over each tile's
    positions, and ZeRO-2's dp-sliced gradients."""
    opt, slots = GSPMD_OPTS[optname]
    je, te = pipeline_engines(dp, 2, sp=2, opt=opt, kw=kw, attn="ring",
                              **ekw)
    pipeline_trajectory(je, te, slots, b=4 * dp)


def test_rope_positions_are_global():
    """Under RoPE a tile at position i T / sp rotates by its global
    positions: the pp 2 x sp 2 loss and gradient are the one-device
    engine's (the mean of equal tiles' means is the whole mean)."""
    cfg = T.TransformerConfig(**PIPE_MODEL)
    assert cfg.rope
    tok, tgt = batch(cfg.vocab, 13, b=4)
    eng = PipelineLMEngine(cfg, O.SGD(0.1),
                           make_pipeline_mesh(1, 2, sp=2, devices="cpu"),
                           n_mubatches=2, attn="ring", seed=5)
    one = ContextParallelEngine(cfg, O.SGD(0.1), seed=5, attn="ring",
                                device="cpu")
    lp, gp = eng.loss_and_grads(tok, tgt)
    lo, go = one.loss_and_grads(tok, tgt)
    assert abs(float(lp) - float(lo)) <= LOSS_TOL * abs(float(lo))
    assert worst(gp, go) <= GRAD_TOL


@pytest.mark.parametrize("schedule,n_mu", [("gpipe", 1), ("1f1b", 2)])
def test_moe_routes_each_tile(schedule, n_mu):
    """MoE at pp 2 x sp 2: each T/sp tile routes as its own sequence
    with its own capacity, and each tile's weighted aux joins the
    objective, as the reference's tiles do."""
    je, te = pipeline_engines(1, 2, sp=2, kw=dict(PIPE_MODEL, n_experts=4),
                              schedule=schedule, attn="ring", n_mu=n_mu)
    check_pipeline_loss_and_grads(je, te)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of K1/K2/K3's wrappers (their plain versions on the CPU)."""
    calls = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for n in calls:
        fn = getattr(FA, n)

        def counted(*a, n=n, fn=fn, **k):
            calls[n] += 1
            return fn(*a, **k)

        monkeypatch.setattr(FA, n, counted)
    return calls


COUNTS = [("ring-flash", "gpipe", 2, 1, 1), ("ring-flash", "1f1b", 2, 1, 1),
          ("ulysses-flash", "gpipe", 2, 1, 1),
          ("ulysses-flash", "1f1b", 2, 1, 1), ("flash", "1f1b", 1, 2, 1),
          ("flash", "gpipe", 1, 1, 2)]


@pytest.mark.parametrize("attn,schedule,sp,vpp,ep", COUNTS,
                         ids=[f"{a}-{s}-sp{x}-vpp{v}-ep{e}"
                              for a, s, x, v, e in COUNTS])
def test_kernel_calls_follow_the_card_formula(kernel_calls, attn, schedule,
                                              sp, vpp, ep):
    """One step at pp 2, 4 layers, 2 microbatches per replica: K1, K2
    and K3 called as often as `chip_smoke.pp_launches_per_step` says the
    card launches them — ring-flash's hops (K1 its f32-output build),
    ulysses-flash's head groups, a vpp chunk's layers, an ep replica's
    rows; K1 twice under 1f1b."""
    kw = dict(PIPE_MODEL, n_experts=4) if ep > 1 else PIPE_MODEL
    eng = PipelineLMEngine(T.TransformerConfig(**kw), O.SGD(0.1),
                           make_pipeline_mesh(1, 2, sp=sp, ep=ep,
                                              devices="cpu"),
                           n_mubatches=2, schedule=schedule, attn=attn,
                           virtual_pp=vpp)
    eng.train_batch(*batch(96, 4, b=2 * ep))
    want = chip_smoke.pp_launches_per_step(schedule, 1, 1, 2, 4, attn=attn,
                                           sp=sp, ep=ep)
    k1 = "flash_fwd_tc_f32o" if attn == "ring-flash" else "flash_fwd_tc"
    assert kernel_calls == {"flash_fwd": want[k1],
                            "flash_dq": want["flash_dq_tc"],
                            "flash_dkv": want["flash_dkv_tc"]}
