"""The port's `PipelineLMEngine` with ZeRO-1, ZeRO-2 and FSDP at dp 2 x
pp 2: 3-step trajectories against the JAX engine (momentum, SGD with its
schedule, Adafactor — ROADMAP Queue 3's AdamW divergence keeps AdamW
out), FSDP's resting bytes, the health pack against JAX's, the guard's
bit-for-bit skip, and the loss and gradients of the model options the
stage block composes (tied embeddings, chunked cross-entropy, learned
positions, MHA, a window, label smoothing) against JAX's; at pp 2 x
vpp 2, trajectories under ZeRO-1/2 and FSDP at dp 2, remat and chunked
cross-entropy.

Tolerances (f32): trajectories 1e-4 (`torch_parity.TRAJECTORY_TOL`:
losses relative, parameters absolute, optimizer slots relative per
leaf); health packs 1e-4 relative; the loss 1e-5 and each gradient
leaf 1e-4 relative (`torch_parity.check_pipeline_loss_and_grads`)."""

import numpy as np
import pytest
import torch
from torch_parity import (GSPMD_OPTS, PIPE_MODEL, batch,
                          check_pipeline_loss_and_grads, flat,
                          pipeline_engines, pipeline_trajectory)

from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

TRAJ = [((2, 2, 1), "1f1b", "xla", "momentum", {"zero1": True}),
        ((2, 2, 1), "gpipe", "flash", "adafactor", {"zero2": True}),
        ((2, 2, 1), "zb", "xla", "sgd", {"fsdp": True})]


@pytest.mark.parametrize(
    "layout,schedule,attn,optname,ekw", TRAJ,
    ids=[f"dp{x[0]}pp{x[1]}tp{x[2]}-{s}-{a}-{o}" + "".join(f"-{k}" for k in e)
         for x, s, a, o, e in TRAJ])
def test_zero_trajectory_matches_jax(layout, schedule, attn, optname, ekw):
    """Under ZeRO / FSDP the update is the whole leaf's, as the
    reference's GSPMD update."""
    opt, slots = GSPMD_OPTS[optname]
    je, te = pipeline_engines(*layout, opt=opt, schedule=schedule,
                              attn=attn, **ekw)
    pipeline_trajectory(je, te, slots)


VPP_COMPOSED = [
    ("dp2-zero1", 2, PIPE_MODEL, "1f1b", "momentum", {"zero1": True}),
    ("dp2-zero2", 2, PIPE_MODEL, "gpipe", "adafactor", {"zero2": True}),
    ("dp2-fsdp", 2, PIPE_MODEL, "1f1b", "sgd", {"fsdp": True}),
    ("remat", 1, dict(PIPE_MODEL, remat=True), "1f1b", "momentum", {}),
    ("xent-chunk", 1, dict(PIPE_MODEL, xent_chunk=48), "gpipe", "momentum",
     {})]


@pytest.mark.parametrize("name,dp,kw,schedule,optname,ekw", VPP_COMPOSED,
                         ids=[c[0] for c in VPP_COMPOSED])
def test_vpp_composed_trajectory_matches_jax(name, dp, kw, schedule, optname,
                                         ekw):
    """vpp 2 composes with ZeRO-1/2 and FSDP (each cell's slice of the
    interleave-permuted stacked leaves, gathered and updated whole), with
    remat and with chunked cross-entropy: three steps of losses,
    parameters and optimizer state."""
    opt, slots = GSPMD_OPTS[optname]
    je, te = pipeline_engines(dp, 2, opt=opt, kw=kw, schedule=schedule,
                              virtual_pp=2, **ekw)
    pipeline_trajectory(je, te, slots)


def test_fsdp_rests_sharded_and_keeps_no_full_copy():
    """Under FSDP each cell holds 1/dp of its stage's blocks and of the
    replicated leaves (where dp divides a free dimension), and the step
    leaves no gathered copy behind."""
    dense = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), O.SGD(0.1),
                             make_pipeline_mesh(2, 2, devices="cpu"),
                             n_mubatches=2)
    fsdp = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), O.SGD(0.1),
                            make_pipeline_mesh(2, 2, devices="cpu"),
                            n_mubatches=2, fsdp=True)
    fsdp.train_batch(*batch(96, 1, b=4))
    for c in fsdp.coords:
        assert fsdp.cell_bytes()[c][0] * 2 == dense.cell_bytes()[c][0]


def test_health_pack_matches_jax():
    opt, _ = GSPMD_OPTS["momentum"]
    je, te = pipeline_engines(2, 2, opt=opt, schedule="zb", zero2=True,
                              health="monitor")
    for s in range(2):
        tok, tgt = batch(96, 40 + s, b=4)
        je.train_batch(tok, tgt)
        te.train_batch(tok, tgt)
    jh, th = je.health_snapshot(), te.health_snapshot()
    fj, ft = flat(jh), flat(th)
    assert fj.keys() == ft.keys()
    for k in fj:
        assert np.allclose(ft[k], fj[k], rtol=1e-4, atol=1e-7), k


def test_guard_skips_a_poisoned_step_bit_for_bit():
    """Under guard a non-finite gradient skips the whole update on every
    cell: parameters and state keep their bits."""
    eng = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL),
                           O.Adam(1e-2), make_pipeline_mesh(2, 2,
                                                            devices="cpu"),
                           n_mubatches=2, schedule="1f1b", health="guard")
    eng.train_batch(*batch(96, 2, b=4))
    before = [x.clone() for c in eng.coords for x in eng._shards[c]]
    state = flat(eng.opt_state)
    i = eng._index["tok_emb"]
    for c in eng.coords:
        eng._shards[c][i][0, 0] = float("nan")
    poisoned = [x.clone() for c in eng.coords for x in eng._shards[c]]
    eng.train_batch(*batch(96, 3, b=4))
    assert eng.last_health["nonfinite"] > 0
    after = [x for c in eng.coords for x in eng._shards[c]]
    assert all(torch.equal(a, b) or torch.equal(a.isnan(), b.isnan())
               for a, b in zip(after, poisoned))
    assert len(before) == len(after)
    assert flat(eng.opt_state).keys() == state.keys()
    for k, v in flat(eng.opt_state).items():
        assert np.array_equal(v, state[k]), k


@pytest.mark.parametrize("name,kw", [
    ("tied-chunked-gelu", dict(PIPE_MODEL, tie_embeddings=True,
                               xent_chunk=48, ffn="gelu", norm="layernorm",
                               rope=False)),
    ("mha-window-smoothing", dict(PIPE_MODEL, n_kv_heads=0, attn_window=8,
                                  label_smoothing=0.1)),
])
def test_model_options_match_jax(name, kw):
    """Tied embeddings (the first and last stage both add into tok_emb),
    chunked cross-entropy, learned positions, MHA, a window and label
    smoothing, through 1f1b at dp 2 x pp 2."""
    je, te = pipeline_engines(2, 2, kw=kw, schedule="1f1b", attn="flash")
    check_pipeline_loss_and_grads(je, te)
