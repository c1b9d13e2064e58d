"""The port's `ExpertParallelEngine` at ep > 1 and dp > 1 (over (dp, ep)
and (dp, sp, ep) grids of the CPU) against the JAX package's on the
same host mesh; at (1, 1) against what the one-device trainer gives;
the global Switch balance loss; the ep split of `ops.moe.moe_ffn`.

Tolerances (f32): the loss at init 1e-5 relative and every gradient
leaf 1e-4 relative; 3-step trajectories under SGD, momentum and
Adafactor (`torch_parity.GSPMD_OPTS`) within 1e-4; at (1, 1) the losses
bit for bit; the ep split of `moe_ffn` bit for bit (the cells' outputs
gathered back before the one combine); routing stats 1e-4 absolute
(the JAX engine rounds them to 4 digits).
"""

import jax
import numpy as np
import pytest
import torch
from torch_parity import (GSPMD_OPTS, MOE_MODEL, batch, check_loss_and_grads,
                          gspmd_engines, trajectory, worst)

from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import moe as M
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_ep_mesh
from shallowspeed_tpu_torch.weights import params_from_numpy

LAYOUTS = {"dp1-ep2": ("ep", (1, 2)), "dp2-ep2": ("ep", (2, 2)),
           "dp2-sp2-ep2": ("ep3", (2, 2, 2))}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_loss_and_grads_match_jax(name):
    kind, shape = LAYOUTS[name]
    je, te = gspmd_engines(kind, shape, GSPMD_OPTS["momentum"][0])
    check_loss_and_grads(je, te)


TRAJECTORIES = [("dp1-ep2", "momentum"), ("dp2-ep2", "momentum"),
                ("dp2-ep2", "adafactor"), ("dp2-ep2", "sgd"),
                ("dp2-sp2-ep2", "momentum"), ("dp2-sp2-ep2", "adafactor")]


@pytest.mark.parametrize("name,optname", TRAJECTORIES,
                         ids=[f"{a}-{b}" for a, b in TRAJECTORIES])
def test_trajectory_matches_jax(name, optname):
    kind, shape = LAYOUTS[name]
    opt, slots = GSPMD_OPTS[optname]
    je, te = gspmd_engines(kind, shape, opt)
    trajectory(je, te, slots)


@pytest.mark.parametrize("optname", ["adamw-clip", "momentum"])
def test_one_cell_is_the_one_device_trainer_bit_for_bit(optname):
    """At (dp, ep) = (1, 1) the engine computes what the one-device
    trainer computes (the context engine on the plain attention, which
    was this class before ep > 1): the same losses, bit for bit, and the
    same parameters."""
    cfg = T.TransformerConfig(**dict(MOE_MODEL, dropout=0.1))

    def opt():
        if optname == "momentum":
            return O.MomentumSGD(0.05)
        return O.AdamW(1e-3, weight_decay=0.01, grad_clip=1.0)

    eng = ExpertParallelEngine(cfg, opt(), 5, device="cpu")
    one = ContextParallelEngine(cfg, opt(), 5, attn="ring", device="cpu")
    for step in range(3):
        tok, tgt = batch(cfg.vocab, 90 + step, b=4)
        assert eng.train_batch(tok, tgt) == one.train_batch(tok, tgt)
    assert worst(eng.params, one.params, absolute=True) == 0.0


def test_balance_loss_at_dp2_is_the_global_one():
    """At dp 2 the Switch loss is E sum_e f_e P_e of the whole batch (f
    and P summed over the replicas first), not the mean of the replicas'
    own: the loss at (2, 1) equals the one-cell engine's, and the mean
    of per-replica losses does not."""
    cfg = T.TransformerConfig(**dict(MOE_MODEL, moe_aux_weight=1.0,
                                     moe_z_weight=0.0))
    tok, tgt = batch(cfg.vocab, 5, b=4)
    one = ExpertParallelEngine(cfg, O.SGD(0.1), 5, device="cpu")
    two = ExpertParallelEngine(cfg, O.SGD(0.1), 5,
                               mesh=make_ep_mesh(2, 1, 1, "cpu"))
    whole = one.eval_loss(tok, tgt)
    assert two.eval_loss(tok, tgt) == pytest.approx(whole, rel=1e-6)
    halves = [one.eval_loss(tok[i:i + 2], tgt[i:i + 2]) for i in (0, 2)]
    assert abs(sum(halves) / 2 - whole) > 1e-4
    la, ga = one.loss_and_grads(tok, tgt)
    lb, gb = two.loss_and_grads(tok, tgt)
    assert float(lb) == pytest.approx(float(la), rel=1e-6)
    assert worst(gb, ga) <= 1e-4


def test_moe_ffn_ep_split_equals_one_cell():
    """Routing over all E experts, each ep cell's experts on their slots,
    their outputs gathered back in rank order for the combine: the
    one-cell layer, bit for bit."""
    cfg = T.TransformerConfig(**MOE_MODEL)
    p = params_from_numpy(T.init_numpy(cfg, 3)["blocks"][0]["moe"], "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    y, aux, z, st = M.moe_ffn(p, x, 2, 1.0)
    for ep in (2, 4):
        split = {"gate": p["gate"], "experts": [
            {k: p[k].chunk(ep)[c] for k in ("wi", "bi", "wo", "bo")}
            for c in range(ep)]}
        ys, auxs, zs, sts = M.moe_ffn(split, x, 2, 1.0)
        assert torch.equal(ys, y)
        assert float(auxs) == float(aux) and float(zs) == float(z)
        assert torch.equal(sts["load"], st["load"])


def test_cells_own_their_experts_and_router_stats_match_jax():
    """Each ep cell holds E/ep experts' wi/bi/wo/bo and the whole router
    gate; routing stats at (2, 2) equal the JAX engine's."""
    je, te = gspmd_engines("ep", (2, 2), GSPMD_OPTS["sgd"][0])
    cfg = te.cfg
    moe = te._index["blocks"][0]["moe"]
    for c in te.coords:
        assert te._shards[c][moe["wi"]].shape == (2, cfg.d_model,
                                                  cfg.ffn_dim)
        assert te._shards[c][moe["bo"]].shape == (2, cfg.d_model)
        assert te._shards[c][moe["gate"]].shape == (cfg.d_model, 4)
    tok, tgt = batch(cfg.vocab, 7, b=4)
    je.train_batch(tok, tgt)
    te.train_batch(tok, tgt)
    jr, tr = je.router_stats(tok), te.router_stats(tok)
    assert tr["expert_load"] == pytest.approx(jr["expert_load"], abs=1e-4)
    assert tr["drop_fraction"] == pytest.approx(jr["drop_fraction"],
                                                abs=1e-4)
    jl = np.asarray(je.logits(tok))
    assert float(np.abs(te.logits(tok).numpy() - jl).max()
                 / np.abs(jl).max()) <= 1e-5
    assert worst(te.params, jax.device_get(je.params),
                 absolute=True) <= 1e-4
