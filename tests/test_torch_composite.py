"""The port's `Composite3DEngine` (dp x sp x tp over a grid of the CPU,
optionally with ZeRO-3 over tp) against the JAX package's on the same
host mesh; the all-gather attention substrate it runs at sp > 1; AdamW
held within the port against its one-device engine.

Tolerances (f32): the loss at init 1e-5 relative and every gradient
leaf 1e-4 relative; 3-step trajectories under SGD, momentum and
Adafactor (`torch_parity.GSPMD_OPTS`) within 1e-4; the all-gather
substrate 1e-6 of the plain attention's max (per-tile score rows are
the whole sequence's rows: only the product's blocking differs), its
gradients 1e-5; AdamW against the one-device engine within 1e-4 (the
key bias's exactly-zero gradient keeps it to the port: ROADMAP Queue
3); the health pack 1e-4 relative (`tests/test_torch_health.py`).
"""

import pytest
import torch
from torch_parity import (GSPMD_OPTS, MODEL, batch, check_loss_and_grads,
                          gspmd_engines, trajectory, worst)

from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops.attention import (allgather_attention,
                                                  attention)
from shallowspeed_tpu_torch.parallel.composite import Composite3DEngine
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_3d_mesh, make_tp_mesh

OPTIONS = {"plain": {}, "fsdp": {"fsdp": True}, "zero1": {"zero1": True},
           "zero2": {"zero2": True}}


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kv", [4, 2])
def test_allgather_attention_equals_plain(kv, sp, window):
    """Each tile's queries against the gathered K/V, the causal mask
    offset by the tile's start: the plain attention over the whole
    sequence, forward and gradients."""
    g = torch.Generator().manual_seed(sp + kv + window)
    q = torch.randn(2, 32, 4, 8, generator=g, requires_grad=True)
    k = torch.randn(2, 32, kv, 8, generator=g, requires_grad=True)
    v = torch.randn(2, 32, kv, 8, generator=g, requires_grad=True)
    ref = attention(q, k, v, causal=True, window=window)
    got = allgather_attention(q, k, v, sp, causal=True, window=window)
    assert float((got - ref).detach().abs().max()) <= 1e-6 * float(
        ref.detach().abs().max())
    w = torch.randn(ref.shape, generator=g)
    gr = torch.autograd.grad((ref * w).sum(), [q, k, v])
    gg = torch.autograd.grad((got * w).sum(), [q, k, v])
    for a, b in zip(gg, gr):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("option", list(OPTIONS))
def test_loss_and_grads_match_jax(option):
    je, te = gspmd_engines("3d", (2, 2, 2), GSPMD_OPTS["momentum"][0],
                           **OPTIONS[option])
    check_loss_and_grads(je, te)


TRAJECTORIES = [("plain", "momentum"), ("plain", "adafactor"),
                ("plain", "sgd"), ("fsdp", "momentum"), ("fsdp", "adafactor"),
                ("zero1", "momentum"), ("zero2", "adafactor")]


@pytest.mark.parametrize("option,optname", TRAJECTORIES,
                         ids=[f"{a}-{b}" for a, b in TRAJECTORIES])
def test_trajectory_matches_jax(option, optname):
    """(2, 2, 2), alone, with ZeRO-3 over tp (`fsdp`), ZeRO-1 (the sliced
    elementwise update) and ZeRO-2 (the gathered Adafactor update)."""
    opt, slots = GSPMD_OPTS[optname]
    je, te = gspmd_engines("3d", (2, 2, 2), opt, **OPTIONS[option])
    trajectory(je, te, slots)


def test_fsdp_cells_hold_a_dp_and_tp_block():
    """With fsdp every shardable leaf is cut over tp (Megatron) and dp
    (`add_dp`): a column-parallel W holds (d/dp, 3d/tp) or (d, 3d/(dp
    tp)) — the larger dim wins — on each cell."""
    cfg = T.TransformerConfig(**dict(MODEL, n_kv_heads=0))
    eng = Composite3DEngine(cfg, O.SGD(0.1), mesh=make_3d_mesh(2, 2, 2, "cpu"),
                            fsdp=True)
    specs = eng.specs["blocks"][0]
    assert tuple(specs["qkv"]["W"]) == ("dp", "tp")
    assert tuple(specs["proj"]["W"]) == ("tp", "dp")
    d = cfg.d_model
    i = eng._pspecs.index(specs["qkv"]["W"])
    for c in eng.coords:
        assert eng._shards[c][i].shape == (d // 2, 3 * d // 2)


@pytest.mark.parametrize("layout", [(2, 2, 2), (1, 2, 2)],
                         ids=["dp2sp2tp2", "dp1sp2tp2"])
def test_adamw_equals_the_one_device_engine(layout):
    """AdamW within the port: three steps of the composite engine (with
    fsdp) against the one-device plain-attention engine."""
    cfg = T.TransformerConfig(**MODEL)

    def opt():
        return O.AdamW(1e-3, weight_decay=0.01, grad_clip=1.0)

    eng = Composite3DEngine(cfg, opt(), 5, mesh=make_3d_mesh(*layout, "cpu"),
                            fsdp=True)
    one = ContextParallelEngine(cfg, opt(), 5, attn="ring", device="cpu")
    for step in range(3):
        tok, tgt = batch(cfg.vocab, 80 + step, b=4)
        a, b = eng.train_batch(tok, tgt), one.train_batch(tok, tgt)
        assert abs(a - b) / abs(b) <= 1e-4
    assert worst(eng.params, one.params, absolute=True) <= 1e-4


def test_health_pack_and_eval_match_jax():
    """The health pack (monitor, ZeRO-2: each leaf's squares summed over
    its dp and tp blocks) and eval_loss at (2, 2, 2)."""
    from test_torch_health import _pack_close

    je, te = gspmd_engines("3d", (2, 2, 2), GSPMD_OPTS["momentum"][0],
                           zero2=True, health="monitor")
    for step in range(2):
        tok, tgt = batch(te.cfg.vocab, 30 + step, b=4)
        je.train_batch(tok, tgt)
        te.train_batch(tok, tgt)
    _pack_close(te.health_snapshot(), je.health_snapshot())
    tok, tgt = batch(te.cfg.vocab, 41, b=4)
    assert te.eval_loss(tok, tgt) == pytest.approx(je.eval_loss(tok, tgt),
                                                   rel=1e-5)


def test_refusals():
    cfg = T.TransformerConfig(**MODEL)
    with pytest.raises(ValueError, match="drop zero1/zero2"):
        Composite3DEngine(cfg, O.SGD(0.1), mesh=make_3d_mesh(2, 1, 2, "cpu"),
                          fsdp=True, zero2=True)
    with pytest.raises(ValueError, match="'dp','sp','tp'"):
        Composite3DEngine(cfg, O.SGD(0.1), mesh=make_tp_mesh(2, 2, "cpu"))
    with pytest.raises(ValueError, match="MoE"):
        Composite3DEngine(T.TransformerConfig(**MODEL, n_experts=4),
                          O.SGD(0.1), mesh=make_3d_mesh(1, 2, 2, "cpu"))
    eng = Composite3DEngine(cfg, O.SGD(0.1), mesh=make_3d_mesh(1, 2, 2, "cpu"))
    with pytest.raises(ValueError, match="does not split over sp=2"):
        eng.train_batch(*batch(cfg.vocab, 1, b=2, t=31))
