"""The port's `ContextParallelEngine` over (dp, sp) grids of the CPU
against the JAX package's engine on the same (dp, sp) mesh of host
devices: three-step trajectories of every attention substrate at
(dp, sp) in {(2, 1), (1, 2), (2, 2), (1, 4)}, accumulation across the
mesh, a sliding window, `eval_loss` and `logits` at sp 2, a MoE
config at sp 2 (each tile routed on its own), the reference's refusals, per-tile dropout keys, and the K1/K2/K3 calls a
layer makes under each substrate (the launch formula of the card). The
JAX flash kernels run in Pallas interpret mode, the port's plain
versions of K1/K2/K3 on the CPU.

Tolerances (f32): losses 1e-4 relative, parameters 1e-4 absolute,
optimizer moments and slots 1e-4 per leaf relative, logits and eval
losses 1e-4 relative (measured: ~1e-7, the same arithmetic summed in
another order). The trajectories run momentum SGD and factored
Adafactor with clipping, not AdamW (ROADMAP Queue 3: AdamW turns the
f32 noise of an exactly-zero gradient into +-lr updates).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_parity import (MODEL, MOE_MODEL, OPTS, TRAJECTORY_TOL, batch,
                          engines, model_for, trajectory)

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JaxEngine)
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import dropout as D
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh

TOL = TRAJECTORY_TOL
LAYOUTS = [(2, 1), (1, 2), (2, 2), (1, 4)]
SUBSTRATES = ["ring", "ring-flash", "ulysses", "ulysses-flash"]


@pytest.mark.parametrize("attn", SUBSTRATES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"dp{x[0]}sp{x[1]}")
def test_trajectory_matches_jax_engine(layout, attn):
    """Every substrate at every layout: the plain ones under momentum,
    the flash ones under Adafactor."""
    optname = "adafactor" if attn.endswith("flash") else "momentum"
    opt, slots = OPTS[optname]
    je, te = engines(*layout, attn, opt)
    trajectory(je, te, slots)


def test_flash_at_dp2_matches_jax_engine():
    """`attn="flash"` (sp 1 only) over two replicas."""
    opt, slots = OPTS["adafactor"]
    je, te = engines(2, 1, "flash", opt)
    trajectory(je, te, slots)


@pytest.mark.parametrize("attn", ["ring", "ring-flash", "ulysses-flash"])
def test_accumulation_across_the_mesh(attn):
    """accum 2 at (2, 2): each replica's 2 rows in 2 microbatches."""
    opt, slots = OPTS["momentum"]
    je, te = engines(2, 2, attn, opt, accum=2)
    trajectory(je, te, slots)


def test_window_at_sp4_matches_jax_engine():
    """A sliding window across tiles: the ring runs every hop (negative
    rel included) and the masks cut across tile edges."""
    opt, slots = OPTS["adafactor"]
    je, te = engines(1, 4, "ring-flash", opt,
                     kw={**MODEL, "attn_window": 12})
    trajectory(je, te, slots)


@pytest.mark.parametrize("attn", ["ring", "ring-flash", "ulysses"])
def test_eval_loss_and_logits_at_sp2(attn):
    """`eval_loss` (plain NLL, label smoothing off) and `logits` at
    (dp, sp) = (2, 2) against the JAX engine's, after one step."""
    kw = {**model_for(attn, 2), "label_smoothing": 0.1}
    je, te = engines(2, 2, attn, OPTS["momentum"][0], kw=kw)
    tok, tgt = batch(kw["vocab"], 3, b=4)
    je.train_batch(tok, tgt)
    te.train_batch(tok, tgt)
    tok, tgt = batch(kw["vocab"], 4, b=4)
    jl, tl = je.eval_loss(tok, tgt), te.eval_loss(tok, tgt)
    assert abs(tl - jl) / abs(jl) <= TOL
    got, want = te.logits(tok), np.asarray(je.logits(tok))
    assert got.shape == want.shape == (4, kw["max_seq"], kw["vocab"])
    assert float(np.abs(got.numpy() - want).max()) <= TOL * float(
        np.abs(want).max())


def _jax_refusal(dp, sp, attn, kw):
    mesh = Mesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                ("dp", "sp"))
    with pytest.raises(AssertionError) as e:
        JaxEngine(JT.TransformerConfig(**kw), JO.SGD(0.1), mesh, attn=attn)
    return str(e.value)


@pytest.mark.parametrize("case", ["flash-sp2", "ulysses-heads",
                                  "ulysses-kv-heads"])
def test_refusals_match_the_reference(case):
    """The reference engine's config refusals, message for message."""
    attn, sp, kw = {
        "flash-sp2": ("flash", 2, MODEL),
        "ulysses-heads": ("ulysses", 8, {**MODEL, "max_seq": 64}),
        "ulysses-kv-heads": ("ulysses-flash", 4, MODEL)}[case]
    want = _jax_refusal(1, sp, attn, kw)
    with pytest.raises(ValueError) as e:
        ContextParallelEngine(T.TransformerConfig(**kw), O.SGD(0.1),
                              attn=attn, mesh=make_context_mesh(1, sp, "cpu"))
    assert str(e.value) == want


def test_other_refusals():
    """Attention dropout needs sp 1 with ring; the batch must split over
    dp and the sequence over sp; accum must divide each replica's rows,
    with the reference's message."""
    mesh = make_context_mesh(1, 2, "cpu")
    with pytest.raises(ValueError, match="plain attention"):
        ContextParallelEngine(T.TransformerConfig(**MODEL, attn_dropout=0.1),
                              O.SGD(0.1), attn="ring", mesh=mesh)
    te = ContextParallelEngine(T.TransformerConfig(**MODEL), O.SGD(0.1),
                               attn="ring",
                               mesh=make_context_mesh(2, 2, "cpu"), accum=3)
    with pytest.raises(ValueError, match="does not split over dp=2"):
        te.train_batch(*batch(MODEL["vocab"], 1, b=3))
    with pytest.raises(ValueError, match="does not split over sp=2"):
        te.train_batch(*batch(MODEL["vocab"], 1, b=4, t=31))
    with pytest.raises(ValueError, match=r"--accum 3 must divide the "
                                         r"per-device batch rows \(2 here"):
        te.train_batch(*batch(MODEL["vocab"], 1, b=4))
    with pytest.raises(ValueError, match="zero2 subsumes zero1"):
        ContextParallelEngine(T.TransformerConfig(**MODEL), O.SGD(0.1),
                              device="cpu", zero1=True, zero2=True)


def test_moe_at_sp2_routes_each_tile():
    """A MoE config at (1, 2) on ring: each sp tile routes its own
    tokens with its own capacity, as the reference's tiles do — three
    steps of losses, parameters and moments against the JAX engine."""
    opt, slots = OPTS["momentum"]
    je, te = engines(1, 2, "ring", opt, kw=MOE_MODEL)
    trajectory(je, te, slots)


def test_dropout_keys_per_tile():
    """Tile 0 keys as one device does; each (replica, tile) its own key;
    a tuple key masks each tile of the sequence from its own key; a
    dropout run at (2, 2) is reproducible and moves the loss."""
    cfg = T.TransformerConfig(**MODEL, dropout=0.2)
    one = ContextParallelEngine(cfg, O.SGD(0.0), device="cpu", attn="ring")
    grid = ContextParallelEngine(cfg, O.SGD(0.0), attn="ring",
                                 mesh=make_context_mesh(2, 2, "cpu"))
    keys = [grid.dropout_key(mu, r) for r in range(2) for mu in range(2)]
    assert all(isinstance(k, tuple) and len(k) == 2 for k in keys)
    assert keys[0][0] == one.dropout_key(0)
    assert len({k for pair in keys for k in pair}) == 8
    x = torch.ones(2, 8, 4)
    k = (D.fold_key(1), D.fold_key(2))
    got = D.dropout(x, 0.5, k)
    assert torch.equal(got[:, :4], D.dropout(x[:, :4], 0.5, k[0]))
    assert torch.equal(got[:, 4:], D.dropout(x[:, 4:], 0.5, k[1]))
    assert D.fold_key(k, 3) == (D.fold_key(k[0], 3), D.fold_key(k[1], 3))
    tok, tgt = batch(cfg.vocab, 6, b=4)
    losses = [ContextParallelEngine(c, O.SGD(0.1), attn="ring", seed=1,
                                    mesh=make_context_mesh(2, 2, "cpu")
                                    ).train_batch(tok, tgt)
              for c in (cfg, cfg, T.TransformerConfig(**MODEL))]
    assert losses[0] == losses[1] != losses[2]


def _count_calls(monkeypatch):
    counts = dict.fromkeys(("flash_fwd", "flash_dq", "flash_dkv"), 0)
    for name in counts:
        fn = getattr(FA, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(FA, name, counted)
    return counts


@pytest.mark.parametrize("attn,layout,per_layer", [
    ("ring-flash", (1, 4), 10), ("ring-flash", (2, 2), 2 * 3),
    ("ulysses-flash", (1, 2), 2), ("flash", (2, 1), 2),
    ("ring-flash-window", (1, 4), 16)])
def test_kernel_calls_follow_the_reference_branches(monkeypatch, attn,
                                                    layout, per_layer):
    """K1, K2 and K3 calls of one step, per layer (summed over the dp
    replicas): ring-flash sp (sp + 1) / 2 each under causal masking and
    sp^2 with a window, ulysses-flash sp, flash 1 — what the card's
    launch counters read (`chip_smoke.py` phase 12)."""
    window = 12 if attn.endswith("window") else 0
    attn = attn.removesuffix("-window")
    cfg = T.TransformerConfig(**MODEL, attn_window=window)
    te = ContextParallelEngine(cfg, O.SGD(0.1), attn=attn,
                               mesh=make_context_mesh(*layout, "cpu"))
    counts = _count_calls(monkeypatch)
    te.train_batch(*batch(cfg.vocab, 2, b=4))
    want = per_layer * cfg.n_layers
    assert counts == dict.fromkeys(counts, want)
