"""The port's `PipelineLMEngine` (`shallowspeed_tpu_torch/parallel/
pipeline_lm.py`, a (dp, pp[, tp]) grid of the CPU) against the JAX
package's on the same host mesh, weights and batch: the loss and every
gradient leaf for each schedule and substrate at (dp, pp) in {(1, 2),
(2, 2)} ((1, 4) and tp in `tests/test_torch_pipeline_tp.py`); within the
port, zb's gradients against gpipe's, the K1/K2/K3 calls each schedule
makes
(their plain versions, counted on the CPU), the replicated leaves equal
on every cell, 1F1B's stash bound, dropout masks shared by gpipe and
1f1b, remat, eval, the reference constructor's refusals, and one step
of each layout the next slice added (vpp, sp, ep, MoE).

The JAX engine's gradient is read off its own step
(`torch_parity.check_pipeline_loss_and_grads`). Tolerances (f32): the
loss 1e-5 relative, each gradient leaf 1e-4 relative
(`torch_parity.LOSS_TOL` / `GRAD_TOL`); zb against gpipe 1e-5."""

import pytest
import torch
from torch_parity import (LOSS_TOL, PIPE_MODEL, batch,
                          check_pipeline_loss_and_grads, jax_mesh,
                          pipeline_engines, worst)

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.pipeline_lm import PipelineLMEngine as JP
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.parallel.mesh import (make_grid,
                                                  make_pipeline_mesh)
from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

LAYOUTS = [(1, 2, 1), (2, 2, 1)]
CASES = [(lay, s, a) for lay in LAYOUTS for s in ("gpipe", "1f1b", "zb")
         for a in ("xla", "flash")]


@pytest.mark.parametrize(
    "layout,schedule,attn", CASES,
    ids=[f"dp{x[0]}pp{x[1]}tp{x[2]}-{s}-{a}" for x, s, a in CASES])
def test_loss_and_grads_match_jax(layout, schedule, attn):
    dp, pp, tp = layout
    je, te = pipeline_engines(dp, pp, tp, schedule=schedule, attn=attn)
    check_pipeline_loss_and_grads(je, te)


def port_engine(dp=1, pp=2, tp=1, kw=None, n_mu=2, opt=None, **ekw):
    return PipelineLMEngine(
        T.TransformerConfig(**(kw or PIPE_MODEL)),
        opt or O.MomentumSGD(1e-2, momentum=0.9),
        make_pipeline_mesh(dp, pp, tp, "cpu"), n_mubatches=n_mu, seed=5,
        **ekw)


@pytest.mark.parametrize("attn,kw", [
    ("xla", None), ("flash", None),
    ("xla", dict(PIPE_MODEL, tie_embeddings=True, xent_chunk=48))])
def test_zb_gradients_equal_gpipe(attn, kw):
    """Within the port: the split backward's gradient is GPipe's."""
    tok, tgt = batch(96, 3, b=8)
    lg, gg = port_engine(2, 2, kw=kw, schedule="gpipe", attn=attn,
                         n_mu=4).loss_and_grads(tok, tgt)
    lz, gz = port_engine(2, 2, kw=kw, schedule="zb", attn=attn,
                         n_mu=4).loss_and_grads(tok, tgt)
    assert abs(float(lz) - float(lg)) <= 1e-5 * abs(float(lg))
    assert worst(gz, gg) <= 1e-5


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


@pytest.mark.parametrize("schedule,tp,k1", [
    ("gpipe", 1, 1), ("1f1b", 1, 2), ("zb", 1, 1), ("1f1b", 2, 2)])
def test_kernel_calls_per_schedule(kernel_calls, schedule, tp, k1):
    """One step at dp 2 x pp 2 (x tp), 4 layers, 2 microbatches: K2 and
    K3 once per layer, microbatch and replica (and tp cell); K1 as
    often, twice under 1f1b (its backward reruns the stage)."""
    eng = port_engine(2, 2, tp, schedule=schedule, attn="flash")
    eng.train_batch(*batch(96, 4, b=4))
    n = 4 * 2 * 2 * tp
    assert kernel_calls == {"flash_fwd": k1 * n, "flash_dq": n,
                            "flash_dkv": n}
    port_engine(2, 2, tp, schedule=schedule).train_batch(*batch(96, 4, b=4))
    assert kernel_calls["flash_fwd"] == k1 * n      # xla: none


@pytest.mark.parametrize("layout,schedule", [((2, 2, 1), "gpipe"),
                                             ((1, 2, 2), "1f1b"),
                                             ((2, 2, 1), "zb")])
def test_replicated_leaves_identical_on_every_cell(layout, schedule):
    """After three steps the embeddings, ln_f and head hold the same
    bits on every pp and tp cell, and a tp-replicated block leaf (a
    norm, a row bias) on every tp cell of its stage."""
    eng = port_engine(*layout, schedule=schedule,
                      opt=O.Adam(1e-2, grad_clip=0.5))
    for step in range(3):
        eng.train_batch(*batch(96, 30 + step, b=4))
    for i, spec in enumerate(eng._pspecs):
        if "tp" in spec.axes():
            continue
        groups = {}
        for c in eng.coords:
            groups.setdefault(eng._key(spec, eng._coord(c)), []).append(c)
        for cells in groups.values():
            first = eng._shards[cells[0]][i]
            for c in cells[1:]:
                assert torch.equal(eng._shards[c][i], first), (i, c)


@pytest.mark.parametrize("pp,n_mu", [(4, 2), (2, 4)])
def test_1f1b_stashes_at_most_min_pp_n_mu(pp, n_mu):
    eng = port_engine(1, pp, schedule="1f1b", n_mu=n_mu)
    eng.train_batch(*batch(96, 5, b=4))
    assert eng.peak_stash == min(pp, n_mu)


def test_dropout_masks_are_the_schedules_own():
    """gpipe and 1f1b draw the same masks (the same loss, gradients
    within f32 order); dropout changes the loss; eval draws none."""
    kw = dict(PIPE_MODEL, dropout=0.1)
    tok, tgt = batch(96, 6, b=4)
    lg, gg = port_engine(2, 2, kw=kw, schedule="gpipe").loss_and_grads(
        tok, tgt)
    l1, g1 = port_engine(2, 2, kw=kw, schedule="1f1b").loss_and_grads(
        tok, tgt)
    assert float(l1) == float(lg)
    assert worst(g1, gg) <= 1e-5
    clean = port_engine(2, 2, schedule="gpipe")
    assert float(clean.loss_and_grads(tok, tgt)[0]) != float(lg)
    assert port_engine(2, 2, kw=kw).eval_loss(tok, tgt) == \
        clean.eval_loss(tok, tgt)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_is_bit_identical(policy):
    kw = dict(PIPE_MODEL, remat=True, remat_policy=policy)
    tok, tgt = batch(96, 7, b=4)
    lr_, gr = port_engine(1, 2, kw=kw, schedule="1f1b",
                          attn="flash").loss_and_grads(tok, tgt)
    l0, g0 = port_engine(1, 2, schedule="1f1b",
                         attn="flash").loss_and_grads(tok, tgt)
    assert float(lr_) == float(l0)
    assert worst(gr, g0, absolute=True) == 0.0


def test_eval_loss_matches_jax():
    je, te = pipeline_engines(2, 2, schedule="1f1b", attn="flash")
    tok, tgt = batch(96, 8, b=4)
    assert abs(te.eval_loss(tok, tgt) - je.eval_loss(tok, tgt)) <= \
        LOSS_TOL * abs(je.eval_loss(tok, tgt))


REFUSED = {
    "mesh": ((("dp", "sp"), (1, 1)), {}, {}),
    "zb-tp": ((("dp", "pp", "tp"), (1, 2, 2)), {}, {"schedule": "zb"}),
    "zb-dropout": (None, {"dropout": 0.1}, {"schedule": "zb"}),
    "zb-remat": (None, {"remat": True}, {"schedule": "zb"}),
    "layers": (None, {"n_layers": 3}, {}),
    "heads-tp": ((("dp", "pp", "tp"), (1, 2, 3)), {}, {}),
    "zero1-zero2": ((("dp", "pp"), (2, 2)), {}, {"zero1": True,
                                                 "zero2": True}),
    "zero-dp1": (None, {}, {"zero2": True}),
    "ring-no-sp": (None, {}, {"attn": "ring"}),
    "attn-dropout": (None, {"attn_dropout": 0.1}, {}),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refusals_match_the_reference(name):
    """The reference constructor's asserts, message for message."""
    mesh, extra, ekw = REFUSED[name]
    names, shape = mesh or (("dp", "pp"), (1, 2))
    kw = dict(PIPE_MODEL, **extra)
    with pytest.raises(AssertionError) as want:
        JP(JT.TransformerConfig(**kw), JO.SGD(0.1), jax_mesh(names, shape),
           n_mubatches=2, **ekw)
    with pytest.raises(AssertionError) as got:
        PipelineLMEngine(T.TransformerConfig(**kw), O.SGD(0.1),
                         make_grid(names, shape, "cpu"), n_mubatches=2,
                         **ekw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh,extra,ekw", [
    ((("dp", "pp"), (1, 2)), {}, {"virtual_pp": 2}),
    ((("dp", "pp", "sp"), (1, 2, 2)), {}, {"attn": "ring"}),
    ((("dp", "pp", "ep"), (1, 2, 2)), {"n_experts": 4}, {}),
    ((("dp", "pp"), (1, 2)), {"n_experts": 4}, {}),
], ids=["vpp", "sp", "ep", "moe"])
def test_deferred_layouts_are_not_ported(mesh, extra, ekw):
    """The layouts an earlier slice deferred (interleaved stages, an sp
    or ep axis, MoE) build, take one step and match the JAX engine's
    loss (`tests/test_torch_pipeline_{vpp,sp,moe}.py` hold them
    further)."""
    kw = dict(PIPE_MODEL, **extra)
    je = JP(JT.TransformerConfig(**kw), JO.SGD(0.1), jax_mesh(*mesh),
            n_mubatches=2, **ekw)
    te = PipelineLMEngine(T.TransformerConfig(**kw), O.SGD(0.1),
                          make_grid(*mesh, "cpu"), n_mubatches=2, **ekw)
    tok, tgt = batch(96, 12, b=4)
    jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
    assert abs(tl - jl) <= LOSS_TOL * abs(jl), (tl, jl)
