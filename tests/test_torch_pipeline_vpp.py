"""Interleaved virtual stages in the port's `PipelineLMEngine`
(`virtual_pp` > 1 over a (dp, pp[, tp]) grid of the CPU) against the
JAX package's on the same host mesh, weights and batch: the placement
permutation; the loss and every gradient leaf of gpipe and 1f1b at
(dp, pp, vpp) in {(1, 2, 2), (2, 2, 2)} on the plain substrate, and
once under flash; a vpp x tp and a MoE trajectory; within the port,
vpp 1f1b against vpp gpipe with dropout and the 1F1B stash against the
interleaved tables; checkpoints across vpp, vpp 1 and the JAX package
both ways, once under ZeRO-2 at dp 2; the vpp greedy decode. Its
trajectories under ZeRO-1/2, FSDP, remat and chunked cross-entropy are
in `test_torch_pipeline_zero.py`.

Tolerances (f32): the loss 1e-5 relative, each gradient leaf 1e-4
relative (`torch_parity.LOSS_TOL` / `GRAD_TOL`); trajectories 1e-4
(`TRAJECTORY_TOL`); 1f1b against gpipe 1e-5; checkpoints restore bit for
bit; greedy streams token for token."""

import jax
import numpy as np
import pytest
from torch_parity import (GSPMD_OPTS, PIPE_MODEL, batch,
                          check_pipeline_loss_and_grads, flat,
                          pipeline_engines, pipeline_trajectory, worst)

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import generate
from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
from shallowspeed_tpu_torch.parallel.pipeline_lm import (PipelineLMEngine,
                                                         interleave_perm)
from shallowspeed_tpu_torch.parallel.verify import interleaved_tables

CASES = [(lay, s) for lay in ((1, 2, 2), (2, 2, 2))
         for s in ("gpipe", "1f1b")]


def test_placement_permutation_is_the_references():
    """Stacked position d (vpp Lc) + v Lc + j holds layer (v pp + d) Lc
    + j: the reference engine's own `_perm`, and its inverse."""
    je, te = pipeline_engines(1, 2, virtual_pp=2)
    assert np.array_equal(te._perm, je._perm)
    assert np.array_equal(te._inv_perm, je._inv_perm)
    assert interleave_perm(8, 2, 2).tolist() == [0, 1, 4, 5, 2, 3, 6, 7]
    assert interleave_perm(8, 4, 2).tolist() == [0, 4, 1, 5, 2, 6, 3, 7]
    assert interleave_perm(4, 2, 1).tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("layout,schedule", CASES,
                         ids=[f"dp{x[0]}pp{x[1]}vpp{x[2]}-{s}"
                              for x, s in CASES])
def test_loss_and_grads_match_jax(layout, schedule):
    dp, pp, vpp = layout
    je, te = pipeline_engines(dp, pp, schedule=schedule, virtual_pp=vpp)
    check_pipeline_loss_and_grads(je, te)


def test_flash_1f1b_matches_jax():
    """K1/K2/K3 (their plain versions here; Pallas interpret mode on the
    JAX side) in every chunk, 1f1b rerunning each chunk's forward."""
    je, te = pipeline_engines(1, 2, schedule="1f1b", attn="flash",
                              virtual_pp=2)
    check_pipeline_loss_and_grads(je, te)


@pytest.mark.parametrize("name,tp,kw,schedule,optname", [
    ("tp2", 2, PIPE_MODEL, "1f1b", "momentum"),
    ("moe", 1, dict(PIPE_MODEL, n_experts=4), "1f1b", "sgd")])
def test_trajectory_matches_jax(name, tp, kw, schedule, optname):
    """vpp composes with tp (the Megatron operators inside each chunk)
    and with MoE (every chunk's weighted aux in the objective): three
    steps of losses, parameters and optimizer state."""
    opt, slots = GSPMD_OPTS[optname]
    je, te = pipeline_engines(1, 2, tp, opt=opt, kw=kw, schedule=schedule,
                              virtual_pp=2)
    pipeline_trajectory(je, te, slots)


def port_engine(pp=2, vpp=2, kw=None, n_mu=2, opt=None, dp=1, **ekw):
    return PipelineLMEngine(
        T.TransformerConfig(**(kw or PIPE_MODEL)),
        opt or O.MomentumSGD(1e-2, momentum=0.9),
        make_pipeline_mesh(dp, pp, devices="cpu"), n_mubatches=n_mu, seed=5,
        virtual_pp=vpp, **ekw)


def test_1f1b_matches_gpipe_with_dropout():
    """The two interleaved schedules draw the same masks (each chunk's
    key folds in its chunk index): the same loss, gradients within f32
    order; the masks move the loss."""
    kw = dict(PIPE_MODEL, dropout=0.1)
    tok, tgt = batch(96, 6, b=8)
    lg, gg = port_engine(kw=kw, n_mu=4).loss_and_grads(tok, tgt)
    l1, g1 = port_engine(kw=kw, n_mu=4, schedule="1f1b").loss_and_grads(
        tok, tgt)
    assert float(l1) == float(lg)
    assert worst(g1, gg) <= 1e-5
    clean = port_engine(n_mu=4)
    assert float(clean.loss_and_grads(tok, tgt)[0]) != float(lg)


@pytest.mark.parametrize("n_mu,pp,vpp", [(4, 2, 2), (2, 2, 2), (8, 2, 2),
                                         (4, 4, 2)])
def test_1f1b_stash_is_the_tables_bound(n_mu, pp, vpp):
    """The interleaved 1F1B holds at most the tables' n_stash_slots chunk
    inputs on a cell, and reaches it."""
    kw = dict(PIPE_MODEL, d_model=32, n_layers=pp * vpp)
    eng = port_engine(pp, vpp, kw=kw, n_mu=n_mu, schedule="1f1b")
    eng.train_batch(*batch(96, 5, b=n_mu))
    assert eng.peak_stash == interleaved_tables(n_mu, pp, vpp).n_stash_slots


def _bits(got, want):
    fg, fw = flat(got), flat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        assert np.array_equal(fg[k], fw[k]), k


def test_port_vpp_checkpoint_crosses_to_vpp1_and_jax(tmp_path):
    """A port vpp-2 save restores bit for bit into a port pp-4 (vpp 1)
    engine and into the JAX vpp-2 engine, parameters and the stacked
    optimizer state through the inverse permutation; all three continue
    together."""
    opt, _ = GSPMD_OPTS["momentum"]
    je, _ = pipeline_engines(1, 2, opt=opt, virtual_pp=2, seed=9)
    src = port_engine(opt=opt(O), schedule="1f1b")
    for s in range(2):
        src.train_batch(*batch(96, 80 + s, b=4))
    C.save(tmp_path, src, 1)
    one = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), opt(O),
                           make_pipeline_mesh(1, 4, devices="cpu"),
                           n_mubatches=2, seed=9)
    assert C.restore(one, tmp_path / "ckpt_1") == 2
    JC.restore(je, tmp_path / "ckpt_1")
    want = src.get_canonical_params()
    _bits(one.get_canonical_params(), want)
    _bits(jax.device_get(je.get_canonical_params()), want)
    _bits(one.canon_export_tree(one.opt_state["v"]),
          src.canon_export_tree(src.opt_state["v"]))
    _bits(jax.device_get(je.opt_state["v"]), src.opt_state["v"])
    for s in (2, 3):
        tok, tgt = batch(96, 80 + s, b=4)
        ls = src.train_batch(tok, tgt)
        assert abs(one.train_batch(tok, tgt) - ls) <= 1e-4 * abs(ls)
        assert abs(je.train_batch(tok, tgt) - ls) <= 1e-4 * abs(ls)


def test_jax_and_vpp1_checkpoints_restore_into_port_vpp(tmp_path):
    """The JAX vpp-2 engine's save, and a port pp-2 (vpp 1) save, each
    restore bit for bit into the port's vpp-2 engine, which continues
    with the JAX one."""
    opt, _ = GSPMD_OPTS["momentum"]
    je, te = pipeline_engines(1, 2, opt=opt, virtual_pp=2,
                              schedule="1f1b")
    for s in range(2):
        je.train_batch(*batch(96, 90 + s, b=4))
    JC.save(tmp_path / "jax", je, 1)
    assert C.restore(te, tmp_path / "jax" / "ckpt_1") == 2
    _bits(te.get_canonical_params(),
          jax.device_get(je.get_canonical_params()))
    _bits(te.opt_state, jax.device_get(je.opt_state))
    for s in (2, 3):
        tok, tgt = batch(96, 90 + s, b=4)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) <= 1e-4 * abs(jl)
    plain = port_engine(vpp=1, opt=opt(O))
    plain.train_batch(*batch(96, 95, b=4))
    C.save(tmp_path / "port", plain, 1)
    vpp = port_engine(opt=opt(O))
    assert C.restore(vpp, tmp_path / "port" / "ckpt_1") == 2
    _bits(vpp.get_canonical_params(), plain.get_canonical_params())
    _bits(vpp.canon_export_tree(vpp.opt_state["v"]),
          plain.canon_export_tree(plain.opt_state["v"]))


def test_zero2_vpp_checkpoint_crosses_to_vpp1_and_jax(tmp_path):
    """A port dp 2 x vpp 2 ZeRO-2 save restores bit for bit into a port
    dp 2 x pp 4 (vpp 1) ZeRO-2 engine and into the JAX dp 2 x vpp 2 one,
    the sliced optimizer state through the inverse permutation; all
    three continue together."""
    opt, _ = GSPMD_OPTS["momentum"]
    je, src = pipeline_engines(2, 2, opt=opt, virtual_pp=2, seed=9,
                               zero2=True, schedule="1f1b")
    for s in range(2):
        src.train_batch(*batch(96, 60 + s, b=4))
    C.save(tmp_path, src, 1)
    one = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), opt(O),
                           make_pipeline_mesh(2, 4, devices="cpu"),
                           n_mubatches=2, seed=9, zero2=True)
    assert C.restore(one, tmp_path / "ckpt_1") == 2
    JC.restore(je, tmp_path / "ckpt_1")
    want = src.get_canonical_params()
    _bits(one.get_canonical_params(), want)
    _bits(jax.device_get(je.get_canonical_params()), want)
    _bits(one.canon_export_tree(one.opt_state["v"]),
          src.canon_export_tree(src.opt_state["v"]))
    _bits(jax.device_get(je.opt_state["v"]), src.opt_state["v"])
    for s in (2, 3):
        tok, tgt = batch(96, 60 + s, b=4)
        ls = src.train_batch(tok, tgt)
        assert abs(one.train_batch(tok, tgt) - ls) <= 1e-4 * abs(ls)
        assert abs(je.train_batch(tok, tgt) - ls) <= 1e-4 * abs(ls)


def test_vpp_decode_matches_jax_and_generate():
    """Greedy streams token for token at dp 2 x pp 2 x vpp 2 (a token
    makes four phases, the last chunk's hidden state back on cell 0):
    the JAX engine's pipelined decode, the port's, and the port's
    one-device `generate` on the canonical parameters."""
    je, te = pipeline_engines(2, 2, virtual_pp=2,
                              opt=GSPMD_OPTS["momentum"][0])
    tok, tgt = batch(96, 71, b=4)
    je.train_batch(tok, tgt)
    te.train_batch(tok, tgt)
    prompt = batch(96, 9, b=3, t=5)[0]
    want = np.asarray(je.generate(prompt, 10, temperature=0.0))
    got = te.generate(prompt, 10, temperature=0.0)
    assert got.shape == (3, 10)
    assert np.array_equal(got, want)
    assert np.array_equal(got, generate(te.get_canonical_params(), prompt,
                                        te.cfg, 10, temperature=0.0))
