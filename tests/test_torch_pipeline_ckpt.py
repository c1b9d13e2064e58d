"""The port's `PipelineLMEngine` over steps and across packages: 3-step
trajectories against the JAX engine for each schedule (momentum, SGD
with its schedule, Adafactor — ROADMAP Queue 3's AdamW divergence keeps
AdamW out; without ZeRO every cell steps its own blocks, as the
reference's shard_map step), checkpoints both ways (a JAX pipeline save
restored in the port's pipeline, a port pipeline save restored in the
port's one-device engine), and the pipelined decode's greedy streams
against the JAX engine's `generate` and the port's
`models.generate.generate`.

Tolerances (f32): trajectories 1e-4 (`torch_parity.TRAJECTORY_TOL`);
checkpoints restore bit for bit and continue within 1e-4; greedy
streams token for token."""

import warnings

import jax
import numpy as np
import pytest
from torch_parity import (GSPMD_OPTS, PIPE_MODEL, batch, flat,
                          pipeline_engines, pipeline_trajectory)

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import generate
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import (make_context_mesh,
                                                  make_pipeline_mesh)
from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

TRAJ = [((1, 2), "gpipe", "xla", "momentum"),
        ((2, 2), "1f1b", "flash", "sgd"),
        ((1, 4), "zb", "xla", "adafactor")]


@pytest.mark.parametrize(
    "layout,schedule,attn,optname", TRAJ,
    ids=[f"dp{x[0]}pp{x[1]}-{s}-{a}-{o}" for x, s, a, o in TRAJ])
def test_trajectory_matches_jax(layout, schedule, attn, optname):
    opt, slots = GSPMD_OPTS[optname]
    je, te = pipeline_engines(*layout, opt=opt, schedule=schedule,
                              attn=attn)
    pipeline_trajectory(je, te, slots)


def _bits(got, want):
    fg, fw = flat(got), flat(want)
    assert fg.keys() == fw.keys()
    for k in fw:
        assert np.array_equal(fg[k], fw[k]), k


def test_jax_pipeline_checkpoint_restores_into_the_port(tmp_path):
    """A JAX (2, 2) 1f1b engine's checkpoint restores into the port's
    (2, 2) engine bit for bit (its stacked optimizer state as it is) and
    both continue together."""
    opt, _ = GSPMD_OPTS["momentum"]
    je, _ = pipeline_engines(2, 2, opt=opt, schedule="1f1b")
    for s in range(2):
        je.train_batch(*batch(96, 50 + s, b=4))
    JC.save(tmp_path, je, 1)
    te = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), opt(O),
                          make_pipeline_mesh(2, 2, devices="cpu"),
                          n_mubatches=2, seed=9, schedule="zb")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert C.restore(te, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    _bits(te.get_canonical_params(),
          jax.device_get(je.get_canonical_params()))
    _bits(te.opt_state, jax.device_get(je.opt_state))
    for s in (2, 3):
        tok, tgt = batch(96, 50 + s, b=4)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-4


def test_port_pipeline_checkpoint_restores_one_device(tmp_path):
    """The port's (2, 2, 2) ZeRO-1 pipeline saves its canonical params
    and canonical optimizer record; the port's one-device engine
    restores both bit for bit and continues as the pipeline does."""
    opt, _ = GSPMD_OPTS["momentum"]
    src = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), opt(O),
                           make_pipeline_mesh(2, 2, 2, "cpu"),
                           n_mubatches=2, schedule="1f1b", zero1=True)
    for s in range(2):
        src.train_batch(*batch(96, 60 + s, b=4))
    C.save(tmp_path, src, 1)
    dst = ContextParallelEngine(T.TransformerConfig(**PIPE_MODEL), opt(O),
                                seed=9, attn="ring",
                                mesh=make_context_mesh(1, 1, "cpu"))
    assert C.restore(dst, tmp_path / "ckpt_1") == 2
    _bits(dst.get_canonical_params(), src.get_canonical_params())
    _bits(dst.opt_state["v"], src.canon_export_tree(src.opt_state["v"]))
    for s in (2, 3):
        tok, tgt = batch(96, 60 + s, b=4)
        want = src.train_batch(tok, tgt)
        assert abs(dst.train_batch(tok, tgt) - want) <= 1e-4 * abs(want)


def test_pipelined_decode_matches_jax_and_generate():
    """Greedy streams token for token at dp 2 x pp 4: the JAX engine's
    pipelined decode, the port's, and the port's one-device `generate`
    on the canonical parameters (the odd batch padded to dp as the
    reference pads it); sampled streams equal `generate`'s too."""
    layout, b = (2, 4), 3
    je, te = pipeline_engines(*layout, 1, schedule="gpipe")
    for s in range(2):
        tok, tgt = batch(96, 70 + s, b=4 * layout[0])
        je.train_batch(tok, tgt)
        te.train_batch(tok, tgt)
    prompt = batch(96, 9, b=b, t=5)[0]
    want = np.asarray(je.generate(prompt, 10, temperature=0.0))
    got = te.generate(prompt, 10, temperature=0.0)
    assert got.shape == (b, 10)
    assert np.array_equal(got, want)
    assert np.array_equal(got, generate(te.get_canonical_params(), prompt,
                                        te.cfg, 10, temperature=0.0))
    sampled = te.generate(prompt, 10, temperature=1.0, seed=3)
    assert np.array_equal(sampled, generate(
        te.get_canonical_params(), prompt, te.cfg, 10, temperature=1.0,
        seed=3))


@pytest.mark.parametrize("layout,ekw,msg", [
    ((1, 2, 2), {}, "pipelined decode supports"),
    ((2, 2, 1), {"fsdp": True}, "stage-resident params")])
def test_pipelined_decode_refusals(layout, ekw, msg):
    eng = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), O.SGD(0.1),
                           make_pipeline_mesh(*layout, "cpu"),
                           n_mubatches=2, **ekw)
    with pytest.raises(AssertionError, match=msg):
        eng.generate(batch(96, 1, b=2, t=4)[0], 4)
