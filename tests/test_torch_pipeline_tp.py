"""The port's `PipelineLMEngine` at four stages, with Megatron inside
each stage (a (dp, pp, tp) grid of the CPU) and with the model options
against the JAX package's engine on the same host mesh, weights and
batch: the loss and every gradient leaf (each schedule and substrate at
(1, 4); gpipe and 1f1b, xla and flash at (1, 2, 2)), a 3-step Adafactor
trajectory under tp, and each cell's blocks.

Tolerances (f32): the loss 1e-5 relative, each gradient leaf 1e-4
(`torch_parity.check_pipeline_loss_and_grads`); trajectories 1e-4
(`torch_parity.TRAJECTORY_TOL`)."""

import pytest
from torch_parity import (GSPMD_OPTS, PIPE_MODEL,
                          check_pipeline_loss_and_grads, pipeline_engines,
                          pipeline_trajectory, worst)

from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

CASES = ([((1, 4, 1), s, a) for s in ("gpipe", "1f1b", "zb")
          for a in ("xla", "flash")]
         + [((1, 2, 2), s, a) for s in ("gpipe", "1f1b")
            for a in ("xla", "flash")])


@pytest.mark.parametrize(
    "layout,schedule,attn", CASES,
    ids=[f"dp{x[0]}pp{x[1]}tp{x[2]}-{s}-{a}" for x, s, a in CASES])
def test_loss_and_grads_match_jax_at_pp4_and_tp(layout, schedule, attn):
    je, te = pipeline_engines(*layout, schedule=schedule, attn=attn)
    check_pipeline_loss_and_grads(je, te)


def test_trajectory_matches_jax_under_tp():
    """Adafactor per tp cell's block (the reference's shard_map step
    factors and clips each cell's columns or rows)."""
    opt, slots = GSPMD_OPTS["adafactor"]
    je, te = pipeline_engines(1, 2, 2, opt=opt, schedule="1f1b")
    pipeline_trajectory(je, te, slots)


def test_blocks_are_cut_over_pp_and_tp():
    """Each cell holds its stage's layers (and its tp columns / rows);
    the replicated leaves are whole copies; the canonical tree is the
    seed's draw."""
    eng = PipelineLMEngine(T.TransformerConfig(**PIPE_MODEL), O.SGD(0.1),
                           make_pipeline_mesh(1, 2, 2, "cpu"),
                           n_mubatches=2, seed=5)
    i_q = eng._index["blocks"]["q"]["W"]
    i_down = eng._index["blocks"]["down"]["W"]
    i_emb = eng._index["tok_emb"]
    for c in eng.coords:
        assert tuple(eng._shards[c][i_q].shape) == (2, 64, 32)
        assert tuple(eng._shards[c][i_down].shape) == (
            2, eng.cfg.ffn_dim // 2, 64)
        assert tuple(eng._shards[c][i_emb].shape) == (96, 64)
    assert worst(eng.get_canonical_params(), T.init_numpy(eng.cfg, 5),
                 absolute=True) == 0.0
