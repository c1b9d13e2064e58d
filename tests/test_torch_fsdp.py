"""The port's `FSDPEngine` (ZeRO-3 over a (dp,) grid of the CPU) against
the JAX package's on the same host mesh, and its pieces: `add_dp` and
`fsdp_spec` against the reference's functions, each cell's pieces, the
just-in-time gathers, checkpoints across the packages and across the
port's layouts.

Tolerances (f32): the loss at init 1e-5 relative and every gradient
leaf 1e-4 relative; 3-step trajectories under SGD, momentum and
Adafactor (`torch_parity.GSPMD_OPTS`) within 1e-4; checkpoints bit for
bit, then losses within 1e-4; a resumed run's losses within 2e-4 (the
drivers' 4-digit step lines) of a straight run's.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from torch_parity import (GSPMD_OPTS, MODEL, batch, check_loss_and_grads,
                          gspmd_engines, trajectory, worst)

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu.parallel import fsdp as JF
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel import fsdp as F
from shallowspeed_tpu_torch.parallel import gspmd as G
from shallowspeed_tpu_torch.parallel.gspmd import P
from shallowspeed_tpu_torch.parallel.mesh import make_fsdp_mesh, make_tp_mesh
from shallowspeed_tpu_torch.parallel.overlap import OverlapConfig
from shallowspeed_tpu_torch.parallel.tensor import TensorParallelEngine
from shallowspeed_tpu_torch.weights import leaves

SHAPES = [(), (7,), (8,), (64, 64), (64, 256), (256, 64), (3, 5), (6, 4),
          (4, 6), (96, 64, 8), (0, 4)]
BASES = [(), (None, "tp"), ("tp", None), ("tp",), (None, None, "ep")]


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_add_dp_and_fsdp_spec_equal_the_reference(dp):
    """The largest free divisible dimension (the higher index on a tie),
    else the spec unchanged, for every shape and base spec."""
    for shape in SHAPES:
        want = tuple(JF.fsdp_spec(shape, dp))
        assert tuple(F.fsdp_spec(shape, dp)) == want, shape
        for base in BASES:
            if len(base) > len(shape):
                continue
            got = F.add_dp(P(*base), shape, dp)
            ref = JF.add_dp(PartitionSpec(*base), shape, dp)
            assert tuple(got) == tuple(ref), (shape, base)


@pytest.mark.parametrize("dp", [2, 4])
def test_placement_and_pieces(dp):
    """Every leaf's spec is `fsdp_spec` of its shape (the JAX engine's
    placement); each cell holds 1/dp of every leaf dp divides, and its
    moments with it; a cell's pieces gather back to the canonical
    tree."""
    je, te = gspmd_engines("fsdp", (dp,), lambda M: M.Adam(1e-3))
    jspecs = jax.tree_util.tree_map(lambda a: tuple(a.sharding.spec),
                                    je.params)
    ref = dict(_flat(jspecs))
    got = dict(_flat(te.specs))
    assert got.keys() == ref.keys()
    for path, spec in got.items():
        n = max(len(spec), len(ref[path]))
        assert spec.padded(n) == ref[path] + (None,) * (n - len(ref[path])), \
            path
    total = sum(m.numel() for m in leaves(te._template))
    for c in te.coords:
        params, state = te.cell_bytes()[c]
        assert params < 4 * total / dp * 1.05
        assert state < 2 * params * 1.01
    assert worst(te.get_canonical_params(), jax.device_get(je.params)) == 0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dp", [2, 4])
def test_loss_and_grads_match_jax(dp):
    je, te = gspmd_engines("fsdp", (dp,), GSPMD_OPTS["momentum"][0])
    check_loss_and_grads(je, te)


@pytest.mark.parametrize("dp,optname", [(2, "momentum"), (2, "adafactor"),
                                        (2, "sgd"), (4, "adafactor")],
                         ids=lambda x: str(x))
def test_trajectory_matches_jax(dp, optname):
    opt, slots = GSPMD_OPTS[optname]
    je, te = gspmd_engines("fsdp", (dp,), opt)
    trajectory(je, te, slots)


def test_gathered_copies_are_freed(monkeypatch):
    """The forward gathers each block's pieces just in time and the
    autograd graph keeps the pieces, gathering again for the backward
    (the saved-tensor hook); the gradients stay those of the forward's
    copies (equal to the unhooked engine's bit for bit)."""
    cfg = T.TransformerConfig(**MODEL)
    tok, tgt = batch(cfg.vocab, 3, b=4)
    eng = F.FSDPEngine(cfg, O.SGD(0.1), mesh=make_fsdp_mesh(2, "cpu"))
    calls = []
    orig = G._Regather.gather
    monkeypatch.setattr(G._Regather, "gather",
                        lambda self: calls.append(1) or orig(self))
    loss, grads = eng.loss_and_grads(tok, tgt)
    # every block's qkv/proj/up/gate/down and the head, in each replica
    assert len(calls) >= 2 * (5 * cfg.n_layers + 1)
    monkeypatch.setattr(G, "_pack", lambda t: t)
    loss2, grads2 = eng.loss_and_grads(tok, tgt)
    assert float(loss) == float(loss2)
    assert worst(grads, grads2) == 0.0


def test_refusals():
    """ZeRO-1/2 on top of FSDP, a non-('dp',) grid, and the overlapped
    step with Adafactor, with the reference's messages."""
    cfg = T.TransformerConfig(**MODEL)
    with pytest.raises(ValueError, match="ZeRO-3 is a superset"):
        F.FSDPEngine(cfg, O.SGD(0.1), mesh=make_fsdp_mesh(2, "cpu"),
                     zero1=True)
    with pytest.raises(ValueError, match="1-D"):
        F.FSDPEngine(cfg, O.SGD(0.1), mesh=make_tp_mesh(2, 1, "cpu"))
    with pytest.raises(ValueError, match="Adafactor"):
        F.FSDPEngine(cfg, O.Adafactor(0.1), mesh=make_fsdp_mesh(2, "cpu"),
                     overlap=OverlapConfig())


def test_port_checkpoint_restores_into_jax(tmp_path):
    """A port FSDPEngine (dp 2, AdamW) checkpoint restores into the JAX
    FSDPEngine at the same layout bit for bit with no re-initialization;
    both continue within 1e-4."""
    def opt(M):
        return M.AdamW(1e-3, weight_decay=0.01)

    _, te = gspmd_engines("fsdp", (2,), opt, seed=5)
    je, _ = gspmd_engines("fsdp", (2,), opt, seed=9)
    for s in range(2):
        te.train_batch(*batch(te.cfg.vocab, 60 + s, b=4))
    C.save(tmp_path, te, 1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert JC.restore(je, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    jstate = jax.device_get(je.opt_state)
    assert worst(te.params, jax.device_get(je.params)) == 0.0
    assert worst({k: te.opt_state[k] for k in "mv"},
                 {k: jstate[k] for k in "mv"}) == 0.0
    for s in (2, 3):
        tok, tgt = batch(te.cfg.vocab, 60 + s, b=4)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-4


def test_port_checkpoint_crosses_layouts(tmp_path):
    """Within the port: a (dp 2, tp 2) TensorParallelEngine checkpoint
    (AdamW, ZeRO-1: its moments sliced over dp on a free dimension)
    restores into a dp 4 FSDPEngine, which slices every leaf and moment
    another way, bit for bit; the restored run continues a straight
    (dp 2, tp 2) run's losses within 2e-4."""
    cfg = T.TransformerConfig(**MODEL)

    def opt():
        return O.AdamW(1e-3, weight_decay=0.01, grad_clip=1.0)

    src = TensorParallelEngine(cfg, opt(), 5, mesh=make_tp_mesh(2, 2, "cpu"),
                               zero1=True)
    for s in range(2):
        src.train_batch(*batch(cfg.vocab, 70 + s, b=4))
    C.save(tmp_path, src, 1)
    dst = F.FSDPEngine(cfg, opt(), 9, mesh=make_fsdp_mesh(4, "cpu"))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert C.restore(dst, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    assert worst(dst.params, src.params) == 0.0
    s_state, d_state = src.opt_state, dst.opt_state
    assert worst({k: d_state[k] for k in "mv"},
                 {k: s_state[k] for k in "mv"}) == 0.0
    assert d_state["t"] == s_state["t"] == 2
    for s in (2, 3):
        tok, tgt = batch(cfg.vocab, 70 + s, b=4)
        assert dst.train_batch(tok, tgt) == pytest.approx(
            src.train_batch(tok, tgt), abs=2e-4)
    assert isinstance(dst.opt_state["m"]["tok_emb"], torch.Tensor)
    assert not np.isnan(float(dst.eval_loss(tok, tgt)))
