"""Shared helpers of the port's parity tests (`tests/test_torch_train_*`,
`tests/test_torch_moe.py`, `tests/test_torch_context_*`, the GSPMD
family's `tests/test_torch_{tensor_parallel,fsdp,composite,
expert_parallel}.py`, the pipeline's `tests/test_torch_pipeline_*`):
trees of either package flattened by path, the worst leaf error, seeded
batches, the small models they train, and JAX / port engine pairs —
`ContextParallelEngine` on a (dp, sp) mesh, the GSPMD engines at one
layout, `PipelineLMEngine` at one layout — with the three-step
trajectory check and the loss-and-gradient check."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JaxEngine)
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh

# Torch on one intra-op thread for the whole process: the parity tests'
# ops are tiny, and the suite's workers share the host's cores with
# JAX's compiler, which idle OpenMP threads would spin against. Every
# test worker collects every test file, so this import-time call covers
# the suite; a test that needs more threads sets them itself.
torch.set_num_threads(1)


def flat(tree, prefix=""):
    """{path: numpy array} of a tree of dicts, lists and tuples (either
    package's; paths do not depend on leaf order)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float()
    return {prefix: np.asarray(tree, np.float64)}


def worst(got, ref, absolute=False):
    """Worst leaf error of `got` against `ref` (same paths)."""
    g, r = flat(got), flat(ref)
    assert g.keys() == r.keys()
    worst = 0.0
    for k in r:
        err = float(np.abs(g[k] - r[k]).max()) if r[k].size else 0.0
        scale = 1.0 if absolute else max(float(np.abs(r[k]).max()), 1e-30)
        worst = max(worst, err / scale if (err or not absolute) else 0.0)
    return worst


def batch(vocab, seed, b=2, t=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, t)).astype(np.int32),
            rng.integers(0, vocab, (b, t)).astype(np.int32))


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# the small model of the feature tests: GQA, RoPE, RMSNorm, SwiGLU
MODEL = dict(vocab=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
             max_seq=32, rope=True, norm="rmsnorm", ffn="swiglu")


# ------------------------------------------- (dp, sp) engine trajectories

# the trajectories' bound in f32: losses relative, parameters absolute,
# optimizer moments and slots relative per leaf
TRAJECTORY_TOL = 1e-4

# momentum SGD and factored Adafactor with clipping, not AdamW (ROADMAP
# Queue 3: AdamW turns the f32 noise of an exactly-zero gradient into
# +-lr updates); each with the state keys the trajectory compares
OPTS = {
    "momentum": (lambda M: M.MomentumSGD(M.warmup_cosine(1e-2, 1, 3),
                                         momentum=0.9, grad_clip=1.0),
                 ("v",)),
    "adafactor": (lambda M: M.Adafactor(1e-2, weight_decay=0.01,
                                        grad_clip=1.0), ("slots",)),
}


def model_for(attn, sp, **extra):
    """The small GQA model; MHA where Ulysses needs kv heads % sp."""
    kw = {**MODEL, **extra}
    if attn.startswith("ulysses") and kw["n_kv_heads"] % sp:
        kw["n_kv_heads"] = 0
    return kw


def engines(dp, sp, attn, opt, kw=None, seed=5, **ekw):
    """(JAX engine on a (dp, sp) host mesh, port engine on a (dp, sp)
    grid of the CPU), same config, optimizer, seed and options."""
    kw = kw or model_for(attn, sp)
    mesh = Mesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                ("dp", "sp"))
    je = JaxEngine(JT.TransformerConfig(**kw), opt(JO), mesh, seed=seed,
                   attn=attn, **ekw)
    te = ContextParallelEngine(T.TransformerConfig(**kw), opt(O), seed=seed,
                               attn=attn,
                               mesh=make_context_mesh(dp, sp, "cpu"), **ekw)
    return je, te


def trajectory(je, te, slots, steps=3, b=4):
    """`steps` steps of both engines on the same batches: losses,
    parameters, optimizer state and step counter within
    TRAJECTORY_TOL."""
    tol = TRAJECTORY_TOL
    for step in range(steps):
        tok, tgt = batch(te.cfg.vocab, 20 + step, b=b)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= tol, (step, tl, jl)
    assert worst(te.params, jax.device_get(je.params), absolute=True) <= tol
    jstate = jax.device_get(je.opt_state)
    tstate = te.opt_state
    assert tstate["t"] == int(jstate["t"]) == steps
    for key in slots:
        assert worst(tstate[key], jstate[key]) <= tol


# ------------------------------------------ GSPMD engines (tp/fsdp/3d/ep)

# the small MoE model of the expert-parallel tests
MOE_MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, max_seq=32,
                 n_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
                 moe_z_weight=1e-3)

# SGD with a schedule and clipping, momentum, and Adafactor: the cross-
# package trajectories' optimizers. The GSPMD placements leave a sharded
# matrix unfactored (the reference's rule), and an unfactored leaf's
# first step with the default eps (1e-30) is sign(g): the f32 noise of a
# gradient element that is ~0 in exact arithmetic then picks +-lr x
# scale (ROADMAP Queue 3, AdamW's divergence). eps 1e-6 keeps those
# elements' update linear in g, so the trajectory compares the
# algorithm, factored and unfactored leaves alike.
GSPMD_OPTS = {
    "momentum": OPTS["momentum"],
    "adafactor": (lambda M: M.Adafactor(1e-2, weight_decay=0.01,
                                        grad_clip=1.0, eps=1e-6),
                  ("slots",)),
    "sgd": (lambda M: M.SGD(M.warmup_linear(5e-2, 1, 3), grad_clip=1.0),
            ()),
}


def _gspmd_kinds():
    from shallowspeed_tpu.parallel.composite import Composite3DEngine as J3
    from shallowspeed_tpu.parallel.expert import ExpertParallelEngine as JE
    from shallowspeed_tpu.parallel.fsdp import FSDPEngine as JF
    from shallowspeed_tpu.parallel.tensor import TensorParallelEngine as JT_
    from shallowspeed_tpu_torch.parallel.composite import Composite3DEngine
    from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine
    from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine
    from shallowspeed_tpu_torch.parallel.tensor import TensorParallelEngine

    return {"tp": (JT_, TensorParallelEngine, ("dp", "tp")),
            "fsdp": (JF, FSDPEngine, ("dp",)),
            "3d": (J3, Composite3DEngine, ("dp", "sp", "tp")),
            "ep": (JE, ExpertParallelEngine, ("dp", "ep")),
            "ep3": (JE, ExpertParallelEngine, ("dp", "sp", "ep"))}


def jax_mesh(names, shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def gspmd_engines(kind, shape, opt, kw=None, seed=5, **ekw):
    """(JAX engine on a host mesh, port engine on a grid of the CPU) of
    one GSPMD family member at one layout, same config, optimizer, seed
    and options. `kind`: tp, fsdp, 3d, ep or ep3 ((dp, sp, ep))."""
    from shallowspeed_tpu_torch.parallel.mesh import make_grid

    jcls, tcls, names = _gspmd_kinds()[kind]
    kw = kw or (MOE_MODEL if kind.startswith("ep") else MODEL)
    je = jcls(JT.TransformerConfig(**kw), opt(JO), jax_mesh(names, shape),
              seed=seed, **ekw)
    te = tcls(T.TransformerConfig(**kw), opt(O), seed,
              mesh=make_grid(names, shape, "cpu"), **ekw)
    return je, te


def jax_loss_and_grads(je, tok, tgt):
    """The JAX engine's loss and gradient at its current parameters (its
    global `T.loss`, as its step differentiates it)."""
    cfg = je.cfg
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, a, b: JT.loss(p, a, b, cfg)))(je.params, jnp.asarray(tok),
                                                jnp.asarray(tgt))
    return float(loss), jax.device_get(grads)


# loss (relative) and gradient (relative per leaf) bounds of a GSPMD
# engine against JAX's at the same layout, f32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def check_loss_and_grads(je, te, b=4, seed=11):
    """The loss at init and every gradient leaf against the JAX engine's
    on one batch."""
    tok, tgt = batch(te.cfg.vocab, seed, b=b)
    jl, jg = jax_loss_and_grads(je, tok, tgt)
    tl, tg = te.loss_and_grads(tok, tgt)
    assert abs(float(tl) - jl) / abs(jl) <= LOSS_TOL, (float(tl), jl)
    assert worst(tg, jg) <= GRAD_TOL


# ------------------------------------------------------- the LM pipeline

# the pipeline tests' model: GQA, RoPE, RMSNorm, SwiGLU at 4 layers (pp
# up to 4)
PIPE_MODEL = dict(MODEL, n_layers=4)

# the JAX engine's gradient, read off one plain-SGD step at this rate:
# p - LR g is exact to f32 rounding of a term 1e3x the parameter, so
# (p0 - p1) / LR is g to ~1e-7 of each leaf's largest element
SGD_PROBE_LR = 1e3


def pipeline_engines(dp, pp, tp=1, opt=None, kw=None, seed=5, n_mu=2,
                     sp=1, ep=1, **ekw):
    """(JAX `PipelineLMEngine` on a host mesh, the port's on a grid of the
    CPU), same config, optimizer (default: SGD at SGD_PROBE_LR), seed,
    microbatches and options (schedule, attn, virtual_pp,
    zero1/zero2/fsdp, health); a third axis "tp", "sp" or "ep" where
    its size is above 1."""
    from shallowspeed_tpu.parallel.pipeline_lm import PipelineLMEngine as JP
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    kw = kw or PIPE_MODEL
    opt = opt or (lambda M: M.SGD(SGD_PROBE_LR))
    grid = make_pipeline_mesh(dp, pp, tp, "cpu", sp=sp, ep=ep)
    je = JP(JT.TransformerConfig(**kw), opt(JO),
            jax_mesh(grid.axis_names, grid.devices.shape),
            n_mubatches=n_mu, seed=seed, **ekw)
    te = PipelineLMEngine(T.TransformerConfig(**kw), opt(O), grid,
                          n_mubatches=n_mu, seed=seed, **ekw)
    return je, te


def jax_pipeline_loss_and_grads(je, tok, tgt):
    """The JAX pipeline engine's loss and canonical gradient on one
    batch, through its own step: it must hold SGD at SGD_PROBE_LR (the
    step moves its parameters)."""
    p0 = jax.device_get(je.get_canonical_params())
    loss = je.train_batch(tok, tgt)
    p1 = jax.device_get(je.get_canonical_params())
    return loss, jax.tree_util.tree_map(
        lambda a, b: (np.asarray(a, np.float64) - np.asarray(b, np.float64))
        / SGD_PROBE_LR, p0, p1)


def check_pipeline_loss_and_grads(je, te, b=4, seed=11):
    """The loss at init and every canonical gradient leaf of the port's
    pipeline engine against the JAX one's (which must hold SGD at
    SGD_PROBE_LR) on one batch."""
    tok, tgt = batch(te.cfg.vocab, seed, b=b)
    jl, jg = jax_pipeline_loss_and_grads(je, tok, tgt)
    tl, tg = te.loss_and_grads(tok, tgt)
    assert abs(float(tl) - jl) / abs(jl) <= LOSS_TOL, (float(tl), jl)
    assert worst(tg, jg) <= GRAD_TOL


def pipeline_trajectory(je, te, slots, steps=3, b=4):
    """`trajectory` for the pipeline engines: their canonical parameters
    and their stacked optimizer states."""
    tol = TRAJECTORY_TOL
    for step in range(steps):
        tok, tgt = batch(te.cfg.vocab, 20 + step, b=b)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= tol, (step, tl, jl)
    assert worst(te.get_canonical_params(),
                 jax.device_get(je.get_canonical_params()),
                 absolute=True) <= tol
    jstate, tstate = jax.device_get(je.opt_state), te.opt_state
    if isinstance(tstate, dict) and "t" in tstate:
        assert tstate["t"] == int(jstate["t"]) == steps
    for key in slots:
        assert worst(tstate[key], jstate[key]) <= tol


# ----------------------------------------------- the reference's overlap

_OVERLAP_MOD = "shallowspeed_tpu.parallel.overlap"
_WALKER_MOD = "shallowspeed_tpu.analysis.walker"


@pytest.fixture
def ref_overlap(monkeypatch):
    """The JAX package's `parallel.overlap` module, importable for one
    test: its `analysis.walker` reads `jax.core.ClosedJaxpr`, gone in jax
    0.9 (ROADMAP Queue 3), so a stub walker stands in (only
    `collective_exposure` uses its three names). Every module the import
    brings in under `shallowspeed_tpu.analysis` or as the overlap module
    leaves `sys.modules` and its parent package's attributes after the
    test, so no other test file sees the stub or the module."""
    import importlib

    walker = types.ModuleType(_WALKER_MOD)
    walker._as_jaxpr = walker.aval_bytes = walker.sub_jaxprs = None
    before = set(sys.modules)
    monkeypatch.setitem(sys.modules, _WALKER_MOD, walker)
    monkeypatch.delitem(sys.modules, _OVERLAP_MOD, raising=False)
    try:
        yield importlib.import_module(_OVERLAP_MOD)
    finally:
        for name in sorted(set(sys.modules) - before, reverse=True):
            if name == _OVERLAP_MOD or name.startswith(
                    "shallowspeed_tpu.analysis"):
                mod = sys.modules.pop(name)
                parent, _, leaf = name.rpartition(".")
                if getattr(sys.modules.get(parent), leaf, None) is mod:
                    delattr(sys.modules[parent], leaf)
