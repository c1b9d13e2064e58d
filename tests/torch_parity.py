"""Shared helpers of the port's parity tests (`tests/test_torch_train_*`,
`tests/test_torch_moe.py`, `tests/test_torch_context_*`): trees of
either package flattened by path, the worst leaf error, seeded batches,
the small model they train, and JAX / port `ContextParallelEngine`
pairs on a (dp, sp) mesh with their three-step trajectory check."""

import jax
import jax.numpy as jnp
import numpy as np
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
