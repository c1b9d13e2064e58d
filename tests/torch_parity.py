"""Shared helpers of the port's parity tests (`tests/test_torch_train_*`,
`tests/test_torch_moe.py`): trees of either package flattened by path,
the worst leaf error, seeded batches, and the small model they train."""

import jax
import jax.numpy as jnp
import numpy as np
import torch


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
