"""Carry a parameter tree between the two packages.

Both packages keep the same layout: a nested dict (blocks in a list) of
dense leaves {"W": (K, N), "b": (N,)} applied as `y = x @ W + b`, plus
norm scales and embeddings. So moving weights across is a copy, never
a transpose.
"""

from __future__ import annotations

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device


def params_from_numpy(tree, device, dtype=None):
    """The JAX package's parameter tree (numpy arrays, as its
    `transformer.init` returns or `jax.device_get` gives) as a tree of
    torch tensors on `device`. Float leaves are cast to `dtype` when it
    is given; integer leaves keep their type."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(node)))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return conv(tree)


def leaves(tree):
    """The tensors of a parameter tree, depth first."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree
