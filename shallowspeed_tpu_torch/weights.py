"""Carry a parameter tree, and an optimizer's state, between the two
packages.

Both packages keep the same layout: a nested dict (blocks in a list) of
dense leaves {"W": (K, N), "b": (N,)} applied as `y = x @ W + b`, plus
norm scales and embeddings. So moving weights across is a copy, never
a transpose. Optimizer state keeps the reference's layout too: Adam's
{"m": tree, "v": tree, "t": step}, momentum's velocity tree (or
{"v": tree, "t": step} under a schedule), SGD's () or {"t": step}; the
step is an int32 scalar on the JAX side and a Python int here.
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


def map_tree(fn, tree, *rest):
    """`fn` applied leaf by leaf over trees of one structure (dicts and
    lists), keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def unflatten(tree, flat):
    """A tree of `tree`'s structure holding the values of `flat`, in
    `leaves(tree)` order."""
    it = iter(flat)
    return map_tree(lambda _: next(it), tree)


def params_to_numpy(tree):
    """A tree of torch tensors as numpy arrays (the JAX package's
    layout)."""
    return map_tree(lambda t: t.detach().cpu().numpy(), tree)


def opt_state_to_numpy(state):
    """An optimizer state of this package in the JAX package's layout:
    tensors as numpy arrays, the step `t` as an int32 scalar."""
    if isinstance(state, dict):
        return {k: (np.asarray(v, np.int32) if k == "t"
                    else opt_state_to_numpy(v)) for k, v in state.items()}
    if isinstance(state, tuple) and not state:
        return ()
    if isinstance(state, (list, tuple)):
        return [opt_state_to_numpy(v) for v in state]
    return state.detach().cpu().numpy()


def opt_state_from_numpy(state, device):
    """The JAX package's optimizer state (numpy, as `jax.device_get`
    gives it) as this package's: arrays as float tensors on `device`,
    the step `t` as a Python int."""
    dev = resolve_device(device)
    if isinstance(state, dict):
        return {k: (int(v) if k == "t" else opt_state_from_numpy(v, dev))
                for k, v in state.items()}
    if isinstance(state, tuple) and not state:
        return ()
    if isinstance(state, (list, tuple)):
        return [opt_state_from_numpy(v, dev) for v in state]
    return torch.from_numpy(np.array(state)).to(dev)   # a writable copy
