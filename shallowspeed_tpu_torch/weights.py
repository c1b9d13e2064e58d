"""Carry a parameter tree, and an optimizer's state, between the two
packages.

Both packages keep the same layout: a nested dict (blocks in a list) of
dense leaves {"W": (K, N), "b": (N,)} applied as `y = x @ W + b`, plus
norm scales and embeddings. So moving weights across is a copy, never
a transpose. Optimizer state keeps the reference's layout too: Adam's
{"m": tree, "v": tree, "t": step}, momentum's velocity tree (or
{"v": tree, "t": step} under a schedule), SGD's () or {"t": step},
Adafactor's {"slots": a tuple of per-leaf dicts, "t": step} in the
reference's leaf order (`sorted_leaves`), whatever order the engine's
dicts keep; the
step is a 0-d int32 array on the JAX side (and in a checkpoint) and a
Python int here. Lists stay lists and tuples stay tuples both ways: a
checkpoint's structure record tells them apart (SGD's state is the
empty tuple), and the JAX package's restore compares it.
"""

from __future__ import annotations

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device


def map_tree(fn, tree, *rest):
    """`fn` applied leaf by leaf over trees of one structure (dicts,
    lists and tuples), keeping the structure; dict entries come in
    `tree`'s key order, the others looked up by key."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def params_from_numpy(tree, device, dtype=None):
    """The JAX package's parameter tree (numpy arrays, as its
    `transformer.init` returns or `jax.device_get` gives) as a tree of
    torch tensors on `device`. Float leaves are cast to `dtype` when it
    is given; integer leaves keep their type."""
    dev = resolve_device(device)

    def conv(node):
        arr = np.ascontiguousarray(np.asarray(node))
        t = torch.from_numpy(arr) if arr.flags.writeable else torch.tensor(arr)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        # a copy on the CPU too: the tensor owns torch-allocated memory,
        # never aliases the caller's array
        return t.to(dev, copy=True)

    return map_tree(conv, tree)


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


def sorted_leaves(tree):
    """The tensors of a tree in the JAX package's flattening order
    (`jax.tree_util.tree_leaves`: dict keys sorted, lists and tuples in
    order) — the order its Adafactor keys its per-leaf slots by, so
    that this package's slots cross as they are."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from sorted_leaves(v)
    else:
        yield tree


def unflatten(tree, flat):
    """A tree of `tree`'s structure holding the values of `flat`, in
    `leaves(tree)` order."""
    it = iter(flat)
    return map_tree(lambda _: next(it), tree)


def to_host(t) -> np.ndarray:
    """A tensor (or an array) as a numpy array that owns its memory: a
    snapshot that later in-place updates of the tensor (the
    optimizer's) cannot reach, on the CPU too, where `.cpu()` would
    return the tensor itself."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    return t.detach().to("cpu", copy=True).numpy()


def params_to_numpy(tree):
    """A tree of torch tensors as numpy arrays (the JAX package's
    layout), each a host copy."""
    return map_tree(to_host, tree)


def opt_state_to_numpy(state):
    """An optimizer state of this package in the JAX package's layout:
    tensors as numpy arrays (host copies), the step `t` as a 0-d int32
    array."""
    if isinstance(state, dict):
        return {k: (np.asarray(v, np.int32) if k == "t"
                    else opt_state_to_numpy(v)) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(opt_state_to_numpy(v) for v in state)
    return to_host(state)


def placed_copy(tree, device):
    """A tree of tensors or numpy arrays (the JAX package's optimizer
    state as `jax.device_get` gives it or a checkpoint holds it, or
    parameters) as this package's on `device`: every array leaf a fresh
    tensor there (never an alias of the input, so replicas never share
    storage), a dict's step `t` a Python int."""
    if isinstance(tree, dict):
        return {k: (int(v) if k == "t" else placed_copy(v, device))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(placed_copy(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return torch.from_numpy(np.array(tree)).to(device)
