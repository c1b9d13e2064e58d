"""Distributed-correctness utilities of the MLP path — counterpart of
`shallowspeed_tpu/utils.py` (`rprint`, `get_model_hash`,
`assert_replicas_in_sync`).

The model hash is the reference's, byte for byte: a SHA-1 over the
concatenated hex SHA-1s of the leaves, taken in the JAX package's leaf
order (dict keys sorted, lists and tuples in order), so the same
parameters give the same hash in both packages. Replicas are the
engines' per-replica copies (`engine.replicas()`), compared hash for
hash, where the reference compares the per-device shards of a
replicated array.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def rprint(*args, **kwargs):
    """Print once per job: this package runs one controller process,
    the reference's process 0."""
    print(*args, **kwargs)


def tree_leaves(tree) -> list:
    """The leaves of a nest of dicts, lists and tuples in the JAX
    package's order: dict keys sorted, None holds no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in tree_leaves(c)]
    if tree is None:
        return []
    return [tree]


def _leaf_sha1(leaf) -> str:
    arr = (leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
           else np.asarray(leaf))
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def get_model_hash(params) -> str:
    """SHA-1 over the concatenated per-leaf SHA-1s."""
    combo = hashlib.sha1()
    for leaf in tree_leaves(params):
        combo.update(_leaf_sha1(leaf).encode())
    return combo.hexdigest()


def assert_replicas_in_sync(replicas) -> None:
    """Assert every replica's parameters are bit-identical to replica
    0's. `replicas`: one parameter tree per DP replica (an engine's
    `replicas()`)."""
    ref = [_leaf_sha1(x) for x in tree_leaves(replicas[0])]
    for r, tree in enumerate(replicas[1:], start=1):
        got = [_leaf_sha1(x) for x in tree_leaves(tree)]
        bad = [i for i, (a, b) in enumerate(zip(ref, got)) if a != b]
        if bad or len(got) != len(ref):
            raise AssertionError(
                f"DP replica {r} out of sync with replica 0 at leaves "
                f"{bad or 'count'}")
