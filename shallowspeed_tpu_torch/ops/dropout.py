"""Dropout masks from explicit keys — the port's stand-in for the
reference's `jax.random` keys in `models/transformer.py::_dropout` and
`ops/attention.py::attention`'s probability dropout.

A key is a 63-bit int. `fold_key(key, *data)` derives a new one, as
`jax.random.fold_in` does (through numpy's `SeedSequence`, not
threefry); a mask is drawn from a fresh `torch.Generator` seeded with
the key, on the tensor's device (Philox on a CUDA device, MT19937 on
the CPU). Nothing reads a stream's position, so the same key gives the
same mask however often it is drawn: a remat recompute redraws the
masks of the forward, and eval, decode and serving, which pass no key,
run no RNG op at all. The masks are not JAX's bits (ROADMAP.md,
"Deliberate divergences"); they have the same distribution.

A sequence-parallel replica runs its whole sequence through the model
but draws each sp tile's masks from that tile's own key, as the
reference's tiles do: its key is a tuple of per-tile keys, which
`fold_key` folds tile by tile and `dropout` applies to equal slices of
the sequence axis (dim 1).
"""

from __future__ import annotations

import numpy as np
import torch

_MASK63 = (1 << 63) - 1


def fold_key(key, *data: int):
    """A key derived from `key` and `data` (non-negative ints): equal
    inputs give equal keys, any change gives an unrelated one. A tuple
    of per-tile keys folds tile by tile."""
    if isinstance(key, tuple):
        return tuple(fold_key(k, *data) for k in key)
    words = np.random.SeedSequence([int(key), *map(int, data)])
    return int(words.generate_state(1, np.uint64)[0]) & _MASK63


def keep_mask(shape, rate: float, key: int, device) -> torch.Tensor:
    """Bool mask of `shape`, each element kept (True) with probability
    1 - rate, drawn from a generator seeded with `key` on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(key)
    return torch.rand(shape, generator=gen, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, key) -> torch.Tensor:
    """Inverted dropout (kept elements scaled by 1 / (1 - rate), in x's
    dtype); identity when `key` is None or rate is 0. With a tuple of n
    keys, x's dim 1 splits into n equal tiles, each masked from its
    key."""
    if key is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(key, tuple):
        mask = torch.cat([keep_mask(t.shape, rate, k, x.device) for k, t in
                          zip(key, x.chunk(len(key), dim=1))], dim=1)
    else:
        mask = keep_mask(x.shape, rate, key, x.device)
    return torch.where(mask, x / keep, 0.0).to(x.dtype)
