"""The (dp, pp) device grid — counterpart of
`shallowspeed_tpu/parallel/mesh.py`.

The reference builds a 2-D `jax.sharding.Mesh` that one controller
drives; here the grid is a (dp, pp) numpy object array of
`torch.device`s that the engines drive from one process: cell (r, s)
holds replica r's copy of stage s. Several cells may name one device:
on a card every cell is that card, in the CPU tests every cell is the
CPU, and every (dp, pp) layout runs in one process either way.
"""

from __future__ import annotations

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device


def make_mesh(dp: int = 1, pp: int = 1, devices=None) -> np.ndarray:
    """A (dp, pp) grid of `torch.device`. `devices`: None (every cell
    is `resolve_device()`, the card), one device or device name (every
    cell is it), or a sequence of at least dp * pp devices, laid out
    row-major as the reference's mesh takes its device list."""
    n = dp * pp
    assert dp >= 1 and pp >= 1, (dp, pp)
    if devices is None or isinstance(devices, (str, torch.device)):
        cells = [resolve_device(devices)] * n
    else:
        devices = [resolve_device(d) for d in devices]
        assert n <= len(devices), (
            f"requested dp={dp} x pp={pp} = {n} devices, have {len(devices)}")
        cells = devices[:n]
    grid = np.empty(n, dtype=object)
    grid[:] = cells
    return grid.reshape(dp, pp)
