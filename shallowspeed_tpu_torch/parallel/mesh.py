"""The device grids — counterpart of `shallowspeed_tpu/parallel/mesh.py`
and of the ("dp", "sp") mesh of `parallel/context.py`.

The reference builds a 2-D `jax.sharding.Mesh` that one controller
drives; here a grid is a numpy object array of `torch.device`s that the
engines drive from one process: in the (dp, pp) grid cell (r, s) holds
replica r's copy of stage s, in the (dp, sp) grid replica r's sequence
tile s. Several cells may name one device: on a card every cell is
that card, in the CPU tests every cell is the CPU, and every layout
runs in one process either way.
"""

from __future__ import annotations

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device


def _grid(rows: int, cols: int, names: tuple, devices) -> np.ndarray:
    n = rows * cols
    assert rows >= 1 and cols >= 1, (rows, cols)
    if devices is None or isinstance(devices, (str, torch.device)):
        cells = [resolve_device(devices)] * n
    else:
        devices = [resolve_device(d) for d in devices]
        assert n <= len(devices), (
            f"requested {names[0]}={rows} x {names[1]}={cols} = {n} "
            f"devices, have {len(devices)}")
        cells = devices[:n]
    grid = np.empty(n, dtype=object)
    grid[:] = cells
    return grid.reshape(rows, cols)


def make_mesh(dp: int = 1, pp: int = 1, devices=None) -> np.ndarray:
    """A (dp, pp) grid of `torch.device`. `devices`: None (every cell
    is `resolve_device()`, the card), one device or device name (every
    cell is it), or a sequence of at least dp * pp devices, laid out
    row-major as the reference's mesh takes its device list."""
    return _grid(dp, pp, ("dp", "pp"), devices)


def make_context_mesh(dp: int = 1, sp: int = 1, devices=None) -> np.ndarray:
    """A (dp, sp) grid of `torch.device` for `ContextParallelEngine`,
    with `make_mesh`'s `devices` contract."""
    return _grid(dp, sp, ("dp", "sp"), devices)
