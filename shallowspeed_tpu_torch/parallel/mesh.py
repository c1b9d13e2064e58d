"""The device grids — counterpart of `shallowspeed_tpu/parallel/mesh.py`
and of the meshes the root `train_lm.py` builds for its engines.

The reference builds a `jax.sharding.Mesh` that one controller drives;
here a grid is a numpy object array of `torch.device`s that the engines
drive from one process: in the (dp, pp) grid cell (r, s) holds replica
r's copy of stage s, in the (dp, sp) grid replica r's sequence tile s.
The GSPMD engines (`parallel.gspmd`) take a `Grid`, the array with its
axis names, as the reference's engines take a named mesh: ("dp",),
("dp", "tp"), ("dp", "sp", "tp"), ("dp", "ep") and ("dp", "sp", "ep");
the LM pipeline (`parallel.pipeline_lm`) takes ("dp", "pp") or ("dp",
"pp", X) with X one of "tp", "sp" and "ep".
Several cells may name one device: on a card every cell is that card,
in the CPU tests every cell is the CPU, and every layout runs in one
process either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from shallowspeed_tpu_torch import resolve_device


def _grid(shape: tuple, names: tuple, devices) -> np.ndarray:
    n = math.prod(shape)
    assert all(s >= 1 for s in shape), shape
    if devices is None or isinstance(devices, (str, torch.device)):
        cells = [resolve_device(devices)] * n
    else:
        devices = [resolve_device(d) for d in devices]
        assert n <= len(devices), (
            "requested " + " x ".join(f"{a}={s}" for a, s in zip(names, shape))
            + f" = {n} devices, have {len(devices)}")
        cells = devices[:n]
    grid = np.empty(n, dtype=object)
    grid[:] = cells
    return grid.reshape(shape)


def make_mesh(dp: int = 1, pp: int = 1, devices=None) -> np.ndarray:
    """A (dp, pp) grid of `torch.device`. `devices`: None (every cell
    is `resolve_device()`, the card), one device or device name (every
    cell is it), or a sequence of at least dp * pp devices, laid out
    row-major as the reference's mesh takes its device list."""
    return _grid((dp, pp), ("dp", "pp"), devices)


def make_context_mesh(dp: int = 1, sp: int = 1, devices=None) -> np.ndarray:
    """A (dp, sp) grid of `torch.device` for `ContextParallelEngine`,
    with `make_mesh`'s `devices` contract."""
    return _grid((dp, sp), ("dp", "sp"), devices)


class Grid:
    """A grid of `torch.device`s with one name per axis — what the
    reference's `Mesh` is to its GSPMD engines: `devices` the object
    array, `axis_names` the names, `shape` {name: size}."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"a {devices.ndim}-D grid needs as many axis "
                             f"names, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def make_grid(axis_names: tuple, sizes: tuple, devices=None) -> Grid:
    """A named grid, with `make_mesh`'s `devices` contract."""
    return Grid(_grid(tuple(sizes), tuple(axis_names), devices), axis_names)


def make_fsdp_mesh(dp: int = 1, devices=None) -> Grid:
    """The ("dp",) grid of `FSDPEngine`."""
    return make_grid(("dp",), (dp,), devices)


def make_tp_mesh(dp: int = 1, tp: int = 1, devices=None) -> Grid:
    """The ("dp", "tp") grid of `TensorParallelEngine`."""
    return make_grid(("dp", "tp"), (dp, tp), devices)


def make_3d_mesh(dp: int = 1, sp: int = 1, tp: int = 1, devices=None) -> Grid:
    """The ("dp", "sp", "tp") grid of `Composite3DEngine`."""
    return make_grid(("dp", "sp", "tp"), (dp, sp, tp), devices)


def make_ep_mesh(dp: int = 1, ep: int = 1, sp: int = 1, devices=None) -> Grid:
    """The grid of `ExpertParallelEngine`: ("dp", "ep"), or ("dp", "sp",
    "ep") at sp > 1 (long-context MoE), as the root driver builds it."""
    if sp > 1:
        return make_grid(("dp", "sp", "ep"), (dp, sp, ep), devices)
    return make_grid(("dp", "ep"), (dp, ep), devices)


def make_pipeline_mesh(dp: int = 1, pp: int = 1, tp: int = 1, devices=None,
                       *, sp: int = 1, ep: int = 1) -> Grid:
    """The grid of `PipelineLMEngine`, as the root driver builds it:
    ("dp", "pp"), or with one extra axis above 1 ("dp", "pp", "tp")
    (Megatron inside each stage), ("dp", "pp", "sp") (the sequence cut
    inside each stage's attention) or ("dp", "pp", "ep") (each stage's
    experts cut over ep, the rows over dp x ep)."""
    extra = [(a, n) for a, n in (("tp", tp), ("sp", sp), ("ep", ep)) if n > 1]
    if len(extra) > 1:
        raise ValueError(f"the pipeline takes one extra model axis, got "
                         f"{dict(extra)}")
    if extra:
        (axis, n), = extra
        return make_grid(("dp", "pp", axis), (dp, pp, n), devices)
    return make_grid(("dp", "pp"), (dp, pp), devices)
