"""FSDP / ZeRO-3 over a ("dp",) grid — counterpart of
`shallowspeed_tpu/parallel/fsdp.py`.

Every parameter leaf is cut over dp on its largest dimension that dp
divides (`fsdp_spec`, the reference's placement rule, shared with the
composite engine's ZeRO-3 through `add_dp`), and its optimizer moments
with it: each dp cell holds 1/dp of each shardable leaf and its state.
For its replica's compute a cell gathers each block's whole parameters
in rank order just in time and frees the copy after the block (the
autograd graph keeps the pieces and gathers again for the backward);
no whole copy lives between steps. The gradients are reduce-scattered:
each cell's piece is the sum of every replica's gradient of that piece,
in rank order. All of it is `parallel.gspmd`'s placement machinery
under this spec tree. ZeRO-1/2 are refused (ZeRO-3 subsumes them) as
the reference refuses them; the reference's overlapped shard_map step
(`overlap=`) raises `NotPorted`.
"""

from __future__ import annotations

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine, P
from shallowspeed_tpu_torch.weights import map_tree


def add_dp(spec: P, shape: tuple, dp: int) -> P:
    """Add 'dp' to the LARGEST dimension not already sharded and divisible
    by dp (on a tie of sizes the higher index); return the spec
    unchanged if none qualifies (e.g. tiny biases when dp > their
    length). The single placement rule behind both pure FSDP (empty
    base spec) and ZeRO-3-over-TP (`parallel/composite.py`)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    candidates = [(d, i) for i, d in enumerate(shape)
                  if entries[i] is None and d and d % dp == 0]
    if not candidates:
        return spec
    _, i = max(candidates)
    entries[i] = "dp"
    return P(*entries)


def fsdp_spec(shape: tuple, dp: int) -> P:
    """Pure-FSDP placement: `add_dp` from a fully replicated base."""
    return add_dp(P(), shape, dp)


class FSDPEngine(GSPMDEngine):
    """Fully-sharded data-parallel trainer for the transformer family over
    a ("dp",) grid (`parallel.mesh.make_fsdp_mesh`)."""

    default_axes = ("dp",)

    def __init__(self, cfg: T.TransformerConfig, optimizer, seed: int = 0,
                 device=None, *, mesh=None, zero1: bool = False,
                 zero2: bool = False, health: str = "off", overlap=None,
                 params=None):
        if zero1 or zero2:
            raise ValueError(
                "FSDP already shards the optimizer state (ZeRO-3 is a "
                "superset of ZeRO-1/2); drop zero1/zero2")
        super().__init__(cfg, optimizer, seed, device, mesh=mesh,
                         health=health, overlap=overlap, params=params)

    def validate(self, cfg: T.TransformerConfig, mesh) -> None:
        if mesh.axis_names != ("dp",):
            raise ValueError(f"FSDPEngine expects a 1-D ('dp',) mesh, got "
                             f"{mesh.axis_names}")

    def param_specs(self, cfg: T.TransformerConfig):
        dp = self.mesh.shape["dp"]
        return map_tree(lambda m: fsdp_spec(tuple(m.shape), dp),
                        self._template)
