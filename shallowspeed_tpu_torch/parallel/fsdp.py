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
the reference refuses them.

With `overlap` (`parallel.overlap.OverlapConfig`), the reference's
overlapped step: replica r >= 1's backward reduces inside itself — each
dp-sharded leaf's gradient reduce-scattered onto its owner cells from a
hook the moment it is final, the replicated leaves (biases dp cannot
divide) in buckets of the reference's plan — and each block's just-in-
time gather is issued one block ahead, while the current block
computes (`GSPMDEngine._forward`); on a GPU both on the side stream.
The sums are the bulk step's, in its order: bit for bit the same
training. Adafactor is refused with the reference's message.
"""

from __future__ import annotations

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.optim import Adafactor
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine, P
from shallowspeed_tpu_torch.weights import leaves, map_tree, sorted_leaves


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
    supports_overlap = True

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
        if overlap is not None:
            self._plan_overlap(optimizer, overlap)

    def _plan_overlap(self, optimizer, ov) -> None:
        """The overlapped step's buckets, the reference's: the replicated
        leaves in size-targeted buckets in backward-finalization order,
        then one bucket a dp-sharded leaf (its pieces, each onto its
        owner cell); `_bucket_sigs` as the reference's."""
        if isinstance(optimizer, Adafactor):
            raise ValueError(
                "--overlap fsdp runs the optimizer update on local "
                "shards; Adafactor's factored second moments reduce "
                "over whole matrix dims and need the GSPMD update — "
                "drop --overlap or pick an elementwise optimizer")
        if self._coupled():
            raise ValueError(
                "FSDPEngine(overlap=...) reduces each replica's gradient "
                "inside its own backward; a MoE config at dp > 1 couples "
                "the replicas' backwards (the global balance loss) — "
                "drop overlap")
        meta = list(leaves(self._template))
        order = list(sorted_leaves(self._index))      # flatten order
        repl = [i for i in order if not self._pspecs[i].axes()][::-1]
        raw = OV.plan_buckets([meta[i] for i in repl], ov.bucket_bytes)
        plan_repl = [[repl[j] for j in b] for b in raw]
        sharded = [i for i in order if self._pspecs[i].axes()]
        self._plan = ([[(i, ()) for i in b] for b in plan_repl]
                      + [[(i, (("dp", j),)) for j in range(self.dp)]
                         for i in sharded])
        self._bucket_sigs = (
            [OV.bucket_signature([meta[i] for i in b]) for b in plan_repl]
            + [OV.bucket_signature([meta[i]]) for i in sharded])

    def validate(self, cfg: T.TransformerConfig, mesh) -> None:
        if mesh.axis_names != ("dp",):
            raise ValueError(f"FSDPEngine expects a 1-D ('dp',) mesh, got "
                             f"{mesh.axis_names}")

    def param_specs(self, cfg: T.TransformerConfig):
        dp = self.mesh.shape["dp"]
        return map_tree(lambda m: fsdp_spec(tuple(m.shape), dp),
                        self._template)
