"""Expert parallelism — the MoE transformer over a ("dp", "ep") or
("dp", "sp", "ep") grid; counterpart of
`shallowspeed_tpu/parallel/expert.py::ExpertParallelEngine`.

Placement (`param_specs`, the reference's): the stacked expert weights
`wi/bi/wo/bo` (leading dim E) cut over ep — each ep cell owns E/ep
experts — and the router gate, attention, embeddings and norms
replicated. The batch's rows go over dp, the sequence over sp (the K/V
all-gather attention, `parallel.gspmd`).

Each replica routes its rows over all E experts (`ops.moe.moe_ffn`, one
body for every ep: the routing math cannot drift), each ep cell runs its
own experts' slots, and the cells' outputs come back in rank order for
the combine. Routing sees whole rows at sp > 1 (the replica's whole sequence
runs on its home cell), so capacity competes per (row, expert) in
sequence order as on one device. The Switch balance loss is the global
one: at dp > 1 each layer's f and P are summed over the replicas before
their product. At (dp, ep) = (1, 1) the engine computes exactly what
the one-device trainer computes.
"""

from __future__ import annotations

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine, P


def param_specs(cfg: T.TransformerConfig) -> dict:
    """The spec tree matching `transformer.init` with n_experts > 0."""
    assert cfg.n_experts > 0
    dense = {"W": P(), "b": P()}
    ln = {"g": P(), "b": P()}
    moe = {"gate": P(), "wi": P("ep", None, None), "bi": P("ep", None),
           "wo": P("ep", None, None), "bo": P("ep", None)}
    attn_proj = ({"q": dense, "kv": dense} if cfg.gqa
                 else {"qkv": dense})
    block = {"ln1": ln, **attn_proj, "proj": dense, "ln2": ln, "moe": moe}
    out = {
        "tok_emb": P(),
        "pos_emb": P(),
        "blocks": [block for _ in range(cfg.n_layers)],
        "ln_f": ln,
    }
    if not cfg.tie_embeddings:
        out["head"] = dense
    return out


class ExpertParallelEngine(GSPMDEngine):
    """Data x expert parallel trainer for the MoE transformer family
    (`parallel.mesh.make_ep_mesh`'s grid; one cell by default)."""

    default_axes = ("dp", "ep")

    def validate(self, cfg: T.TransformerConfig, mesh) -> None:
        if mesh.axis_names not in (("dp", "ep"), ("dp", "sp", "ep")):
            raise ValueError(f"ExpertParallelEngine expects a ('dp'[,'sp'],"
                             f"'ep') mesh, got {mesh.axis_names}")
        if cfg.n_experts <= 0:
            raise ValueError("ExpertParallelEngine needs n_experts > 0")
        self.sp = mesh.shape.get("sp", 1)
        self.ep = mesh.shape["ep"]
        if cfg.n_experts % self.ep:
            raise ValueError(f"n_experts={cfg.n_experts} must be divisible "
                             f"by ep={self.ep}")
        if cfg.moe_top_k > cfg.n_experts:
            raise ValueError(f"moe_top_k={cfg.moe_top_k} cannot exceed "
                             f"n_experts={cfg.n_experts}")

    def param_specs(self, cfg: T.TransformerConfig) -> dict:
        return param_specs(cfg)
