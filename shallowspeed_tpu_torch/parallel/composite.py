"""3-D composite parallelism: data x sequence x tensor over one
("dp", "sp", "tp") grid — counterpart of
`shallowspeed_tpu/parallel/composite.py`.

- **dp**: the batch's rows; the gradient reduced over the replicas in
  rank order.
- **sp**: the sequence, through the K/V all-gather formulation of
  context parallelism (`ops.attention.allgather_attention`): each sp
  cell's query tile against the gathered K/V, every other op
  position-wise (`parallel.gspmd`).
- **tp**: the Megatron placement of `parallel/tensor.py`, its block and
  its vocabulary-parallel loss.

`fsdp=True` stacks ZeRO-3 on top: every leaf's largest free dimension
also cut over dp (`fsdp.add_dp` on `tensor.param_specs`), gathered in
rank order where a block reads it.
"""

from __future__ import annotations

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel import tensor as tp_mod
from shallowspeed_tpu_torch.parallel.fsdp import add_dp
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine
from shallowspeed_tpu_torch.weights import map_tree


class Composite3DEngine(GSPMDEngine):
    """dp x sp x tp trainer (optionally + ZeRO-3 parameter sharding) over
    `parallel.mesh.make_3d_mesh`'s grid."""

    default_axes = ("dp", "sp", "tp")

    def __init__(self, cfg: T.TransformerConfig, optimizer, seed: int = 0,
                 device=None, *, mesh=None, zero1: bool = False,
                 fsdp: bool = False, zero2: bool = False,
                 health: str = "off", params=None):
        if fsdp and (zero1 or zero2):
            raise ValueError("fsdp already shards the optimizer state; "
                             "drop zero1/zero2")
        self.fsdp = fsdp
        super().__init__(cfg, optimizer, seed, device, mesh=mesh,
                         zero1=zero1, zero2=zero2, health=health,
                         params=params)

    def validate(self, cfg: T.TransformerConfig, mesh) -> None:
        if mesh.axis_names != ("dp", "sp", "tp"):
            raise ValueError(f"Composite3DEngine expects a ('dp','sp','tp') "
                             f"mesh, got {mesh.axis_names}")
        self.sp = mesh.shape["sp"]
        self.tp = mesh.shape["tp"]
        tp_mod.check_tp(cfg, self.tp)
        if cfg.n_experts != 0:
            raise ValueError("Composite3DEngine shards the dense FFN; MoE "
                             "composes with dp/ep (parallel/expert.py)")

    def param_specs(self, cfg: T.TransformerConfig) -> dict:
        specs = tp_mod.param_specs(cfg)
        if not self.fsdp:
            return specs
        dp = self.mesh.shape["dp"]
        return map_tree(lambda m, s: add_dp(s, tuple(m.shape), dp),
                        self._template, specs)
