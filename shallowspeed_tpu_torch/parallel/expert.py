"""The MoE trainer on one device — the (dp, ep) = (1, 1) counterpart of
`shallowspeed_tpu/parallel/expert.py::ExpertParallelEngine`, a GSPMD
engine there (`parallel/gspmd.py`).

At one device the reference's expert placement is the identity: every
expert's weights live on the card, the dispatch and combine einsums
(`ops.moe`) need no all-to-all, and the step is `transformer.loss`
under autograd through the plain attention (what the GSPMD engine's
`T.loss` runs by default), with one dropout key a step. The public
face is the reference engine's: `train_batch`, `eval_loss`, `logits`,
`router_stats` and the checkpoint interface; the class name is the
reference's too, so a checkpoint's optimizer state restores across
the packages as the engine's own. ep > 1 and dp > 1 raise `NotPorted`.
"""

from __future__ import annotations

import torch

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

_LATER = "Queue 1 item 5, ep > 1"


class ExpertParallelEngine(ContextParallelEngine):
    """One-device trainer for the MoE transformer family (cfg.n_experts
    > 0): the reference engine's config checks, then
    `ContextParallelEngine` with the plain attention."""

    def __init__(self, cfg: T.TransformerConfig, optimizer, seed: int = 0,
                 device=None, *, dp: int = 1, ep: int = 1,
                 zero1: bool = False, zero2: bool = False,
                 health: str = "off", params=None):
        if dp > 1 or ep > 1:
            raise NotPorted(f"expert parallelism over a (dp={dp}, ep={ep}) "
                            f"mesh", _LATER)
        if cfg.n_experts <= 0:
            raise ValueError("ExpertParallelEngine needs n_experts > 0")
        if cfg.moe_top_k > cfg.n_experts:
            raise ValueError(f"moe_top_k={cfg.moe_top_k} cannot exceed "
                             f"n_experts={cfg.n_experts}")
        super().__init__(cfg, optimizer, seed, attn="ring", device=device,
                         zero1=zero1, zero2=zero2, health=health,
                         params=params)

    @torch.no_grad()
    def router_stats(self, tokens) -> dict:
        """MoE routing on one batch, as the reference reports it: the
        per-expert share of the (token, k) assignments (pre-drop) and
        the share dropped for capacity, averaged over the layers. A
        train-mode forward without dropout: one extra forward, so call
        it at log points only."""
        _, _, st = T.forward_with_aux(self.params, self.place(tokens),
                                      self.cfg, self.attn_fn,
                                      with_stats=True)
        return {"expert_load": [round(float(x), 4) for x in st["load"]],
                "drop_fraction": round(float(st["drop_fraction"]), 4)}
