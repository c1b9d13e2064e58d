"""Mixture-of-experts ops — counterpart of `shallowspeed_tpu/ops/moe.py`
(capacity-based top-k routing and the einsum dispatch, GShard /
Switch style). One body serves one device and expert parallelism, as
the reference's `moe_ffn` serves `moe_ffn_ep`: routing always runs over
all E experts; with the experts split over ep cells (`p["experts"]`,
see `moe_ffn`) each cell runs its own experts' slots, and their outputs
come back in rank order for the one combine.

Shapes are static as in the reference: each expert takes a fixed
capacity of C token slots per batch group, routing gives dense
`dispatch` / `combine` tensors (G, S, E, C), and the token movement is
two einsums. The router runs in float32 whatever the compute dtype.
The expert choices and slot assignments are discrete (no gradient);
the gate weights reach the router through `combine` and the balance
loss, as in the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F


# the list collecting the (f, P) balance terms of every `route` call
# while `balance_terms` is active
_BALANCE = contextvars.ContextVar("moe_balance_terms", default=None)


@contextlib.contextmanager
def balance_terms():
    """Collect each routed layer's balance terms, in call order: (f, P),
    the top-1 share and the mean router probability per expert, whose
    product the Switch loss sums. The loss is not linear in the data
    shards, so an engine over several shards sums f and P over them
    first (`parallel.gspmd`)."""
    terms: list = []
    token = _BALANCE.set(terms)
    try:
        yield terms
    finally:
        _BALANCE.reset(token)


def expert_capacity(seq_len: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Token slots per expert per batch group."""
    return max(1, math.ceil(top_k * seq_len * capacity_factor / num_experts))


def _one_hot(idx, n: int) -> torch.Tensor:
    """f32 one-hot of integer `idx` over n classes; an index outside
    [0, n) gives a zero row, as `jax.nn.one_hot` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def topk_capacity_routing(gate_logits, capacity: int, top_k: int = 2,
                          priority: bool = False):
    """Top-k routing with per-expert capacity over gate_logits
    (G, S, E); the reference's algorithm step for step.

    Within each k, slots go in sequence order (GShard), or with
    `priority` in descending router probability (V-MoE batch priority;
    a stable sort, so sequence order breaks ties); later k choices
    stack after every earlier-k assignment. An assignment past an
    expert's capacity is dropped.

    Returns (combine (G, S, E, C) f32 — the renormalized gate weight of
    token (g, s) on expert e's slot c, dispatch (G, S, E, C) bool, aux
    — the Switch balance loss E * sum_e f_e P_e over the top-1 choices,
    stats {"load": (E,) pre-drop share of the (token, k) assignments,
    "drop_fraction": share dropped for capacity})."""
    return route(torch.softmax(gate_logits.float(), dim=-1), capacity,
                 top_k, priority)


def route(probs, capacity: int, top_k: int = 2, priority: bool = False):
    """`topk_capacity_routing` from the router's f32 probabilities
    (G, S, E): every step after the softmax, so that the same
    probabilities route exactly as the reference routes them."""
    g, s, e = probs.shape
    raw_gate, topk_idx = torch.topk(probs, top_k, dim=-1)      # (G, S, K)
    topk_gate = raw_gate / (raw_gate.sum(-1, keepdim=True) + 1e-9)

    dev = probs.device
    combine = torch.zeros((g, s, e, capacity), dtype=torch.float32,
                          device=dev)
    used = torch.zeros((g, e), dtype=torch.float32, device=dev)
    kept = torch.zeros((), dtype=torch.float32, device=dev)
    assigned = torch.zeros((e,), dtype=torch.float32, device=dev)
    for k in range(top_k):
        onehot = _one_hot(topk_idx[..., k], e)                  # (G, S, E)
        if priority:
            # rank this k's assignments per expert by the raw router
            # probability; unassigned tokens score 0 and sort last
            score = onehot * raw_gate[..., k, None]
            order = torch.argsort(-score, dim=1, stable=True)
            rank = torch.argsort(order, dim=1, stable=True).float()
            pos = rank + used[:, None, :]
        else:
            pos = torch.cumsum(onehot, dim=1) - onehot + used[:, None, :]
        keep = onehot * (pos < capacity)                        # (G, S, E)
        slot = _one_hot((pos * onehot).sum(-1).to(torch.int32),
                        capacity)                               # (G, S, C)
        combine = combine + (topk_gate[..., k, None, None]
                             * keep[..., None] * slot[:, :, None, :])
        used = used + keep.sum(dim=1)
        kept = kept + keep.sum()
        assigned = assigned + onehot.sum(dim=(0, 1))
    dispatch = combine > 0.0

    top1 = _one_hot(topk_idx[..., 0], e)
    f, p = top1.mean(dim=(0, 1)), probs.mean(dim=(0, 1))
    terms = _BALANCE.get()
    if terms is not None:
        terms.append((f, p))
    aux = e * torch.sum(f * p)
    total = float(g * s * top_k)
    stats = {"load": assigned / total,
             "drop_fraction": 1.0 - kept / total}
    return combine, dispatch, aux, stats


def router_z_loss(gate_logits) -> torch.Tensor:
    """ST-MoE router z-loss: mean over tokens of logsumexp(logits)^2."""
    z = torch.logsumexp(gate_logits.float(), dim=-1)
    return torch.mean(z * z)


def _experts(p: dict, xin):
    """GELU (tanh form) experts with biases on their dispatched slots:
    xin (E', G, C, d) for the E' experts of `p`."""
    h = F.gelu(torch.einsum("egcd,edf->egcf", xin, p["wi"])
               + p["bi"][:, None, None, :], approximate="tanh")
    return (torch.einsum("egcf,efd->egcd", h, p["wo"])
            + p["bo"][:, None, None, :])


def moe_ffn(p: dict, x, top_k: int, capacity_factor: float,
            priority: bool = False, tiles: int = 1):
    """The MoE feed-forward layer. p: {"gate": (d, E), "wi": (E, d, ff),
    "bi": (E, ff), "wo": (E, ff, d), "bo": (E, d)}; x: (G, S, d) ->
    (y (G, S, d) in x's dtype, balance aux, router z-loss, stats), the
    two losses unweighted (the config owns the weights).

    Expert parallelism (the reference's `moe_ffn_ep`): p = {"gate": (d,
    E), "experts": [per ep cell {"wi", "bi", "wo", "bo"} of its E/ep
    experts, on its device]}. Routing is over all E experts as above;
    cell c takes the dispatched slots of its experts [c E/ep, (c+1)
    E/ep) (the all-to-all) and runs them; the inverse all-to-all brings
    the cells' outputs back to x's device in rank order, and the combine
    contracts them over every expert's slots at once, as on one cell
    (the reference's `moe_ffn_ep`: a sum of per-cell partial combines
    would round each part to the compute dtype and move later layers'
    routing).

    Per-tile routing (a sequence-parallel engine's: the reference's sp
    tiles each route their own tokens): with `tiles` = n, x's sequence
    splits into n equal tiles, each routed as its own sequence with its
    own capacity; y is the tiles' outputs in order, the two losses their
    sums (the engine sums its tiles' losses) and the stats their
    mean."""
    if tiles > 1:
        if x.shape[1] % tiles:
            raise ValueError(f"sequence length {x.shape[1]} does not split "
                             f"into {tiles} tiles")
        parts = [moe_ffn(p, xt, top_k, capacity_factor, priority)
                 for xt in x.chunk(tiles, dim=1)]
        aux, z = parts[0][1], parts[0][2]
        for part in parts[1:]:
            aux, z = aux + part[1], z + part[2]
        stats = {k: sum(part[3][k] for part in parts) / tiles
                 for k in parts[0][3]}
        return torch.cat([part[0] for part in parts], dim=1), aux, z, stats
    g, s, d = x.shape
    e = p["gate"].shape[1]
    cap = expert_capacity(s, e, top_k, capacity_factor)
    # the router in f32: bf16 products are exact in f32, so this is
    # the reference's preferred_element_type=f32
    logits = torch.einsum("gsd,de->gse", x.float(), p["gate"].float())
    combine, dispatch, aux, stats = topk_capacity_routing(
        logits, cap, top_k, priority=priority)
    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), x)
    cells = p.get("experts")
    if cells is None:
        y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype),
                         _experts(p, xin))
        return y, aux, router_z_loss(logits), stats
    if e % len(cells):
        raise ValueError(f"{e} experts do not split over {len(cells)} "
                         f"ep cells")
    n = e // len(cells)
    out = torch.cat([_experts(pc, xin[c * n:(c + 1) * n].to(pc["wi"].device)
                              ).to(x.device)
                     for c, pc in enumerate(cells)])
    y = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), out)
    return y, aux, router_z_loss(logits), stats
