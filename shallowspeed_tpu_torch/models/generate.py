"""Decode helpers shared by the serving engine — counterpart of
`shallowspeed_tpu/models/generate.py::_embed` and `filter_logits`.

The contiguous-cache `generate()` loop of the reference is not ported:
the serving engine is the port's decode path.
"""

from __future__ import annotations

import torch

from shallowspeed_tpu_torch.models import transformer as T


def _embed(params, tokens, pos0: int, cfg: T.TransformerConfig):
    """Token (+ learned position, unless rope) embeddings of tokens
    (B, T) at positions pos0.., in the compute dtype."""
    t = tokens.shape[1]
    x = params["tok_emb"][tokens]
    if not cfg.rope:
        pos = pos0 + torch.arange(t, device=tokens.device)
        x = x + params["pos_emb"][pos]
    if cfg.compute_dtype is not None:
        x = x.to(cfg.compute_dtype)
    return x


def filter_logits(logits, top_k: int, top_p: float):
    """Row-wise top-k, then nucleus (top-p) truncation of
    temperature-scaled logits (B, V): dropped entries become -inf."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth,
                             torch.full_like(logits, float("-inf")), logits)
    if 0.0 < top_p < 1.0:
        # keep the smallest prefix of the sorted distribution whose mass
        # reaches top_p (the first token always survives)
        sort_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = torch.gather(logits, -1, sort_idx)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx,
                                                     keep_sorted)
        logits = torch.where(keep, logits,
                             torch.full_like(logits, float("-inf")))
    return logits
