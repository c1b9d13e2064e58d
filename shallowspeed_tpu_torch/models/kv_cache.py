"""KV-cache attention core — counterpart of
`shallowspeed_tpu/models/kv_cache.py::masked_attention` and
`position_mask`.

The serving path reads its paged pools through a gathered block table
(`serving.cache.gather_table`) into the contiguous head-major view
(B, Hkv, S, hd) this module attends over. Float caches only: the int8
cache belongs to a later slice.
"""

from __future__ import annotations

import torch

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch.ops.attention import NEG


def masked_attention(q, cache_blk, valid):
    """q (B, Tq, H, hd) attends over cache_blk["k"/"v"] (B, Hkv, S, hd)
    under a boolean `valid` that broadcasts against the
    (B, Hkv, G, Tq, S) scores. GQA heads are read unrepeated (grouped
    einsum). Scores and softmax in f32 with masked entries at -1e30;
    the probabilities are cast to V's dtype before the PV product (the
    reference's `p.astype(v.dtype)`), which sums in f32. Returns
    (B, Tq, H, hd) in q's dtype."""
    if "k_s" in cache_blk:
        raise NotPorted("int8 KV cache (kv_quant='int8')",
                        "Queue 2, K4's int8 branch")
    k, v = cache_blk["k"], cache_blk["v"]
    b, tq, h, hd = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, tq, kvh, h // kvh, hd)
    scale = 1.0 / float(hd) ** 0.5
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, tq, h, hd).to(q.dtype)


def position_mask(slots: int, pos, window: int = 0, device=None):
    """Slots [0, pos] are live, optionally limited to the last `window`
    positions."""
    ar = torch.arange(slots, device=device)
    valid = ar <= pos
    if window > 0:
        valid = valid & (ar > pos - window)
    return valid
