"""Plain attention in torch arithmetic — counterpart of
`shallowspeed_tpu/ops/attention.py::attention`.

This is the full-forward reference the serving path is held against,
so it deliberately repeats the JAX numerics instead of calling a fused
library operator: scores and softmax in float32 (the bf16 products are
exact in f32, so upcasting before the einsum equals JAX's
`preferred_element_type=f32`), the probabilities cast to V's dtype
before the PV product, the f32 sum cast back to q's dtype.
Attention-probability dropout lives here only, as in the reference: the
fused flash kernels do not take it.
"""

from __future__ import annotations

import torch

from shallowspeed_tpu_torch.ops.dropout import keep_mask

NEG = -1e30


def attention(q, k, v, causal: bool = True, window: int = 0,
              dropout: float = 0.0, dropout_key=None):
    """q: (B, T, H, D); k, v: (B, Tk, Hkv, D) with Hkv | H (native GQA:
    query head h reads kv head h // G, K/V are never repeated).
    `causal` lets position i see keys <= i; `window > 0` additionally
    limits it to [i - window + 1, i]. `dropout` with a `dropout_key`
    (`ops.dropout`) drops probabilities before the PV product, the kept
    ones scaled by 1 / (1 - dropout). Returns (B, T, H, D) in q's
    dtype."""
    b, tq, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"n_heads={h} is not a multiple of kv heads={kvh}")
    scale = 1.0 / float(d) ** 0.5
    qg = q.reshape(b, tq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal or window > 0:
        tk = k.shape[1]
        iq = torch.arange(tq, device=q.device)[:, None]
        ik = torch.arange(tk, device=q.device)[None, :]
        mask = iq >= ik if causal else torch.ones(tq, tk, dtype=torch.bool,
                                                  device=q.device)
        if window > 0:
            mask = mask & (ik > iq - window)
        s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    if dropout > 0.0 and dropout_key is not None:
        keep = 1.0 - dropout
        p = torch.where(keep_mask(p.shape, dropout, dropout_key, q.device),
                        p / keep, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, tq, h, d).to(q.dtype)


attention.supports_prob_dropout = True
