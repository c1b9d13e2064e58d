"""KV-cache primitives shared by contiguous decode (`models.generate`)
and the serving runtime — counterpart of
`shallowspeed_tpu/models/kv_cache.py`.

Contiguous caches are head-major (B, Hkv, slots, hd) per block; the
serving pools are (n_blocks, Hkv, block_size, hd) and are read through
a gathered block table (`serving.cache.gather_table`) into the same
(B, Hkv, S, hd) view this module attends over.

int8 caches (`kv_quant="int8"`) store K/V as int8 with one f32 scale
per (row, head, position) in (…, 1) planes "k_s"/"v_s". The scales stay
outside the attention products, as in the reference: K's multiplies
the score, V's folds into the probability row. The presence of "k_s"
in a cache block is the dispatch, everywhere.
"""

from __future__ import annotations

import torch

from shallowspeed_tpu_torch.ops.attention import NEG

KV_QUANT_MODES = ("", "int8")


def init_kv_cache(cfg, batch: int, cache_len: int | None = None,
                  kv_quant: str = "", device=None):
    """Per-block zero-filled K/V buffers (B, Hkv, cache_len, hd) in the
    activation dtype (`cache_len` defaults to cfg.max_seq); int8 adds
    the (B, Hkv, cache_len, 1) f32 scale planes."""
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(
            f"unsupported kv_quant={kv_quant!r}; expected one of "
            f"{KV_QUANT_MODES} ('' = cache in the compute dtype)")
    shape = (batch, cfg.kv_heads, cache_len or cfg.max_seq, cfg.head_dim)
    return [zero_layer(shape, cfg.act_dtype, kv_quant, device)
            for _ in range(cfg.n_layers)]


def zero_layer(shape, dtype, kv_quant: str, device):
    """One layer's zero-filled {"k", "v"[, "k_s", "v_s"]} of `shape`."""
    if kv_quant:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_s": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_kv(x):
    """(values int8, scales f32 (..., 1)): symmetric absmax quantization
    over the last (head_dim) axis, the reference's arithmetic step for
    step: scale = max(max|x| / 127, 1e-8), values = clip(round(x /
    scale), -127, 127) with round half to even."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantized_rows(k, v):
    """{"k", "k_s", "v", "v_s"} of K/V rows (…, hd) quantized per row."""
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return {"k": kq, "k_s": ks, "v": vq, "v_s": vs}


def cache_write(cache_blk, k, v, pos: int) -> None:
    """Write K/V (B, T, Hkv, hd), token-major as the block makes them,
    at positions pos..pos+T-1 of the head-major cache, in place;
    quantized when the cache is int8."""
    k, v = k.transpose(1, 2), v.transpose(1, 2)         # (B, Hkv, T, hd)
    t = k.shape[2]
    if "k_s" in cache_blk:
        upd = quantized_rows(k, v)
    else:
        upd = {"k": k, "v": v}
    for name, val in upd.items():
        cache_blk[name][:, :, pos:pos + t] = val.to(cache_blk[name].dtype)


def masked_attention(q, cache_blk, valid):
    """q (B, Tq, H, hd) attends over cache_blk["k"/"v"] (B, Hkv, S, hd)
    under a boolean `valid` that broadcasts against the
    (B, Hkv, G, Tq, S) scores. GQA heads are read unrepeated (grouped
    einsum); scores and softmax in f32 with masked entries at -1e30.
    Returns (B, Tq, H, hd) in q's dtype.

    Float caches: the probabilities are cast to V's dtype before the PV
    product (the reference's `p.astype(v.dtype)`), which sums in f32.

    int8 caches ("k_s" present): q's dtype is the compute dtype (the
    reference reads `cfg.compute_dtype or cfg.dtype`; every caller here
    passes q in that dtype). q and the int8 K meet in the compute dtype
    (int8 values are exact there) with an f32 sum; the scores are
    multiplied by K's scale, then by the softmax scale; `p * v_s` is cast
    to the compute dtype before the PV product, which sums in f32."""
    k, v = cache_blk["k"], cache_blk["v"]
    b, tq, h, hd = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, tq, kvh, h // kvh, hd)
    scale = 1.0 / float(hd) ** 0.5
    quant = "k_s" in cache_blk
    if quant:
        cdt = q.dtype
        s = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(),
                         k.to(cdt).float())
        s = s * cache_blk["k_s"][..., 0][:, :, None, None, :] * scale
    else:
        s = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), k.float()) * scale
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    if quant:
        pv = p * cache_blk["v_s"][..., 0][:, :, None, None, :]
        out = torch.einsum("bhgqk,bhkd->bqhgd", pv.to(cdt).float(),
                           v.to(cdt).float())
    else:
        out = torch.einsum("bhgqk,bhkd->bqhgd", p.to(v.dtype).float(),
                           v.float())
    return out.reshape(b, tq, h, hd).to(q.dtype)


def kv_bytes_per_position(cfg, kv_quant: str = "") -> int:
    """Bytes one cache position holds per layer: K and V over the kv
    heads, int8 plus one f32 scale each for int8 caches."""
    if kv_quant == "int8":
        return 2 * cfg.kv_heads * (cfg.head_dim + 4)
    itemsize = torch.empty(0, dtype=cfg.act_dtype).element_size()
    return 2 * cfg.kv_heads * cfg.head_dim * itemsize


def position_mask(slots: int, pos, window: int = 0, device=None):
    """Slots [0, pos] are live, optionally limited to the last `window`
    positions."""
    ar = torch.arange(slots, device=device)
    valid = ar <= pos
    if window > 0:
        valid = valid & (ar > pos - window)
    return valid


def cached_attention(q, cache_blk, pos: int, window: int = 0):
    """q (B, 1, H, hd) at position `pos` attends over cache[:, :, :pos+1]
    (windowed when `window > 0`): `masked_attention` under the
    contiguous position prefix."""
    valid = position_mask(cache_blk["k"].shape[2], pos, window,
                          device=q.device)
    return masked_attention(q, cache_blk, valid)
