"""Autoregressive decoding over a contiguous KV cache — counterpart of
`shallowspeed_tpu/models/generate.py`.

`generate` right-pads the prompt to a 64-token bucket, sizes the cache
to bucket + max_new positions (head-major (B, Hkv, cache_len, hd) per
block, int8 with f32 scale planes under `kv_quant="int8"`), runs the
prompt through the blocks once (`prefill`, which captures each block's
K/V), samples the first token, then runs exactly max_new - 1 decode
steps (`decode_step`), sampling after each. Prompts whose bucket
reaches `flash_prefill_at` prefill through `ops.flash_attention.
flash_attention` (K1 on the card); shorter ones through the plain
attention, by the reference's rule (`prefill_attn_impl`).

The reference compiles the whole generation into one program (`jit` +
`lax.scan`); here the decode loop is an eager Python loop, so every
token pays the host's dispatch of each layer's operations. The cache is
written in place.

Sampling is the serving engine's (`sample_rows`): temperature 0 is the
argmax; otherwise token i of a row with seed s draws from a
`torch.Generator` seeded from (s, i). Row b of a batch samples with seed
`seed + b`, so a one-row generation draws exactly what a served request
with the same seed draws. Sampled streams are not the JAX package's
(threefry `fold_in(PRNGKey(seed), i)`); greedy streams are.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from shallowspeed_tpu_torch.flops import device_mem_bandwidth
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.kv_cache import (cache_write,
                                                    cached_attention,
                                                    init_kv_cache,
                                                    kv_bytes_per_position)
from shallowspeed_tpu_torch.ops.attention import attention
from shallowspeed_tpu_torch.ops.flash_attention import flash_attention
from shallowspeed_tpu_torch.weights import leaves, map_tree

FLASH_PREFILL_THRESHOLD = 2048
"""Prompt-bucket length from which `generate` prefills through the flash
kernel instead of the plain attention (as in the reference; the two
differ at the ~1e-6 logit level, so sampled streams are stable within
one regime, not across the switch)."""


def _embed(params, tokens, pos0: int, cfg: T.TransformerConfig):
    """Token (+ learned position, unless rope) embeddings of tokens
    (B, T) at positions pos0.., in the compute dtype."""
    t = tokens.shape[1]
    x = params["tok_emb"][tokens]
    if not cfg.rope:
        # positions past the table clamp to its last row, as JAX's
        # gather does (a serving chunk's padding may run past max_seq)
        pos = torch.clamp(pos0 + torch.arange(t, device=tokens.device),
                          max=params["pos_emb"].shape[0] - 1)
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


def _row_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator token `index` of a row with sampling seed `seed`
    draws from: seeded from (seed, index) alone, so the draw does not
    depend on which tick, slot or path computed the token."""
    hi, lo = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(hi) << 32) | int(lo))
    return g


@torch.no_grad()
def sample_rows(logits, temp, seeds, idx, top_k: int = 0,
                top_p: float = 0.0):
    """Next token per row of logits (S, V): argmax where temp <= 0,
    else a draw from softmax(filter_logits(logits / temp)) with the
    row's (seed, token index) generator. temp/seeds/idx are host
    sequences of length S. Returns an int64 numpy array."""
    out = logits.argmax(dim=-1).cpu().numpy()
    hot = [i for i in range(len(out)) if temp[i] > 0.0]
    if hot:
        scaled = logits[hot] / torch.tensor(
            [max(float(temp[i]), 1e-6) for i in hot],
            device=logits.device)[:, None]
        probs = torch.softmax(filter_logits(scaled, top_k, top_p), dim=-1)
        for j, i in enumerate(hot):
            g = _row_generator(seeds[i], idx[i], logits.device)
            out[i] = int(torch.multinomial(probs[j], 1, generator=g))
    return out


def _pick_block(t: int, want: int) -> int:
    """The reference flash kernel's tile rule: the largest power-of-two
    divisor of `t` not above `want`."""
    while t % want:
        want //= 2
    return max(want, 1)


def prefill_attn_impl(bucket_len: int,
                      flash_prefill_at: int = FLASH_PREFILL_THRESHOLD) -> str:
    """"flash" when the prompt bucket reaches `flash_prefill_at` (0 turns
    the switch off) and the reference's tile for that length stays at
    least 128 wide, else "plain" — the reference's rule, so both
    packages pick the same numerics regime for the same prompt."""
    if (flash_prefill_at > 0 and bucket_len >= flash_prefill_at
            and _pick_block(bucket_len, 512) >= 128):
        return "flash"
    return "plain"


@torch.no_grad()
def prefill(params, tokens, cfg: T.TransformerConfig, cache,
            last_idx: int | None = None, attn_impl: str = "plain"):
    """The prompt tokens (B, Tp) through every block at once, each
    block's K/V written into `cache` at positions 0..Tp-1 (in place).
    Returns the f32 logits (B, vocab) at `last_idx` (default Tp - 1; a
    right-padded prompt passes its true last index — the padding's
    cache slots are overwritten by decode before any mask admits them).
    `attn_impl="flash"` runs `flash_attention` (K1 on the card)."""
    params = T.cast_params(params, cfg.compute_dtype)
    tp = tokens.shape[1]
    x = _embed(params, tokens, 0, cfg)
    fn = flash_attention if attn_impl == "flash" else attention
    attn = partial(fn, causal=True, window=cfg.attn_window)
    pos = torch.arange(tp, device=tokens.device)
    for blk, cblk in zip(params["blocks"], cache):
        x, _, (k, v) = T._block(blk, x, cfg, pos, attn, with_kv=True)
        cache_write(cblk, k, v, 0)
    x = T._norm(params["ln_f"], x, cfg)
    x_last = x[:, tp - 1 if last_idx is None else last_idx]
    return T.head_logits(params, x_last, cfg).float()


def _block_decode(p, x, cfg: T.TransformerConfig, cache_blk, pos: int):
    """One block on a single-token slice x (B, 1, d) at position `pos`:
    writes the token's K/V into the cache (in place) and attends over
    positions 0..pos."""
    b = x.shape[0]
    h = T._norm(p["ln1"], x, cfg)
    q, k, v = T._qkv(p, h, cfg)
    if cfg.rope:        # the cache stores rotated K
        q = T.rope_rotate(q, pos, cfg.rope_theta)
        k = T.rope_rotate(k, pos, cfg.rope_theta)
    cache_write(cache_blk, k, v, pos)
    a = cached_attention(q, cache_blk, pos, cfg.attn_window)
    x = x + T._dense(p["proj"], a.reshape(b, 1, cfg.d_model))
    return T._ffn(p, x, cfg, T._norm(p["ln2"], x, cfg))[0]


@torch.no_grad()
def decode_step(params, token, pos: int, cache, cfg: T.TransformerConfig):
    """One cached decode step: token (B,) at position `pos`. Returns the
    f32 logits (B, vocab); the cache is written in place. Callers in a
    loop pass params already cast (`T.cast_params`), which makes the
    cast here an identity."""
    params = T.cast_params(params, cfg.compute_dtype)
    x = _embed(params, token[:, None], pos, cfg)
    for blk, cblk in zip(params["blocks"], cache):
        x = _block_decode(blk, x, cfg, cblk, pos)
    x = T._norm(params["ln_f"], x, cfg)
    return T.head_logits(params, x[:, 0], cfg).float()


def prompt_bucket_len(tp: int, max_new: int, max_seq: int,
                      bucket: int = 64) -> int:
    """The prompt length rounded up to a `bucket` multiple, capped so
    the bucket plus the generation still fit max_seq."""
    tp_b = ((tp + bucket - 1) // bucket) * bucket
    return max(tp, min(tp_b, max_seq - max_new))


@torch.no_grad()
def generate(params, prompt, cfg: T.TransformerConfig, max_new: int,
             temperature: float = 1.0, top_k: int = 0, top_p: float = 0.0,
             seed: int = 0, kv_quant: str = "",
             flash_prefill_at: int = FLASH_PREFILL_THRESHOLD):
    """`max_new` tokens after `prompt` (B, Tp) (ints, numpy or torch),
    on the device of params["tok_emb"]. Returns an int32 numpy array
    (B, max_new). See the module docstring for the bucketing, the
    prefill regime and the sampler."""
    prompt = torch.as_tensor(np.asarray(prompt))
    b, tp = prompt.shape
    if tp < 1 or max_new < 1:
        raise ValueError(f"empty generation: prompt {tp} tokens, "
                         f"max_new={max_new}")
    if tp + max_new > cfg.max_seq:
        raise ValueError(f"prompt {tp} + max_new {max_new} exceeds "
                         f"max_seq={cfg.max_seq}")
    dev = params["tok_emb"].device
    tp_b = prompt_bucket_len(tp, max_new, cfg.max_seq)
    tokens = torch.zeros((b, tp_b), dtype=torch.long, device=dev)
    tokens[:, :tp] = prompt.to(dev, torch.long)
    params = T.cast_params(params, cfg.compute_dtype)      # once
    cache = init_kv_cache(cfg, b, tp_b + max_new, kv_quant, device=dev)
    logits = prefill(params, tokens, cfg, cache, last_idx=tp - 1,
                     attn_impl=prefill_attn_impl(tp_b, flash_prefill_at))
    temp, seeds = [temperature] * b, [seed + r for r in range(b)]
    out = np.zeros((b, max_new), np.int32)
    out[:, 0] = sample_rows(logits, temp, seeds, [0] * b, top_k, top_p)
    # sample-after-decode: the last sampled token is never decoded
    for i in range(1, max_new):
        tok = torch.from_numpy(out[:, i - 1]).to(dev, torch.long)
        logits = decode_step(params, tok, tp + i - 1, cache, cfg)
        out[:, i] = sample_rows(logits, temp, seeds, [i] * b, top_k, top_p)
    return out


# ------------------------------------------------- decode byte model


def _cast_param_bytes(params, cfg: T.TransformerConfig) -> int:
    """Bytes of the parameters as decode reads them (after `cast_params`,
    quantized leaves at their storage dtypes), counted on meta tensors:
    no copy of the model is made."""
    meta = map_tree(lambda t: t.detach().to("meta"), params)
    return sum(t.numel() * t.element_size()
               for t in leaves(T.cast_params(meta, cfg.compute_dtype)))


def decode_read_bytes_per_token(params, cfg: T.TransformerConfig,
                                batch: int, cache_len: int,
                                kv_quant: str = "") -> int:
    """Device-memory read bytes of one decode step: every parameter at
    the dtype decode reads it, every block's whole K/V cache sweep (+
    int8 scale planes), and the token ids."""
    per_block = batch * cache_len * kv_bytes_per_position(cfg, kv_quant)
    return (_cast_param_bytes(params, cfg) + cfg.n_layers * per_block
            + batch * 4)


def decode_write_bytes_per_token(cfg: T.TransformerConfig, batch: int,
                                 kv_quant: str = "") -> int:
    """Device-memory write bytes of one decode step: the one-position
    K/V update per block (+ scales) and the f32 logits rows."""
    return (cfg.n_layers * batch * kv_bytes_per_position(cfg, kv_quant)
            + batch * cfg.vocab * 4)


def decode_report(params, cfg: T.TransformerConfig, batch: int,
                  cache_len: int, n_tokens: int, seconds: float,
                  kv_quant: str = "") -> dict:
    """Progress-line fields for a timed generation of `n_tokens` decode
    steps over `batch` rows: tokens/s, bytes per step, the implied
    device-memory rate and, where the card's bandwidth is known
    (`flops.device_mem_bandwidth` of params' device), its share of it;
    None for both on the CPU."""
    if seconds <= 0 or n_tokens <= 0:
        raise ValueError(f"decode_report needs seconds > 0 and "
                         f"n_tokens > 0, got seconds={seconds!r}, "
                         f"n_tokens={n_tokens!r}")
    steps_per_sec = n_tokens / seconds
    bpt = (decode_read_bytes_per_token(params, cfg, batch, cache_len,
                                       kv_quant)
           + decode_write_bytes_per_token(cfg, batch, kv_quant))
    gbps = steps_per_sec * bpt / 1e9
    peak = device_mem_bandwidth(params["tok_emb"].device)
    return {
        "tokens_per_sec": round(steps_per_sec * batch, 1),
        "steps_per_sec": round(steps_per_sec, 2),
        "bytes_per_token": int(bpt),
        "hbm_gbps": round(gbps, 4),
        "hbm_peak_gbps": None if peak is None else round(peak / 1e9, 1),
        "hbm_util": None if peak is None else round(gbps * 1e9 / peak, 4),
    }
