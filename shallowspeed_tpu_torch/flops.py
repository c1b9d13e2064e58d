"""Model-FLOPs accounting and MFU — the port's own copy of
`shallowspeed_tpu/flops.py::transformer_flops_per_token`, `mfu` and
`device_mem_bandwidth`, with peak tables for the port's cards.

FLOPs are counted exactly from the config — every matmul's 2*M*N*K —
with the model-FLOPs convention (forward + 2x backward = 3x forward;
PaLM appendix B). MFU is achieved FLOP/s over the card's published
dense peak, and None where no peak is known (the CPU, an unknown card).
"""

from __future__ import annotations

import torch

# Published dense peaks, FLOP/s, keyed by the start of
# torch.cuda.get_device_name (NVIDIA's H100 SXM data sheet: 989 TFLOP/s
# bf16 on the tensor cores, 67 TFLOP/s f32 outside them; the port's f32
# matmuls run in full f32, never TF32). They assume the card's full
# 700 W power limit.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12},
}


# Device-memory bandwidth, bytes/s, from the same data sheet (H100 SXM
# 80 GB: 3.35 TB/s of HBM3).
_MEM_BANDWIDTH = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


# Card-to-card wire rate, bytes/s in one direction, from the same data
# sheet (H100 SXM: NVLink 4, 900 GB/s both directions, so 450 GB/s each
# way) — what `telemetry/attribution` prices collective bytes at when
# the cells sit on distinct cards.
_WIRE_BANDWIDTH = {
    "NVIDIA H100 80GB HBM3": 450e9,
}


def _card_entry(table: dict, device):
    """The `table` entry of the card `device` (default: the current CUDA
    device), or None on the CPU or for a card the table does not know."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") \
            or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(dev)
    return next((v for k, v in table.items() if name.startswith(k)), None)


def device_peak_flops(device=None, dtype: str = "bf16") -> float | None:
    """Peak FLOP/s of the card `device` (default: the current CUDA
    device) for `dtype` ("bf16" or "f32"); None on the CPU or for a card
    the table does not know."""
    peaks = _card_entry(_PEAKS, device)
    if peaks is None:
        return None
    return peaks.get("f32" if dtype in ("f32", "float32") else "bf16")


def device_mem_bandwidth(device=None) -> float | None:
    """Device-memory bytes/s of the card `device` (default: the current
    CUDA device) from its data sheet; None on the CPU or for a card the
    table does not know (no invented peak, as for `device_peak_flops`)."""
    return _card_entry(_MEM_BANDWIDTH, device)


def device_wire_bandwidth(device=None) -> float | None:
    """NVLink bytes/s one way of the card `device` (default: the current
    CUDA device) from its data sheet; None on the CPU or for a card the
    table does not know."""
    return _card_entry(_WIRE_BANDWIDTH, device)


def _avg_causal_context(seq_len: int, window: int = 0) -> float:
    """Average number of visible key positions per query under causal
    masking, optionally with a sliding window of `window` positions."""
    t = seq_len
    if window and window < t:
        w = window
        return (w * (w + 1) / 2 + (t - w) * w) / t
    return (t + 1) / 2


def transformer_flops_per_token(cfg, seq_len: int) -> float:
    """Exact matmul FLOPs per token for one train step (fwd + bwd):
    projections, FFN, the attention score/value products (causal
    averaged, window aware) and the vocab head."""
    d = cfg.d_model
    ff = cfg.ffn_dim
    per_layer = 0.0
    if cfg.gqa:
        per_layer += 2.0 * d * d                                  # q proj
        per_layer += 2.0 * d * (2 * cfg.kv_heads * cfg.head_dim)  # kv proj
    else:
        per_layer += 2.0 * d * 3 * d                              # fused qkv
    per_layer += 2.0 * d * d                                      # out proj
    ctx = _avg_causal_context(seq_len, getattr(cfg, "attn_window", 0))
    per_layer += 2 * (2.0 * cfg.n_heads * cfg.head_dim * ctx)
    if cfg.n_experts > 0:
        per_layer += 2.0 * d * cfg.n_experts
        per_layer += cfg.moe_top_k * (2.0 * d * ff + 2.0 * ff * d)
    elif cfg.ffn == "swiglu":
        per_layer += 3 * 2.0 * d * ff
    else:
        per_layer += 2 * 2.0 * d * ff
    total = cfg.n_layers * per_layer
    total += 2.0 * d * cfg.vocab                                  # head
    return 3.0 * total


def mfu(tokens_per_sec: float, cfg, seq_len: int, dtype: str = "bf16",
        device=None) -> dict:
    """{"tflops": achieved, "peak_tflops": the card's peak or None,
    "mfu": fraction or None} for a measured training token rate."""
    achieved = tokens_per_sec * transformer_flops_per_token(cfg, seq_len)
    peak = device_peak_flops(device, dtype)
    return {"tflops": achieved / 1e12,
            "peak_tflops": None if peak is None else peak / 1e12,
            "mfu": None if peak is None else achieved / peak}
