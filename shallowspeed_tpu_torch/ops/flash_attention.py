"""Paged flash decode — counterpart of
`shallowspeed_tpu/ops/flash_attention.py::paged_flash_decode`.

`paged_flash_decode` is the serving decode tick's attention: one query
token per slot attends over its KV cache read in place through the
block table, with no gathered copy. On a CUDA tensor it launches the
hand-written kernel `csrc/paged_decode.cu` (built with nvcc for sm_90a
at first use, bound with ctypes); on a CPU tensor it computes
`paged_flash_decode_reference`, the plain torch version (gather the
table, then `masked_attention`), which the tests hold against the JAX
kernel and which `chip_smoke.py` holds the CUDA kernel against.

The kernel keeps its probabilities in f32 through the PV product,
where the reference casts them to V's dtype first (the JAX kernel does
the same), so in bf16 the two differ by that rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch.models.kv_cache import (masked_attention,
                                                    position_mask)
from shallowspeed_tpu_torch.ops import _build
from shallowspeed_tpu_torch.serving.cache import gather_table

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_SMEM = 227 * 1024


def paged_flash_decode_reference(q, pool_blk, bt, pos, *, window: int = 0):
    """Plain torch: `masked_attention(q, gather_table(pool, bt), valid)`
    with each row's position (and window) mask. Same arguments and
    result as `paged_flash_decode`."""
    w = bt.shape[1]
    bs = pool_blk["k"].shape[2]
    valid = position_mask(w * bs, pos.long()[:, None], window,
                          device=q.device)                 # (S, W*bs)
    out = masked_attention(q[:, None], gather_table(pool_blk, bt),
                           valid[:, None, None, None, :])
    return out[:, 0]


@functools.cache
def _kernel():
    lib = _build.library("paged_decode")
    fn = lib.paged_decode
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, kp, vp, bt, pos, window):
    s, h, hd = q.shape
    n, hkv, bs, hd_k = kp.shape
    if vp.shape != kp.shape or hd_k != hd:
        raise ValueError(f"pool shapes k={tuple(kp.shape)} "
                         f"v={tuple(vp.shape)} do not fit q={tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} "
                         f"kv heads")
    if q.dtype not in _DTYPES or kp.dtype != q.dtype or vp.dtype != q.dtype:
        raise TypeError(f"paged_flash_decode takes float32 or bfloat16 q "
                        f"and pools of q's dtype; got q={q.dtype}, "
                        f"k={kp.dtype}, v={vp.dtype}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim={hd} is not one the kernel takes "
                         f"{_HEAD_DIMS}")
    if bt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"bt and pos must be int32, got {bt.dtype}, "
                        f"{pos.dtype}")
    if bt.dim() != 2 or bt.shape[0] != s or bt.shape[1] < 1 \
            or pos.shape != (s,):
        raise ValueError(f"bt {tuple(bt.shape)} / pos {tuple(pos.shape)} "
                         f"do not fit {s} slots")
    if window < 0:
        raise ValueError(f"window={window}")
    for name, t in (("q", q), ("k", kp), ("v", vp), ("bt", bt),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", kp), ("v", vp)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (the kernel "
                             f"reads it in 16-byte vectors)")
    g = h // hkv
    smem = 4 * (2 * g * hd + 2 * bs * hd + g * bs + 3 * g)
    if smem > _MAX_SMEM:
        raise ValueError(f"group {g} x block {bs} x head_dim {hd} needs "
                         f"{smem} bytes of shared memory, over {_MAX_SMEM}")


def paged_flash_decode(q, pool_blk, bt, pos, *, window: int = 0):
    """Single-token attention through a paged block table.

    q: (S, H, hd), one query token per slot; pool_blk: one layer's
    float pools {"k"/"v": (N, Hkv, bs, hd)}; bt: (S, W) int32 block
    tables (padding columns point at the scratch block); pos: (S,)
    int32, each slot's position (its valid span is [0, pos], windowed
    when `window > 0`). Returns (S, H, hd) in q's dtype.

    A CPU q takes the plain reference. A CUDA q launches the kernel
    (float32 or bfloat16, hd 64 or 128) or raises; each launch adds one
    to `paged_flash_decode.launches`."""
    if "k_s" in pool_blk:
        raise NotPorted("int8 pools in paged_flash_decode",
                        "Queue 2, K4's int8 branch")
    if q.device.type == "cpu":
        return paged_flash_decode_reference(q, pool_blk, bt, pos,
                                            window=window)
    kp, vp = pool_blk["k"], pool_blk["v"]
    _check(q, kp, vp, bt, pos, int(window))
    s, h, hd = q.shape
    _, hkv, bs, _ = kp.shape
    lib = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_decode(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
            pos.data_ptr(), out.data_ptr(), s, h, hkv, hd, bs,
            bt.shape[1], int(window), _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode launch failed: "
                           f"{lib.paged_decode_error_string(rc).decode()}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
