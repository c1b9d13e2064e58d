"""Matmuls — counterpart of `shallowspeed_tpu/ops/matmul.py`: the
quantized-weight `dequant_matmul`, and the blocked matmul K5
(`blocked_matmul`), whose CUDA kernel is `csrc/blocked_matmul.cu`.

K5 lies on one path only, the narrow-K probe (`bench_matmul`), as its
reference does; no model calls it. The fp8 training matmul
(`fp8_dense`) is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from shallowspeed_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dequant_matmul(x, wq, ws):
    """x (..., K) @ quantized wq (K, N) (int8 or float8_e4m3fn) with
    per-out-channel f32 scales ws (N,): the product of x and wq's values
    in x's dtype summed in f32, then the scale on the f32 accumulator,
    then the result in x's dtype — the reference's `dot(x.astype(cdt),
    wq.astype(cdt), preferred_element_type=f32) * ws` with cdt x's
    dtype, its default. The scale meets the f32 sum, never a bf16
    rounding of it.

    int8 and e4m3 values are exact in bf16. On the card a bf16 product
    takes cuBLAS's bf16 matmul with an f32 output (`out_dtype`); the
    CPU has no such matmul, so there both operands are upcast to f32,
    in which the products of bf16 values are exact: the same sum. The
    value cast `wq.to(cdt)` is a transient full-size copy that XLA folds
    into the operand load and eager torch does not (PERF.md times the
    tick with it). A matmul outside Pallas in the reference, so a
    library matmul here."""
    wc = wq.to(x.dtype)
    if x.dtype == torch.float32:
        acc = x @ wc
    elif x.is_cuda:
        acc = torch.mm(x.reshape(-1, x.shape[-1]), wc,
                       out_dtype=torch.float32).reshape(*x.shape[:-1], -1)
    else:
        acc = x.float() @ wc.float()
    return (acc * ws.float()).to(x.dtype)


def _blocks(x, y, bm: int, bk: int, bn: int) -> tuple[int, int, int]:
    """The reference's block rule: x (M, K) @ y (K, N), each block
    clipped to its dimension, and a shape the clipped blocks do not
    divide refused (the reference asserts; here a ValueError naming the
    shapes and blocks). Returns the clipped (bm, bk, bn)."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"blocked_matmul takes x (M, K) @ y (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(y.shape)}")
    (m, k), n = x.shape, y.shape[1]
    if min(m, k, n) < 1:
        raise ValueError(f"blocked_matmul of an empty shape "
                         f"({m},{k})@({k},{n})")
    bm, bk, bn = min(bm, m), min(bk, k), min(bn, n)
    if m % bm or k % bk or n % bn:
        raise ValueError(f"({m},{k})@({k},{n}) must divide by blocks "
                         f"({bm},{bk},{bn})")
    return bm, bk, bn


def blocked_matmul_reference(x, y, *, bm: int = 512, bk: int = 512,
                             bn: int = 1024, out_dtype=None):
    """Plain torch K5, the reference body's arithmetic: for each `bk`
    slice of K, the f32 product of the slices is added to an f32
    accumulator, which is rounded once to `out_dtype` (default x's
    dtype). Same arguments, refusals and result as `blocked_matmul`."""
    _, bk, _ = _blocks(x, y, bm, bk, bn)
    acc = torch.zeros(x.shape[0], y.shape[1], dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], bk):
        acc += x[:, k0:k0 + bk].float() @ y[k0:k0 + bk].float()
    return acc.to(out_dtype or x.dtype)


@functools.cache
def _kernel():
    lib = _build.library("blocked_matmul")
    lib.blocked_matmul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    lib.blocked_matmul.restype = ctypes.c_int
    lib.blocked_matmul_error_string.argtypes = [ctypes.c_int]
    lib.blocked_matmul_error_string.restype = ctypes.c_char_p
    return lib


def blocked_matmul(x, y, *, bm: int = 512, bk: int = 512, bn: int = 1024,
                   out_dtype=None):
    """x (M, K) @ y (K, N) with an f32 accumulator, returned in
    `out_dtype` (default x's dtype): K5. The blocks are the reference's
    interface: clipped to the dimensions, and a shape they do not divide
    is refused with a ValueError. They tile the TPU kernel, not this
    one (`csrc/blocked_matmul.cu` owns one 128 x 128 output tile per
    thread block and loops over all of K).

    A CPU x takes `blocked_matmul_reference`. A CUDA x launches the
    kernel (x and y contiguous, of one dtype, float32 or bfloat16;
    out_dtype float32 or bfloat16) or raises, and adds one to
    `blocked_matmul.launches`."""
    if x.device.type == "cpu":
        return blocked_matmul_reference(x, y, bm=bm, bk=bk, bn=bn,
                                        out_dtype=out_dtype)
    _blocks(x, y, bm, bk, bn)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPES or y.dtype != x.dtype \
            or out_dtype not in _DTYPES:
        raise TypeError(f"blocked_matmul takes float32 or bfloat16 x and y "
                        f"of one dtype and a float32 or bfloat16 output; "
                        f"got x={x.dtype}, y={y.dtype}, out={out_dtype}")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("blocked_matmul takes contiguous (row-major) x "
                         "and y")
    (m, k), n = x.shape, y.shape[1]
    if -(-m // 128) > 65535:
        raise ValueError(f"M={m} is over the kernel's 65535 x 128 rows")
    lib = _kernel()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _build.launch(blocked_matmul, lib.blocked_matmul,
                  lib.blocked_matmul_error_string, x.device,
                  x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                  _DTYPES[x.dtype], _DTYPES[out_dtype])
    return out


blocked_matmul.launches = 0
