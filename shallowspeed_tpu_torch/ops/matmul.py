"""Quantized-weight matmul — counterpart of
`shallowspeed_tpu/ops/matmul.py::dequant_matmul`.

The reference's blocked Pallas matmul (`blocked_matmul`, K5) and the fp8
training matmul (`fp8_dense`) are not ported yet (ROADMAP Queue 2 and
Queue 1 item 7).
"""

from __future__ import annotations

import torch


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
