"""Matmuls — counterpart of `shallowspeed_tpu/ops/matmul.py`: the
quantized-weight `dequant_matmul`, the blocked matmul K5
(`blocked_matmul`) and the fp8-e4m3 training matmul `fp8_dense`, all on
the kernels of `csrc/blocked_matmul.cu`: a tensor-core GEMM (bf16 x;
y bf16, or 1-byte weight values converted in shared memory; or e4m3 x
and y, both converted to f16 in shared memory: `fp8_matmul`, fp8_dense's
forward product) and an f32-FMA kernel (f32 inputs, e4m3 inputs,
unaligned shapes).

K5 lies on one path only, the narrow-K probe (`bench_matmul`), as its
reference does; no model calls it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from shallowspeed_tpu_torch.ops import _build

# dtype codes of the C entries (csrc/blocked_matmul.cu)
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
          torch.float8_e4m3fn: 3}
_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_WEIGHT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def dequant_matmul_route(x_dtype, k: int, n: int) -> str:
    """Which kernel `dequant_matmul` launches on the card for x of
    `x_dtype` (..., K) @ a 1-byte wq (K, N), chosen before the launch:
    "tc" (`_dequant_matmul_tc`, the tensor-core GEMM reading wq at 1
    byte an element) for bfloat16 x with K % 8 == 0 and N % 16 == 0
    (TMA's 16-byte row strides for x, whole 16-byte cp.async chunks of
    wq); else "fma" (`_dequant_matmul_fma`, the f32-FMA kernel, which
    keeps an f32 x in full f32)."""
    ok = x_dtype == torch.bfloat16 and k % 8 == 0 and n % 16 == 0
    return "tc" if ok else "fma"


def dequant_matmul_reference(x, wq, ws):
    """Plain torch `dequant_matmul`: x and wq's values in f32 (exact for
    bf16 x and 1-byte wq), their product summed in f32, times ws, in x's
    dtype. Same arguments and result as `dequant_matmul`."""
    return ((x.float() @ wq.float()) * ws.float()).to(x.dtype)


def dequant_matmul(x, wq, ws):
    """x (..., K) @ quantized wq (K, N) (int8 or float8_e4m3fn) with
    per-out-channel f32 scales ws (N,): the product of x and wq's values
    in x's dtype summed in f32, then the scale on the f32 accumulator,
    then the result in x's dtype — the reference's `dot(x.astype(cdt),
    wq.astype(cdt), preferred_element_type=f32) * ws` with cdt x's
    dtype, its default. The scale meets the f32 sum, never a bf16
    rounding of it.

    A CPU x takes the plain version (`dequant_matmul_reference`): both
    operands upcast to f32, in which the products of bf16 values (int8
    and e4m3 values are exact in bf16) are exact, so it is the same sum.
    A CUDA x launches a hand-written kernel of `csrc/blocked_matmul.cu`
    that reads wq at 1 byte an element and converts its values in the
    operand load, so no (K, N) copy of the weight is ever made (the
    reference's contract): the tensor-core GEMM for bfloat16 x
    (`_dequant_matmul_tc`), the f32-FMA kernel otherwise
    (`_dequant_matmul_fma`), as `dequant_matmul_route` picks; x float32
    or bfloat16, wq contiguous, ws float32 (N,), or it raises."""
    if x.device.type == "cpu":
        return dequant_matmul_reference(x, wq, ws)
    k, n = wq.shape
    if x.dtype not in _FLOAT_DTYPES or wq.dtype not in _WEIGHT_DTYPES \
            or ws.dtype != torch.float32:
        raise TypeError(f"dequant_matmul takes float32 or bfloat16 x, int8 "
                        f"or float8_e4m3fn wq and float32 ws; got "
                        f"x={x.dtype}, wq={wq.dtype}, ws={ws.dtype}")
    if x.shape[-1] != k or ws.shape != (n,):
        raise ValueError(f"dequant_matmul: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, ws {tuple(ws.shape)} do not "
                         f"fit")
    for name, t in (("wq", wq), ("ws", ws)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"dequant_matmul takes a contiguous {name}")
    x2 = x.reshape(-1, k).contiguous()
    launcher = (_dequant_matmul_tc
                if dequant_matmul_route(x.dtype, k, n) == "tc"
                else _dequant_matmul_fma)
    return launcher(x2, wq, ws).reshape(*x.shape[:-1], n)


def _dequant_matmul_tc(x, wq, ws):
    """`dequant_matmul` of a bfloat16 x (M, K) on the card through
    `csrc/blocked_matmul.cu::gemm_tc_kernel` with B read as 1-byte
    values: the weight is staged by cp.async, converted to bf16 in
    shared memory and multiplied on the tensor cores; the epilogue
    scales the f32 sum by ws and rounds once to bfloat16. K is split
    over more blocks when the output tiles are too few to stream the
    weight (`tc_splits`). Reached only through `dequant_matmul`; its
    own function so that its launches count apart."""
    return _launch_tc(_dequant_matmul_tc, x, wq, ws, torch.bfloat16)


_dequant_matmul_tc.launches = 0


def _dequant_matmul_fma(x, wq, ws):
    """`dequant_matmul` on the card through the f32-FMA kernel
    (`csrc/blocked_matmul.cu::blocked_matmul_kernel` with a 1-byte y and
    a scaled epilogue), for float32 x (the f32 parity checks) and for
    bfloat16 x whose shapes the tensor-core route does not take; the
    result in x's dtype. Reached only through `dequant_matmul`."""
    m, k = x.shape
    n = wq.shape[1]
    if -(-m // 128) > 65535:
        raise ValueError(f"M={m} is over the kernel's 65535 x 128 rows")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _kernel()
    _build.launch(_dequant_matmul_fma, lib.blocked_matmul,
                  lib.blocked_matmul_error_string, x.device, x.data_ptr(),
                  wq.data_ptr(), ws.data_ptr(), out.data_ptr(), m, n, k,
                  _CODES[x.dtype], _CODES[wq.dtype], _CODES[x.dtype])
    return out


_dequant_matmul_fma.launches = 0


def tc_warpgroups(m: int) -> int:
    """Warpgroups of one tensor-core block (64 output rows each): one
    for M <= 64 (the decode tick's 8 rows), else two."""
    return 1 if m <= 64 else 2


def tc_splits(m: int, n: int, k: int, sms: int = 132) -> int:
    """How many ways the tensor-core GEMM splits K: 1 when its
    (64 WG x 128) output tiles give every SM a block, else as many as
    bring the blocks to two an SM, with at least 4 k tiles of 64 in each
    split and none empty."""
    tiles = -(-n // 128) * -(-m // (64 * tc_warpgroups(m)))
    k_tiles = -(-k // 64)
    want = min(-(-2 * sms // tiles), k_tiles // 4)
    if tiles >= sms or want <= 1:
        return 1
    per = -(-k_tiles // want)
    return -(-k_tiles // per)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_tc(counter, x, y, ws, out_dtype):
    """One call of the C entry `gemm_tc`: x (M, K) bf16 @ y (K, N) (bf16,
    int8 or e4m3), or e4m3 x @ e4m3 y, scaled by ws (or None), out (M, N)
    in out_dtype; the split-K partial sums in a scratch tensor when
    `tc_splits` > 1."""
    m, k = x.shape
    n = y.shape[1]
    wg = tc_warpgroups(m)
    if -(-m // (64 * wg)) > 65535:
        raise ValueError(f"M={m} is over the kernel's 65535 x 128 rows")
    for name, t in (("x", x), ("y", y)):
        if t.data_ptr() % 16:
            raise ValueError(f"the tensor-core matmul reads {name} by TMA "
                             f"and cp.async, which need a 16-byte aligned "
                             f"address; got {t.data_ptr():#x}")
    splits = tc_splits(m, n, k, _sm_count(x.device.index))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    lib = _kernel()
    _build.launch(counter, lib.gemm_tc, lib.blocked_matmul_error_string,
                  x.device, *(t.data_ptr() if t is not None else None
                              for t in (x, y, ws, out, part)),
                  m, n, k, wg, splits, _CODES[x.dtype], _CODES[y.dtype],
                  _CODES[out_dtype])
    return out


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
    lib.blocked_matmul.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    lib.gemm_tc.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.gemm_tc_smem.argtypes = [ctypes.c_int] * 3
    lib.blocked_matmul.restype = lib.gemm_tc.restype = ctypes.c_int
    lib.gemm_tc_smem.restype = ctypes.c_int
    lib.blocked_matmul_error_string.argtypes = [ctypes.c_int]
    lib.blocked_matmul_error_string.restype = ctypes.c_char_p
    return lib


def blocked_matmul_route(x_dtype, y_dtype, k: int, n: int) -> str:
    """Which K5 build `blocked_matmul` launches on the card, chosen
    before the launch: "tc" (`_blocked_matmul_tc`, wgmma) for bfloat16
    x and y with K % 8 == 0 and N % 8 == 0 (TMA's 16-byte row strides);
    "fma" (the f32-FMA kernel, counted on `blocked_matmul.launches`) for
    float32 inputs, which stay full f32, and unaligned bf16 shapes."""
    ok = (x_dtype == y_dtype == torch.bfloat16 and k % 8 == 0
          and n % 8 == 0)
    return "tc" if ok else "fma"


def blocked_matmul(x, y, *, bm: int = 512, bk: int = 512, bn: int = 1024,
                   out_dtype=None):
    """x (M, K) @ y (K, N) with an f32 accumulator, returned in
    `out_dtype` (default x's dtype): K5. The blocks are the reference's
    interface: clipped to the dimensions, and a shape they do not divide
    is refused with a ValueError. They tile the TPU kernel, not these
    (`csrc/blocked_matmul.cu`).

    A CPU x takes `blocked_matmul_reference`. A CUDA x launches a kernel
    (x and y contiguous, of one dtype, float32 or bfloat16; out_dtype
    float32 or bfloat16) or raises, as `blocked_matmul_route` picks:
    the tensor-core GEMM through `_blocked_matmul_tc`, or the f32-FMA
    kernel, which adds one to `blocked_matmul.launches`."""
    if x.device.type == "cpu":
        return blocked_matmul_reference(x, y, bm=bm, bk=bk, bn=bn,
                                        out_dtype=out_dtype)
    _blocks(x, y, bm, bk, bn)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _FLOAT_DTYPES or y.dtype != x.dtype \
            or out_dtype not in _FLOAT_DTYPES:
        raise TypeError(f"blocked_matmul takes float32 or bfloat16 x and y "
                        f"of one dtype and a float32 or bfloat16 output; "
                        f"got x={x.dtype}, y={y.dtype}, out={out_dtype}")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("blocked_matmul takes contiguous (row-major) x "
                         "and y")
    (m, k), n = x.shape, y.shape[1]
    if blocked_matmul_route(x.dtype, y.dtype, k, n) == "tc":
        return _blocked_matmul_tc(x, y, out_dtype)
    if -(-m // 128) > 65535:
        raise ValueError(f"M={m} is over the kernel's 65535 x 128 rows")
    lib = _kernel()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _build.launch(blocked_matmul, lib.blocked_matmul,
                  lib.blocked_matmul_error_string, x.device,
                  x.data_ptr(), y.data_ptr(), None, out.data_ptr(), m, n, k,
                  _CODES[x.dtype], _CODES[y.dtype], _CODES[out_dtype])
    return out


blocked_matmul.launches = 0


def _blocked_matmul_tc(x, y, out_dtype):
    """K5's bf16 build on the card, `csrc/blocked_matmul.cu::
    gemm_tc_kernel`: x and y by TMA into 128B-swizzled boxes, wgmma with
    the f32 sum in registers, one rounding to out_dtype. Reached only
    through `blocked_matmul`; its own function so that its launches
    count apart."""
    return _launch_tc(_blocked_matmul_tc, x, y, None, out_dtype)


_blocked_matmul_tc.launches = 0


# ----------------------------------------------------- fp8 training matmul
#
# The reference's `fp8_dense` (matmul.py:202, XLA there): x with a
# DELAYED per-tensor scale, w with a just-in-time per-out-channel scale,
# both rounded once into e4m3, their product summed in f32 and the
# dequant `* (sx * sw)` on the f32 sum. The backward is its hand
# straight-through VJP: gradients stay f32 end to end, computed from
# the stored e4m3 operands (f32 products of exact e4m3 values; on the
# card `torch.matmul` in full f32, as the reference leaves them to XLA).

E4M3_MAX = 448.0          # finfo(float8_e4m3fn).max
E4M3_TINY = 2.0 ** -9     # the smallest e4m3 subnormal


def _check_fp8_operands(x, w):
    """fp8_dense's shape contract as a typed error: the hand VJP
    contracts the batch axis for dw, so only 2-D operands are taken."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(
            f"fp8_dense takes 2-D operands x (B, K) @ w (K, N); got "
            f"x.shape={tuple(x.shape)}, w.shape={tuple(w.shape)} — "
            f"reshape (..., K) activations to (-1, K) at the call site")
    if x.shape[1] != w.shape[0]:
        raise ValueError(
            f"fp8_dense contraction mismatch: x (B, K={x.shape[1]}) @ "
            f"w (K={w.shape[0]}, N)")


def fp8_clamp_stats(x, scale):
    """Per-tensor clamp statistics of one activation quantize, on the
    same (x, scale) `fp8_quantize` sees: (overflow — the share of
    elements the ±E4M3_MAX clip saturates, underflow — the share of
    NONZERO elements that round to zero in e4m3), two f32 0-d
    tensors."""
    y = torch.abs(x.float()) / scale
    overflow = torch.mean((y > E4M3_MAX).float())
    nz = y > 0.0
    under = nz & (y < 0.5 * E4M3_TINY)
    denom = torch.clamp(torch.sum(nz.float()), min=1.0)
    return overflow, torch.sum(under.float()) / denom


def fp8_quantize(x, scale):
    """`x / scale` in f32, saturated to ±E4M3_MAX and rounded once into
    float8_e4m3fn (NaN stays NaN: the clamp passes it through)."""
    y = x.float() / scale
    return torch.clamp(y, -E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn)


@torch.no_grad()
def _w_scale(w):
    """Just-in-time per-out-channel weight scale, no gradient:
    max(max_k |w[k, n]| / E4M3_MAX, 1e-12)."""
    amax = torch.amax(torch.abs(w.float()), dim=0)
    return torch.clamp(amax / E4M3_MAX, min=1e-12)


def fp8_matmul_route(k: int, n: int) -> str:
    """Which build `fp8_matmul` launches on the card for xq (M, K) @
    wq (K, N), chosen before the launch: "tc" (`_fp8_matmul_tc`, the
    tensor-core GEMM on f16 conversions of the e4m3 bytes, f32 sum) when
    K % 16 == 0 and N % 16 == 0 (whole 16-byte cp.async chunks of xq's
    and wq's rows); else "fma" (`_fp8_matmul_fma`, the f32-FMA kernel
    reading the e4m3 bytes, any shape)."""
    return "tc" if k % 16 == 0 and n % 16 == 0 else "fma"


def fp8_matmul_reference(xq, wq, scale):
    """Plain torch `fp8_matmul`: the e4m3 values in f32 (exact), their
    product summed in f32, times the per-column scale."""
    return (xq.float() @ wq.float()) * scale


def fp8_matmul(xq, wq, scale):
    """(xq @ wq) * scale in f32: xq (M, K) and wq (K, N)
    float8_e4m3fn, scale (N,) f32 (fp8_dense's sx * sw), the product
    summed in f32 and scaled on the f32 sum.

    A CPU xq takes `fp8_matmul_reference`. A CUDA xq launches a kernel
    of `csrc/blocked_matmul.cu` or raises, as `fp8_matmul_route`
    picks: the e4m3 tensor-core GEMM through `_fp8_matmul_tc`, or the
    f32-FMA kernel through `_fp8_matmul_fma`."""
    if xq.device.type == "cpu":
        return fp8_matmul_reference(xq, wq, scale)
    if xq.dtype != torch.float8_e4m3fn or wq.dtype != torch.float8_e4m3fn \
            or scale.dtype != torch.float32:
        raise TypeError(f"fp8_matmul takes float8_e4m3fn xq and wq and a "
                        f"float32 scale; got xq={xq.dtype}, wq={wq.dtype}, "
                        f"scale={scale.dtype}")
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0] \
            or scale.shape != (wq.shape[1],):
        raise ValueError(f"fp8_matmul: xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, scale {tuple(scale.shape)} do "
                         f"not fit")
    for name, t in (("wq", wq), ("scale", scale)):
        if t.device != xq.device:
            raise ValueError(f"{name} is on {t.device}, xq on {xq.device}")
    xq, wq, scale = xq.contiguous(), wq.contiguous(), scale.contiguous()
    launcher = (_fp8_matmul_tc
                if fp8_matmul_route(*wq.shape) == "tc" else _fp8_matmul_fma)
    return launcher(xq, wq, scale)


def _fp8_matmul_tc(xq, wq, scale):
    """`fp8_matmul` on the card through `csrc/blocked_matmul.cu::
    gemm_tc_kernel` with both operands e4m3: xq and wq staged as bytes by
    cp.async, converted to f16 (exact) in shared memory, multiplied on
    the tensor cores into an f32 sum, the scale in the epilogue; K split
    over more blocks when the output tiles are too few (`tc_splits`,
    partial sums added in split order). Reached only through
    `fp8_matmul`; its own function so that its launches count apart."""
    return _launch_tc(_fp8_matmul_tc, xq, wq, scale, torch.float32)


_fp8_matmul_tc.launches = 0


def _fp8_matmul_fma(xq, wq, scale):
    """`fp8_matmul` on the card through the f32-FMA kernel
    (`csrc/blocked_matmul.cu::blocked_matmul_kernel<e4m3, e4m3, f32>`,
    the scale as its per-column `ws`), for K the tensor-core build does
    not take. Reached only through `fp8_matmul`."""
    (m, k), n = xq.shape, wq.shape[1]
    if -(-m // 128) > 65535:
        raise ValueError(f"M={m} is over the kernel's 65535 x 128 rows")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    lib = _kernel()
    _build.launch(_fp8_matmul_fma, lib.blocked_matmul,
                  lib.blocked_matmul_error_string, xq.device, xq.data_ptr(),
                  wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k,
                  _CODES[xq.dtype], _CODES[wq.dtype], _CODES[torch.float32])
    return out


_fp8_matmul_fma.launches = 0


class _Fp8Dense(torch.autograd.Function):
    """fp8_dense with the reference's straight-through VJP
    (`_fp8_dense_bwd`): saves the e4m3 operands and both scales;
    dx = ((g * sw) @ wq^T) * sx and dw = (xq^T @ g) * sx in f32, and no
    gradient for the scale (bookkeeping, not a parameter)."""

    @staticmethod
    def forward(ctx, x, w, sx):
        sw = _w_scale(w)
        xq, wq = fp8_quantize(x, sx), fp8_quantize(w, sw)
        ctx.save_for_backward(xq, wq, sx, sw)
        return fp8_matmul(xq, wq, sx * sw)

    @staticmethod
    def backward(ctx, g):
        xq, wq, sx, sw = ctx.saved_tensors
        g = g.float()
        dx = ((g * sw) @ wq.float().t()) * sx
        dw = (xq.float().t() @ g) * sx
        return dx, dw, None


def fp8_dense(x, w, sx):
    """x (B, K) @ w (K, N), both quantized to e4m3 for the product: x
    with the per-tensor scale `sx` (a 0-d f32 tensor, no gradient), w
    with `_w_scale`'s per-out-channel scale. Returns (B, N) f32: the f32
    sum times sx * sw. 2-D operands only (ValueError otherwise)."""
    _check_fp8_operands(x, w)
    return _Fp8Dense.apply(x, w, sx)


def fp8_dense_reference(x, w, sx):
    """Plain torch forward of `fp8_dense` (no autograd Function): the
    same quantize, `fp8_matmul_reference` for the product."""
    _check_fp8_operands(x, w)
    sw = _w_scale(w)
    return fp8_matmul_reference(fp8_quantize(x, sx), fp8_quantize(w, sw),
                                sx * sw)
