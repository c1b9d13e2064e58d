"""Flash attention — counterpart of
`shallowspeed_tpu/ops/flash_attention.py`: the training kernels (K1
forward, K2 dq, K3 dk/dv) behind `flash_attention`, and the serving
decode kernel (K4) behind `paged_flash_decode`, whose int8 branch
(int8 pools with f32 scale planes) launches through
`_paged_flash_decode_int8`. The bf16 builds of K1, K2 and K3 run on
the tensor cores and launch through `_flash_fwd_tc`, `_flash_dq_tc` and
`_flash_dkv_tc`; their f32 builds are f32 FMA.

Each kernel has a wrapper and a plain torch version with the same
arguments. On a CUDA tensor the wrapper launches the hand-written
kernel (`csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`, `csrc/paged_decode.cu`,
built with nvcc for sm_90a at first use, bound with ctypes) or raises,
and adds one to its `.launches` count; on a CPU tensor it computes the
plain version, which the tests hold against the JAX kernels and which
`chip_smoke.py` holds the CUDA kernels against.

The training kernels take the JAX chunk functions' arguments
(`_chunk_fwd`, `_chunk_dq`, `_chunk_dkv`) in the (B, T, H, D) layout
instead of the TPU's folded one: q (B, Tq, H, D); k, v (B, Tk, Hkv, D)
with Hkv | H (query head h reads kv head h // G); `rel` is the global
position of query row 0 minus that of key column 0, so the same kernels
compute any diagonal chunk of a larger attention (ring attention passes
rel != 0; `flash_attention` passes 0). lse and delta are (B, H, Tq) f32.
The kernels read q, k, v and dO through their strides (the model's q,
k, v are slices of one fused projection): nothing is copied.

The decode kernel splits each (slot, kv head) row's live table columns
over `decode_splits` thread blocks, which write f32 partials (m, l,
unnormalised acc) into scratch, and merges them in a second kernel
launched by the same C entry. It keeps its probabilities in f32
through the PV product, where its reference casts them to V's dtype
(float pools) or to q's dtype (int8 pools) first; the JAX kernel keeps
them in f32 too.
In bf16 the kernel and its reference differ by that one rounding. The
tensor-core K1, K2 and K3 round the other way: P (and K2's and K3's dS)
to bf16 before the second product, where the plain versions keep f32;
`kernel_ratio` with `tc_rounding_terms` is the rule that allows for it.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from shallowspeed_tpu_torch.models.kv_cache import (masked_attention,
                                                    position_mask)
from shallowspeed_tpu_torch.ops import _build
from shallowspeed_tpu_torch.ops.attention import NEG, cell_devices, seq_tiles
from shallowspeed_tpu_torch.serving.cache import gather_table

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def paged_flash_decode_reference(q, pool_blk, bt, pos, *, window: int = 0):
    """Plain torch: `masked_attention(q, gather_table(pool, bt), valid)`
    with each row's position (and window) mask; int8 pools carry their
    scale planes through the gather. Same arguments and result as
    `paged_flash_decode`."""
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
    lib.paged_decode.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p]
    lib.paged_decode_int8.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.paged_decode.restype = lib.paged_decode_int8.restype = ctypes.c_int
    lib.paged_decode_smem.argtypes = [ctypes.c_int] * 3
    lib.paged_decode_smem.restype = ctypes.c_int
    lib.paged_decode_error_string.argtypes = [ctypes.c_int]
    lib.paged_decode_error_string.restype = ctypes.c_char_p
    return lib


# K4's split rule: enough (slot, kv head, split) blocks for every SM to
# hold DECODE_BLOCKS_PER_SM of them, at most one split per table column
# and at most DECODE_MAX_SPLITS (the merge pass walks them in order)
DECODE_BLOCKS_PER_SM = 8
DECODE_MAX_SPLITS = 64


def decode_splits(slots: int, kv_heads: int, width: int, sms: int) -> int:
    """How many ways K4 splits each (slot, kv head) row's live table
    columns: a function of the shapes and the card's SM count only, so
    the grid is fixed for given shapes and no host code reads `pos`
    (each block finds its own share of the live columns on the card)."""
    want = -(-DECODE_BLOCKS_PER_SM * sms // max(1, slots * kv_heads))
    return max(1, min(width, DECODE_MAX_SPLITS, want))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(q, kp, vp, bt, pos, window, scales=None):
    """What the decode kernel takes, checked before any launch. Float
    pools are in q's dtype; int8 pools come with `scales` = (k_s, v_s),
    contiguous f32 planes (N, Hkv, bs, 1)."""
    s, h, hd = q.shape
    n, hkv, bs, hd_k = kp.shape
    if vp.shape != kp.shape or hd_k != hd:
        raise ValueError(f"pool shapes k={tuple(kp.shape)} "
                         f"v={tuple(vp.shape)} do not fit q={tuple(q.shape)}")
    if h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} "
                         f"kv heads")
    pool_dtype = q.dtype if scales is None else torch.int8
    if q.dtype not in _DTYPES or kp.dtype != pool_dtype \
            or vp.dtype != pool_dtype:
        raise TypeError(f"paged_flash_decode takes float32 or bfloat16 q "
                        f"and pools of q's dtype, or int8 pools with scale "
                        f"planes; got q={q.dtype}, k={kp.dtype}, "
                        f"v={vp.dtype}")
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
    named = [("q", q), ("k", kp), ("v", vp), ("bt", bt), ("pos", pos)]
    if scales is not None:
        for name, t in zip(("k_s", "v_s"), scales):
            if t.dtype != torch.float32 or t.shape != (n, hkv, bs, 1):
                raise ValueError(f"{name} must be float32 {(n, hkv, bs, 1)}, "
                                 f"got {t.dtype} {tuple(t.shape)}")
            named.append((name, t))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:3]:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (the kernel "
                             f"reads it in 16-byte vectors)")


def paged_flash_decode(q, pool_blk, bt, pos, *, window: int = 0):
    """Single-token attention through a paged block table.

    q: (S, H, hd), one query token per slot; pool_blk: one layer's
    pools {"k"/"v": (N, Hkv, bs, hd)} in q's dtype, or int8 with
    {"k_s"/"v_s": (N, Hkv, bs, 1)} f32 scale planes (the presence of
    "k_s" selects the int8 kernel, as it selects quantization in
    `write_rows`); bt: (S, W) int32 block tables (padding columns point
    at the scratch block); pos: (S,) int32, each slot's position (its
    valid span is [0, pos], windowed when `window > 0`). Returns
    (S, H, hd) in q's dtype.

    A CPU q takes the plain reference. A CUDA q launches the kernel
    (q float32 or bfloat16, hd 64 or 128) or raises; each call of the
    float kernel (its split and merge passes) adds one to
    `paged_flash_decode.launches`, each of the int8 kernel one to
    `_paged_flash_decode_int8.launches`. Nothing here reads device data
    or waits for the card."""
    if q.device.type == "cpu":
        return paged_flash_decode_reference(q, pool_blk, bt, pos,
                                            window=window)
    if "k_s" in pool_blk:
        return _paged_flash_decode_int8(q, pool_blk, bt, pos, window)
    kp, vp = pool_blk["k"], pool_blk["v"]
    _check(q, kp, vp, bt, pos, int(window))
    lib = _kernel()
    out = torch.empty_like(q)
    dims, part = _decode_dims(q, kp, bt, window)
    _build.launch(paged_flash_decode, lib.paged_decode,
                  lib.paged_decode_error_string, q.device,
                  *_ptrs(q, kp, vp, bt, pos, out, part), *dims)
    return out


paged_flash_decode.launches = 0


def _paged_flash_decode_int8(q, pool_blk, bt, pos, window):
    """K4's int8 branch on the card, `csrc/paged_decode.cu::
    paged_decode_int8`, over int8 pools {"k"/"v": (N, Hkv, bs, hd) int8,
    "k_s"/"v_s": (N, Hkv, bs, 1) f32} with q (and the result) in the
    compute dtype, float32 or bfloat16. K's scale multiplies the score
    row and V's folds into the probability row after the normaliser has
    summed it unscaled. Reached only through `paged_flash_decode`; its
    own function so that its launches count apart."""
    kp, vp = pool_blk["k"], pool_blk["v"]
    scales = (pool_blk["k_s"], pool_blk["v_s"])
    _check(q, kp, vp, bt, pos, int(window), scales)
    lib = _kernel()
    out = torch.empty_like(q)
    dims, part = _decode_dims(q, kp, bt, window)
    _build.launch(_paged_flash_decode_int8, lib.paged_decode_int8,
                  lib.paged_decode_error_string, q.device,
                  *_ptrs(q, kp, scales[0], vp, scales[1], bt, pos, out,
                         part), *dims)
    return out


_paged_flash_decode_int8.launches = 0


def _decode_dims(q, kp, bt, window):
    """The decode entries' trailing ints (slots, heads, kv heads,
    head_dim, block size, table width, window, splits, dtype) and the
    f32 scratch of the splits' partials (acc, then m and l), whose size
    follows from the shapes alone."""
    s, h, hd = q.shape
    hkv, w = kp.shape[1], bt.shape[1]
    splits = decode_splits(s, hkv, w, _sm_count(q.device))
    part = torch.empty(s * h * splits * (hd + 2), dtype=torch.float32,
                       device=q.device)
    return (s, h, hkv, hd, kp.shape[2], w, int(window), splits,
            _DTYPES[q.dtype]), part


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


# ------------------------------------------------- training: K1, K2, K3

def _acc_dtype(x):
    """f32 sums, or f64 for f64 inputs (gradcheck on the CPU)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _visible(tq, tk, causal, window, rel, device):
    """(Tq, Tk) bool: query row i (global rel + i) sees key column j."""
    i = torch.arange(tq, device=device)[:, None] + rel
    j = torch.arange(tk, device=device)[None, :]
    ok = torch.ones(tq, tk, dtype=torch.bool, device=device)
    if causal:
        ok = ok & (i >= j)
    if window > 0:
        ok = ok & (j > i - window)
    return ok


def _grouped(x, kvh):
    """(B, T, H, D) -> (B, T, Hkv, G, D) with head h = kv * G + g."""
    b, t, h, d = x.shape
    return x.reshape(b, t, kvh, h // kvh, d)


def _scores(q, k, causal, window, rel):
    """Masked scores (B, Hkv, G, Tq, Tk) in the accumulation dtype, and
    the visibility mask."""
    acc = _acc_dtype(q)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(q, k.shape[2]).to(acc),
                     k.to(acc)) * scale
    ok = _visible(q.shape[1], k.shape[1], causal, window, rel, q.device)
    return torch.where(ok, s, torch.full_like(s, NEG)), ok


def flash_fwd_reference(q, k, v, *, causal=True, window=0, rel=0,
                        out_dtype=None):
    """Plain torch K1: (o in `out_dtype` (default q's) (B, Tq, H, D),
    lse f32 (B, H, Tq)). Masked scores are -1e30 with probability
    exactly 0 and l is guarded by max(l, 1e-30), as in the JAX kernel: a
    row that sees nothing gives o = 0 and lse = -1e30."""
    return _fwd(q, k, v, causal, window, rel, out_dtype=out_dtype)


def _fwd(q, k, v, causal, window, rel, p_dtype=None, out_dtype=None):
    """K1's plain arithmetic; with `p_dtype`, P is rounded to it before
    PV (l still sums the unrounded P); o comes out in `out_dtype`
    (default q's)."""
    b, tq, h, d = q.shape
    s, ok = _scores(q, k, causal, window, rel)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    lg = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = p if p_dtype is None else p.to(p_dtype).to(s.dtype)
    o = torch.einsum("bhgqk,bkhd->bhgqd", pv, v.to(s.dtype)) / lg
    o = o.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d).to(out_dtype or q.dtype)
    return o, (m + torch.log(lg)).reshape(b, h, tq)


def _probs_and_ds(q, k, v, do, lse, delta, causal, window, rel):
    """P = exp(s - lse) on visible pairs (0 elsewhere) and
    dS = P (dO V^T - delta) scale, both (B, Hkv, G, Tq, Tk)."""
    b, tq, h, d = q.shape
    kvh = k.shape[2]
    s, ok = _scores(q, k, causal, window, rel)
    acc = s.dtype
    stats = (b, kvh, h // kvh, tq, 1)
    p = torch.where(ok, torch.exp(s - lse.to(acc).reshape(stats)),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", _grouped(do, kvh).to(acc),
                      v.to(acc))
    scale = 1.0 / float(d) ** 0.5
    return p, p * (dp - delta.to(acc).reshape(stats)) * scale


def flash_dq_reference(q, k, v, do, lse, delta, *, causal=True, window=0,
                       rel=0):
    """Plain torch K2: dQ = dS K, f32 (B, Tq, H, D)."""
    return _dq(q, k, v, do, lse, delta, causal, window, rel)


def _dq(q, k, v, do, lse, delta, causal, window, rel, p_dtype=None):
    """K2's plain arithmetic; with `p_dtype`, dS is rounded to it before
    the dQ product."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window, rel)
    if p_dtype is not None:
        ds = ds.to(p_dtype).to(ds.dtype)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.to(ds.dtype))
    return dq.reshape(q.shape)


def flash_dkv_reference(q, k, v, do, lse, delta, *, causal=True, window=0,
                        rel=0):
    """Plain torch K3: (dK = sum_g dS^T Q, dV = sum_g P^T dO), f32
    (B, Tk, Hkv, D); the sums run over the G query heads of each kv
    head."""
    return _dkv(q, k, v, do, lse, delta, causal, window, rel)


def _dkv(q, k, v, do, lse, delta, causal, window, rel, p_dtype=None):
    """K3's plain arithmetic; with `p_dtype`, P^T and dS^T are rounded to
    it before the dV and dK products (dS from the unrounded P)."""
    kvh = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, window, rel)
    acc = p.dtype
    if p_dtype is not None:
        p, ds = p.to(p_dtype).to(acc), ds.to(p_dtype).to(acc)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, _grouped(do, kvh).to(acc))
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, _grouped(q, kvh).to(acc))
    return dk, dv


# ------------------------------------- the rule the kernels are held to
# Kernel against plain version on the same inputs, per element:
# |diff| <= KERNEL_TOL (|ref| + mean |ref|) for an f32 result summed in
# another order (scaling with the element, or where terms cancel with
# the tensor's typical size), + BF16_ULP |ref| for an output the kernel
# rounds to bf16, + for the tensor-core (bf16) builds the
# `tc_rounding_terms` of their one rounding of P or dS to bf16 before
# the second product. `chip_smoke.py` and the tests share this rule.
KERNEL_TOL = 1e-4
BF16_ULP = 2.0 ** -7
BF16_ROUND = 2.0 ** -8     # largest relative error of one bf16 rounding


def kernel_ratio(got, ref, *, rounded=False, extra=None):
    """(max |diff|, worst |diff| / allowance over the elements), in f32,
    under the rule above: `rounded` adds BF16_ULP |ref|, `extra` (a
    tensor of ref's shape, e.g. a `tc_rounding_terms` entry) is added
    as it is. A check passes at a ratio <= 1."""
    got, ref = got.float(), ref.float()
    mag = ref.abs()
    scale = float(mag.mean())
    if not scale > 0:
        raise ValueError("the plain version's output is all zero")
    allow = KERNEL_TOL * (mag + scale)
    if rounded:
        allow = allow + BF16_ULP * mag
    if extra is not None:
        allow = allow + extra.float()
    diff = (got - ref).abs()
    return float(diff.max()), float((diff / allow).max())


def tc_rounding_terms(q, k, v, do=None, lse=None, delta=None, *,
                      causal=True, window=0, rel=0):
    """What one rounding of P or dS to bf16 before the second product
    can move each output element by, computed in f32 by the plain
    arithmetic on the same inputs: {"o": 2^-8 (P / l) @ |V| (the plain
    attention over |V|), and with dO, lse, delta also "dq": 2^-8
    |dS| @ |K|, "dv": 2^-8 P^T @ |dO| and "dk": 2^-8 |dS|^T @ |Q|},
    each summed as its output is (dK and dV over the G query heads of a
    kv head)."""
    f = [x.float() for x in (q, k, v)]
    terms = {"o": BF16_ROUND * _fwd(f[0], f[1], f[2].abs(), causal, window,
                                    rel)[0]}
    if do is not None:
        kvh = k.shape[2]
        p, ds = _probs_and_ds(f[0], f[1], f[2], do.float(), lse, delta,
                              causal, window, rel)
        abs_do = _grouped(do.float(), kvh).abs()
        abs_q = _grouped(f[0], kvh).abs()
        terms["dq"] = BF16_ROUND * torch.einsum(
            "bhgqk,bkhd->bqhgd", ds.abs(), f[1].abs()).reshape(q.shape)
        terms["dv"] = BF16_ROUND * torch.einsum("bhgqk,bqhgd->bkhd", p,
                                                abs_do)
        terms["dk"] = BF16_ROUND * torch.einsum("bhgqk,bqhgd->bkhd",
                                                ds.abs(), abs_q)
    return terms


def rounded_reference(q, k, v, do, lse, delta, p_dtype, *, causal=True,
                      window=0, rel=0):
    """(o, dQ, dK, dV) of the plain versions with P (for o and dV) and
    dS (for dQ and dK) rounded to `p_dtype` before the second product:
    with bfloat16 what the tensor-core kernels compute, up to summation
    order; with a coarser type (float8_e4m3fn) a slip the rule must
    see; with None the plain versions themselves."""
    kw = dict(causal=causal, window=window, rel=rel)
    o, _ = _fwd(q, k, v, p_dtype=p_dtype, **kw)
    return (o, _dq(q, k, v, do, lse, delta, p_dtype=p_dtype, **kw),
            *_dkv(q, k, v, do, lse, delta, p_dtype=p_dtype, **kw))


@functools.cache
def _train_kernels():
    fwd = _build.library("flash_fwd")
    fwd.flash_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 12
                              + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    fwd.flash_fwd.restype = fwd.flash_fwd_tc_smem.restype = ctypes.c_int
    fwd.flash_fwd_tc_smem.argtypes = [ctypes.c_int]
    fwd.flash_fwd_error_string.argtypes = [ctypes.c_int]
    fwd.flash_fwd_error_string.restype = ctypes.c_char_p
    bwd = _build.library("flash_bwd")
    bwd.flash_dq.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 15
                             + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    bwd.flash_dkv.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 15
                              + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    bwd.flash_dq.restype = bwd.flash_dkv.restype = ctypes.c_int
    for smem in (bwd.flash_dq_tc_smem, bwd.flash_dkv_tc_smem):
        smem.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int]
    bwd.flash_bwd_error_string.argtypes = [ctypes.c_int]
    bwd.flash_bwd_error_string.restype = ctypes.c_char_p
    return fwd, bwd


def _strides(*tensors):
    """The (batch, seq, head) element strides of each (B, T, H, D)
    tensor, flattened."""
    return tuple(s for t in tensors for s in t.stride()[:3])


def kernel_ready(t) -> bool:
    """Whether the training kernels can read `t` through its strides:
    head_dim contiguous, the other strides and the address on 16-byte
    boundaries."""
    vec = 16 // t.element_size()
    return (t.stride(3) == 1 and all(s % vec == 0 for s in _strides(t))
            and t.data_ptr() % 16 == 0)


def _dims(q, k, causal, window, rel):
    """The training entries' trailing ints: batch, heads, kv heads, Tq,
    Tk, head_dim, causal, window, rel, dtype."""
    b, tq, h, d = q.shape
    return (b, h, k.shape[2], tq, k.shape[1], d, int(bool(causal)),
            int(window), int(rel), _DTYPES[q.dtype])


def _check_train(name, window, q, k, v, do=None, lse=None, delta=None):
    if window < 0:
        raise ValueError(f"{name}: window={window}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, T, H, D) / "
                         f"(B, Tk, Hkv, D)")
    b, tq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim={d} is not one the kernel takes "
                         f"{_HEAD_DIMS}")
    named = [("q", q), ("k", k), ("v", v)]
    if do is not None:
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} does "
                             f"not match q")
        named.append(("do", do))
        for sname, st in (("lse", lse), ("delta", delta)):
            if (st.shape != (b, h, tq) or st.dtype != torch.float32
                    or not st.is_contiguous()):
                raise ValueError(f"{name}: {sname} must be contiguous "
                                 f"float32 (B, H, Tq) = {(b, h, tq)}")
            named.append((sname, st))
    for tname, t in named:
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, q on "
                             f"{q.device}")
    for tname, t in named[:4]:
        if not kernel_ready(t):
            raise ValueError(f"{name}: {tname} has strides {t.stride()} / "
                             f"address {t.data_ptr():#x}; the kernel needs "
                             f"head_dim contiguous and 16-byte aligned rows")


def flash_fwd(q, k, v, *, causal=True, window=0, rel=0, out_dtype=None):
    """K1: (o in `out_dtype` (default q's) (B, Tq, H, D), lse f32 (B, H,
    Tq)); `out_dtype` float32 is the reference's f32 chunk output of
    ring attention. A CPU q takes `flash_fwd_reference`; a CUDA q
    launches `csrc/flash_fwd.cu` (head_dim 64 or 128) or raises: float32
    its f32-FMA kernel, counted on `flash_fwd.launches`; bfloat16 its
    tensor-core kernel, through `_flash_fwd_tc` (bf16 o) or
    `_flash_fwd_tc_f32o` (f32 o)."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, window=window,
                                   rel=rel, out_dtype=out_dtype)
    _check_train("flash_fwd", window, q, k, v)
    if out_dtype not in (None, q.dtype, torch.float32):
        raise TypeError(f"flash_fwd writes o in q's dtype or float32, not "
                        f"{out_dtype}")
    if q.dtype == torch.bfloat16:
        if out_dtype == torch.float32:
            return _flash_fwd_tc_f32o(q, k, v, causal, window, rel)
        return _flash_fwd_tc(q, k, v, causal, window, rel)
    return _launch_fwd(flash_fwd, q, k, v, causal, window, rel)


flash_fwd.launches = 0


def _flash_fwd_tc(q, k, v, causal, window, rel):
    """K1's bf16 build on the card, `csrc/flash_fwd.cu::
    flash_fwd_tc_kernel`: wgmma on TMA-fed tiles, P rounded to bf16 as
    the PV product's register operand (`tc_rounding_terms` bounds that
    rounding). Reached only through `flash_fwd`; its own function so
    that its launches count apart."""
    return _launch_fwd(_flash_fwd_tc, q, k, v, causal, window, rel)


_flash_fwd_tc.launches = 0


def _flash_fwd_tc_f32o(q, k, v, causal, window, rel):
    """K1's bf16 build with an f32 epilogue, `csrc/flash_fwd.cu::
    flash_fwd_tc_kernel<D, true>`: the same wgmma kernel, o written as
    f32 from its f32 accumulator (ring attention's chunks, whose
    log-sum-exp merge then sees each chunk unrounded). Reached only
    through `flash_fwd(..., out_dtype=torch.float32)`; its own function
    so that its launches count apart."""
    return _launch_fwd(_flash_fwd_tc_f32o, q, k, v, causal, window, rel,
                       torch.float32)


_flash_fwd_tc_f32o.launches = 0


def _launch_fwd(counter, q, k, v, causal, window, rel, out_dtype=None):
    b, tq, h, _ = q.shape
    fwd, _ = _train_kernels()
    o = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _build.launch(counter, fwd.flash_fwd, fwd.flash_fwd_error_string,
                  q.device, *_ptrs(q, k, v, o, lse), *_strides(q, k, v, o),
                  *_dims(q, k, causal, window, rel), _DTYPES[o.dtype])
    return o, lse


def flash_dq(q, k, v, do, lse, delta, *, causal=True, window=0, rel=0):
    """K2: dQ, f32 (B, Tq, H, D). A CPU q takes `flash_dq_reference`; a
    CUDA q launches `csrc/flash_bwd.cu::flash_dq` or raises: float32 its
    f32-FMA kernel, counted on `flash_dq.launches`; bfloat16 its
    tensor-core kernel, through `_flash_dq_tc`."""
    if q.device.type == "cpu":
        return flash_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                  window=window, rel=rel)
    _check_train("flash_dq", window, q, k, v, do, lse, delta)
    if q.dtype == torch.bfloat16:
        return _flash_dq_tc(q, k, v, do, lse, delta, causal, window, rel)
    return _launch_dq(flash_dq, q, k, v, do, lse, delta, causal, window, rel)


flash_dq.launches = 0


def _flash_dq_tc(q, k, v, do, lse, delta, causal, window, rel):
    """K2's bf16 build on the card, `csrc/flash_bwd.cu::
    flash_dq_tc_kernel`: wgmma on TMA-fed tiles, dS rounded to bf16 as
    the dQ product's register operand (`tc_rounding_terms` bounds that
    rounding). Reached only through `flash_dq`; its own function so
    that its launches count apart."""
    return _launch_dq(_flash_dq_tc, q, k, v, do, lse, delta, causal, window,
                      rel)


_flash_dq_tc.launches = 0


def _launch_dq(counter, q, k, v, do, lse, delta, causal, window, rel):
    _, bwd = _train_kernels()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _build.launch(counter, bwd.flash_dq, bwd.flash_bwd_error_string,
                  q.device, *_ptrs(q, k, v, do, lse, delta, dq),
                  *_strides(q, k, v, do, dq),
                  *_dims(q, k, causal, window, rel))
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, causal=True, window=0, rel=0):
    """K3: (dK, dV), f32 (B, Tk, Hkv, D), summed over each kv head's G
    query heads. A CPU q takes `flash_dkv_reference`; a CUDA q launches
    `csrc/flash_bwd.cu::flash_dkv` or raises: float32 its f32-FMA
    kernel, counted on `flash_dkv.launches`; bfloat16 its tensor-core
    kernel, through `_flash_dkv_tc`."""
    if q.device.type == "cpu":
        return flash_dkv_reference(q, k, v, do, lse, delta, causal=causal,
                                   window=window, rel=rel)
    _check_train("flash_dkv", window, q, k, v, do, lse, delta)
    if q.dtype == torch.bfloat16:
        return _flash_dkv_tc(q, k, v, do, lse, delta, causal, window, rel)
    return _launch_dkv(flash_dkv, q, k, v, do, lse, delta, causal, window,
                       rel)


flash_dkv.launches = 0


def _flash_dkv_tc(q, k, v, do, lse, delta, causal, window, rel):
    """K3's bf16 build on the card, `csrc/flash_bwd.cu::
    flash_dkv_tc_kernel`: wgmma on TMA-fed tiles, P^T and dS^T rounded
    to bf16 as the dV and dK products' register operands
    (`tc_rounding_terms` bounds that rounding). Reached only through
    `flash_dkv`; its own function so that its launches count apart."""
    return _launch_dkv(_flash_dkv_tc, q, k, v, do, lse, delta, causal,
                       window, rel)


_flash_dkv_tc.launches = 0


def _launch_dkv(counter, q, k, v, do, lse, delta, causal, window, rel):
    _, bwd = _train_kernels()
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    _build.launch(counter, bwd.flash_dkv, bwd.flash_bwd_error_string,
                  q.device, *_ptrs(q, k, v, do, lse, delta, dk, dv),
                  *_strides(q, k, v, do, dk),
                  *_dims(q, k, causal, window, rel))
    return dk, dv


def attention_delta(do, o):
    """delta = rowsum(dO * O) as f32 (B, H, T) — from o in its own
    dtype, as the JAX backward computes it (`_delta_of`)."""
    acc = _acc_dtype(o)
    return (do.to(acc) * o.to(acc)).sum(dim=-1).transpose(1, 2).contiguous()


class AttnStash:
    """K1's outputs (o, lse) of one rematerialized block, kept from its
    forward through its recompute: the remat policies "attn" and "dots"
    save the attention output, and with it lse, so the backward never
    relaunches K1. A selective-checkpoint policy cannot save them: K1
    launches through ctypes, which torch's dispatch never sees, and on
    recompute it would launch again into a fresh buffer. Inside
    `recording()`, each `flash_attention` call keeps its (o, lse);
    inside `replaying()`, the same calls return them in the same order
    without a launch. `busy` is set while K1's wrapper runs, so a
    selective policy can leave the wrapper's own ops alone."""

    _local = threading.local()

    def __init__(self):
        self.saved: list = []
        self._next = 0
        self.busy = False

    @classmethod
    def current(cls):
        return getattr(cls._local, "stash", None), getattr(
            cls._local, "replay", False)

    def recording(self):
        return _StashMode(self, False)

    def replaying(self):
        return _StashMode(self, True)

    def fwd(self, q, k, v, causal, window, replay):
        if replay:
            o, lse = self.saved[self._next]
            self._next += 1
            # fresh tensor objects on the same storage: autograd gives
            # each output its own history
            return o.detach(), lse.detach()
        self.busy = True
        try:
            o, lse = flash_fwd(q, k, v, causal=causal, window=window)
        finally:
            self.busy = False
        self.saved.append((o.detach(), lse.detach()))
        return o, lse


class _StashMode:
    """The context in which `flash_attention` records into, or replays
    from, a stash; re-enterable (a second backward recomputes again)."""

    def __init__(self, stash: AttnStash, replay: bool):
        self.stash, self.replay = stash, replay
        self._prev: list = []

    def __enter__(self):
        local = AttnStash._local
        self._prev.append(AttnStash.current())
        local.stash, local.replay = self.stash, self.replay
        if not self.replay:
            self.stash.saved.clear()
        self.stash._next = 0

    def __exit__(self, *exc):
        AttnStash._local.stash, AttnStash._local.replay = self._prev.pop()


class _FlashAttention(torch.autograd.Function):
    """K1 forward (or, in a block's remat recompute, the outputs it kept,
    `AttnStash`); backward = delta, then K2 and K3, with dq, dk, dv
    cast from f32 to the inputs' dtypes (`_flash_bwd_rule`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        stash, replay = AttnStash.current()
        if stash is None:
            o, lse = flash_fwd(q, k, v, causal=causal, window=window)
        else:
            o, lse = stash.fwd(q, k, v, causal, window, replay)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not kernel_ready(do):
            do = do.contiguous()     # e.g. an expanded (stride-0) cotangent
        delta = attention_delta(do, o)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dq = flash_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, **kw)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Fused attention with a hand-written backward; same contract as
    `ops.attention.attention` (q (B, T, H, D), k/v (B, T, Hkv, D), native
    GQA, `window > 0` a sliding window). CUDA tensors run K1/K2/K3, CPU
    tensors their plain versions."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


# ------------------------------------------- ring flash (sequence parallel)

def ring_hops(sp: int, idx: int, t: int, causal: bool, window: int):
    """(hop i, rel) of every chunk cell `idx` of an sp ring computes, in
    hop order: at hop i it holds the K/V block of cell (idx - i) mod sp,
    whose keys start (i t) before its queries when idx >= i and
    ((i - sp) t) after them otherwise. Under causal masking with no
    window the idx < i chunks see nothing and are skipped, as the
    reference's `lax.cond` skips them; otherwise they run at their
    negative rel."""
    for i in range(sp):
        if idx >= i:
            yield i, i * t
        elif not (causal and window == 0):
            yield i, (i - sp) * t


def merge_chunks(o_acc, lse_acc, o_i, lse_i):
    """The reference's `_merge_chunks`: the log-sum-exp merge of two
    normalised chunks, o (B, Tq, H, D) f32 and lse (B, H, Tq) f32; a
    fully masked chunk (lse -1e30) adds nothing."""
    m = torch.maximum(lse_acc, lse_i)
    a = torch.exp(lse_acc - m)
    b = torch.exp(lse_i - m)
    denom = torch.clamp(a + b, min=1e-30)

    def rows(x):                     # (B, H, Tq) -> (B, Tq, H, 1)
        return x.transpose(1, 2)[..., None]

    o = (o_acc * rows(a) + o_i.float() * rows(b)) / rows(denom)
    return o, m + torch.log(denom)


class _RingFlash(torch.autograd.Function):
    """Ring attention over one replica's sp cells with K1/K2/K3 as each
    chunk's compute — `shallowspeed_tpu/ops/flash_attention.py::
    ring_flash_attention`. Forward: each cell's query tile meets every
    visiting K/V block in hop order (`ring_hops`), K1 writing each
    chunk's o in f32 and `merge_chunks` folding it in. Backward: delta
    from the merged f32 o, then the reverse ring, hop by hop: K2 adds
    into the cell's dq, K3's dk and dv into accumulators that travel with
    their block and come home after the last hop. Each hop's move of a
    block or an accumulator is a `.to(cell device)`."""

    @staticmethod
    def forward(ctx, q, k, v, devices, causal, window):
        sp = len(devices)
        qs, ks, vs = (seq_tiles(x, devices) for x in (q, k, v))
        t = qs[0].shape[1]
        b, _, h, _ = q.shape
        outs, lses = [], []
        for idx, dev in enumerate(devices):
            o = torch.zeros(qs[idx].shape, dtype=torch.float32, device=dev)
            lse = torch.full((b, h, t), NEG, dtype=torch.float32, device=dev)
            for i, rel in ring_hops(sp, idx, t, causal, window):
                src = (idx - i) % sp
                o_i, lse_i = flash_fwd(qs[idx], ks[src].to(dev),
                                       vs[src].to(dev), causal=causal,
                                       window=window, rel=rel,
                                       out_dtype=torch.float32)
                o, lse = merge_chunks(o, lse, o_i, lse_i)
            outs.append(o)
            lses.append(lse)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.devices, ctx.causal, ctx.window = devices, causal, window
        ctx.home = q.device
        return torch.cat([o.to(q.dtype).to(q.device) for o in outs], dim=1)

    @staticmethod
    def backward(ctx, do):
        devices = ctx.devices
        sp = len(devices)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (list(saved[i * sp:(i + 1) * sp])
                                  for i in range(5))
        t = qs[0].shape[1]
        dos = []
        for x in seq_tiles(do, devices):
            if x.device.type == "cuda" and not kernel_ready(x):
                x = x.contiguous()   # e.g. an expanded (stride-0) cotangent
            dos.append(x)
        deltas = [attention_delta(d, o) for d, o in zip(dos, outs)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in qs]
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in ks]
        dv = [torch.zeros_like(x) for x in dk]
        kw = dict(causal=ctx.causal, window=ctx.window)
        for i in range(sp):
            for idx, dev in enumerate(devices):
                rel = dict(ring_hops(sp, idx, t, ctx.causal,
                                     ctx.window)).get(i)
                if rel is None:
                    continue
                src = (idx - i) % sp
                args = (qs[idx], ks[src].to(dev), vs[src].to(dev), dos[idx],
                        lses[idx], deltas[idx])
                dq[idx] += flash_dq(*args, rel=rel, **kw)
                dk_i, dv_i = flash_dkv(*args, rel=rel, **kw)
                dk[src] = dk[src].to(dev) + dk_i
                dv[src] = dv[src].to(dev) + dv_i

        def home(parts, like):
            return torch.cat([x.to(ctx.home) for x in parts],
                             dim=1).to(like.dtype)

        return (home(dq, qs[0]), home(dk, ks[0]), home(dv, vs[0]), None,
                None, None)


def ring_flash_attention(q, k, v, devices, causal: bool = True,
                         window: int = 0):
    """Ring attention with the flash kernels as the local compute; the
    reference's contract on the gathered sequence: q (B, T, H, D), k/v
    (B, T, Hkv, D) on the replica's home cell, the sequence cut into one
    tile per cell of `devices` (a sequence of devices, or a count of
    cells on q's device), the result (B, T, H, D) in q's dtype on q's
    device. Under causal masking with no window each layer launches K1,
    K2 and K3 sp (sp + 1) / 2 times each, else sp^2 times."""
    return _RingFlash.apply(q, k, v, cell_devices(devices, q), bool(causal),
                            int(window))
