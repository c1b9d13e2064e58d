"""The port's CUDA kernels on the card, against their plain torch
versions. Every test here carries the `cuda` marker and skips without
a GPU. This file imports neither jax nor the JAX package, so it also
runs on a GPU machine without JAX:

    pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from shallowspeed_tpu_torch.ops import flash_attention as FA


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kvh,window", [(16, 0), (4, 0), (16, 100)],
                         ids=["mha", "gqa", "window"])
def test_cuda_kernel_matches_plain_version(cuda, dtype, tol, kvh, window):
    """The kernel on the card against its plain version at the serving
    shapes (f32: summation order only; bf16: the output is rounded once
    and the plain version rounds P before PV)."""
    rng = np.random.default_rng(kvh + window)
    s, h, hd, bs, w = 8, 16, 128, 16, 64
    n = s * w + 1
    bt = torch.from_numpy(rng.permutation(np.arange(1, n)).reshape(s, w)
                          .astype(np.int32)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, w * bs, s).astype(np.int32)
                           ).to(cuda)
    pool = {"k": torch.randn(n, kvh, bs, hd, device=cuda).to(dtype),
            "v": torch.randn(n, kvh, bs, hd, device=cuda).to(dtype)}
    q = torch.randn(s, h, hd, device=cuda).to(dtype)
    before = FA.paged_flash_decode.launches
    got = FA.paged_flash_decode(q, pool, bt, pos, window=window).float()
    ref = FA.paged_flash_decode_reference(q, pool, bt, pos,
                                          window=window).float()
    assert FA.paged_flash_decode.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kvh,window", [(16, 0), (4, 0), (16, 100)],
                         ids=["mha", "gqa", "window"])
def test_cuda_int8_kernel_matches_plain_version(cuda, dtype, kvh, window):
    """K4's int8 branch on the card against its plain version at the
    serving shapes, q in f32 or bf16, per element: 1e-4 of |ref| + mean
    |ref| (summation order); for bf16 q also one bf16 rounding of the
    output (2^-7 |ref|) and the plain version's rounding of P * v_s to
    bf16 before PV (2^-8 of the attention over |V|)."""
    from shallowspeed_tpu_torch.models.kv_cache import quantize_kv

    rng = np.random.default_rng(kvh + window)
    s, h, hd, bs, w = 8, 16, 128, 16, 64
    n = s * w + 1
    bt = torch.from_numpy(rng.permutation(np.arange(1, n)).reshape(s, w)
                          .astype(np.int32)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, w * bs, s).astype(np.int32)
                           ).to(cuda)
    pool = {}
    for name in ("k", "v"):
        pool[name], pool[name + "_s"] = quantize_kv(
            torch.randn(n, kvh, bs, hd, device=cuda))
    q = torch.randn(s, h, hd, device=cuda).to(dtype)
    before = (FA.paged_flash_decode.launches,
              FA._paged_flash_decode_int8.launches)
    got = FA.paged_flash_decode(q, pool, bt, pos, window=window).float()
    ref = FA.paged_flash_decode_reference(q, pool, bt, pos,
                                          window=window).float()
    assert (FA.paged_flash_decode.launches,
            FA._paged_flash_decode_int8.launches) == (before[0],
                                                      before[1] + 1)
    allow = 1e-4 * (ref.abs() + ref.abs().mean())
    if dtype == torch.bfloat16:
        pv = FA.paged_flash_decode_reference(
            q.float(), dict(pool, v=pool["v"].abs()), bt, pos,
            window=window)
        allow = allow + 2.0 ** -7 * ref.abs() + 2.0 ** -8 * pv
    assert torch.isfinite(got).all()
    assert float(((got - ref).abs() / allow).max()) <= 1.0


# K4's split edges at the serving width (hd 128, 8 slots): (heads, kv
# heads, bs, W, positions or None for random ones, window). The serving
# shape (16 kv heads, W 64) splits each row 9 ways on an H100. G = 3
# splits the rows 2 ways unevenly over the warps; G = 40 takes two row
# chunks (32 + 8 rows).
SPLIT_EDGES = {
    "pos0-beside-full": (16, 16, 16, 64, [0] + [1023] * 7, 0),
    "shorter-than-splits": (16, 16, 16, 64, [0, 3, 15, 16, 40, 63, 17, 50],
                            0),
    "window-inside-a-block": (16, 16, 16, 64, None, 77),
    "w1": (16, 16, 16, 1, [0, 3, 15, 7, 9, 1, 12, 5], 0),
    "g8": (16, 2, 16, 64, None, 0),
    "g3": (12, 4, 16, 64, None, 0),
    "g40-row-chunks": (40, 1, 16, 64, None, 0),
    "bs8": (16, 16, 8, 64, None, 0),
    "bs32": (16, 16, 32, 32, None, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("pools", ["float", "int8"])
@pytest.mark.parametrize("edge", list(SPLIT_EDGES))
def test_cuda_decode_split_edges_match_plain_version(cuda, dtype, pools,
                                                     edge):
    """The split kernel at the edges of its split against the plain
    version, under the bounds above: float pools 1e-4 (f32) or 1e-2
    (bf16) of max |ref|; int8 pools per element, 1e-4 of |ref| + mean
    |ref|, and for bf16 q one bf16 rounding of the output and the plain
    version's rounding of P * v_s. Each call launches its build once."""
    from shallowspeed_tpu_torch.models.kv_cache import quantize_kv

    h, kvh, bs, w, pos, window = SPLIT_EDGES[edge]
    rng = np.random.default_rng(len(edge))
    s, hd = 8, 128
    n = s * w + 1
    bt = torch.from_numpy(rng.permutation(np.arange(1, n)).reshape(s, w)
                          .astype(np.int32)).to(cuda)
    if pos is None:
        pos = rng.integers(0, w * bs, s)
    pos = torch.from_numpy(np.asarray(pos, np.int32)).to(cuda)
    shape = (n, kvh, bs, hd)
    if pools == "int8":
        pool = {}
        for name in ("k", "v"):
            pool[name], pool[name + "_s"] = quantize_kv(
                torch.randn(shape, device=cuda))
        added = (0, 1)
    else:
        pool = {"k": torch.randn(shape, device=cuda).to(dtype),
                "v": torch.randn(shape, device=cuda).to(dtype)}
        added = (1, 0)
    q = torch.randn(s, h, hd, device=cuda).to(dtype)
    before = (FA.paged_flash_decode.launches,
              FA._paged_flash_decode_int8.launches)
    got = FA.paged_flash_decode(q, pool, bt, pos, window=window).float()
    assert (FA.paged_flash_decode.launches,
            FA._paged_flash_decode_int8.launches) == (before[0] + added[0],
                                                      before[1] + added[1])
    ref = FA.paged_flash_decode_reference(q, pool, bt, pos,
                                          window=window).float()
    assert torch.isfinite(got).all()
    if pools == "float":
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol
        return
    allow = 1e-4 * (ref.abs() + ref.abs().mean())
    if dtype == torch.bfloat16:
        pv = FA.paged_flash_decode_reference(
            q.float(), dict(pool, v=pool["v"].abs()), bt, pos,
            window=window)
        allow = allow + 2.0 ** -7 * ref.abs() + 2.0 ** -8 * pv
    assert float(((got - ref).abs() / allow).max()) <= 1.0


def _quantized(mode, k, n, dev, seed=0):
    from shallowspeed_tpu_torch.models import transformer as T

    g = torch.Generator(device="cpu").manual_seed(seed)
    w = (torch.randn(k, n, generator=g) / k ** 0.5).to(dev)
    q = T.quantize_weights({"W": w, "b": torch.zeros(n, device=dev)}, mode)
    return q["Wq"], q["Ws"], g


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_cuda_dequant_matmul_bf16_keeps_the_sum_in_f32(cuda, mode):
    """`dequant_matmul` in bf16 on the card (the tensor-core GEMM reading
    the weight at 1 byte an element) against the exact product of the
    same quantized leaves (f64 on the CPU), per element: one bf16
    rounding of the result (2^-8 |ref|) plus f32 summation-order noise
    (1e-5 of max |ref|). A bf16 rounding of the sum before the scale
    must exceed that bound."""
    from shallowspeed_tpu_torch.ops import matmul as M

    wq, ws, g = _quantized(mode, 512, 1024, cuda)
    x = torch.randn(2, 8, 512, generator=g).to(cuda).to(torch.bfloat16)
    ref = (x.cpu().double() @ wq.cpu().double()) * ws.cpu().double()
    allow = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()

    def ratio(t):
        return float(((t.cpu().double() - ref).abs() / allow).max())

    before = M._dequant_matmul_tc.launches
    got = M.dequant_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert M._dequant_matmul_tc.launches == before + 1
    slip = ((x.float() @ wq.float()).bfloat16().float() * ws).bfloat16()
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 1024)
    assert ratio(got) <= 1.0
    assert ratio(slip) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("m", [8, 256, 300])
@pytest.mark.parametrize("k,n", [(2048, 6144), (1024, 4096), (8192, 2048)],
                         ids=["qkv", "wide", "down"])
def test_cuda_dequant_matmul_tc_rows_and_splits(cuda, mode, m, k, n):
    """The tensor-core route at the tick's 8 rows (split over K), a
    prefill chunk's 256 and a ragged 300 (two warpgroups, rows past M
    masked), against the exact product under `_dequant_err`'s rule."""
    from shallowspeed_tpu_torch.ops import matmul as M

    wq, ws, g = _quantized(mode, k, n, cuda, seed=m)
    x = torch.randn(m, k, generator=g).to(cuda).bfloat16()
    assert M.dequant_matmul_route(x.dtype, k, n) == "tc"
    before = M._dequant_matmul_tc.launches
    got = M.dequant_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert M._dequant_matmul_tc.launches == before + 1
    ref = (x.double() @ wq.double()) * ws.double()
    allow = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
    assert got.shape == (m, n) and torch.isfinite(got).all()
    assert float(((got.double() - ref).abs() / allow).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype,k,n", [(torch.float32, 512, 1024),
                                       (torch.bfloat16, 520, 1000)],
                         ids=["f32", "bf16-unaligned"])
def test_cuda_dequant_matmul_fma_route(cuda, mode, dtype, k, n):
    """f32 x, and bf16 x at a shape the tensor-core route does not take,
    go through the f32-FMA kernel with a 1-byte y: each element within
    the f32 summation bound K 2^-24 (|x| @ |wq|) ws plus one rounding of
    the output."""
    from shallowspeed_tpu_torch.ops import matmul as M

    wq, ws, g = _quantized(mode, k, n, cuda)
    x = torch.randn(8, k, generator=g).to(cuda).to(dtype)
    before = M._dequant_matmul_fma.launches
    got = M.dequant_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert M._dequant_matmul_fma.launches == before + 1
    assert got.dtype == dtype
    xd, wd, sd = x.double(), wq.double(), ws.double()
    ref = (xd @ wd) * sd
    rnd = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    allow = k * 2.0 ** -24 * (xd.abs() @ wd.abs()) * sd + rnd * ref.abs()
    assert float(((got.double() - ref).abs() / allow).max()) <= 1.0


@pytest.mark.cuda
def test_cuda_dequant_matmul_adds_no_weight_copy(cuda):
    """One call at the head's shape, (8, 2048) @ (2048, 32768) int8, adds
    under 16 MB to the peak of device memory: no bf16 copy of the
    weight (134 MB) is made."""
    from shallowspeed_tpu_torch.ops import matmul as M

    wq, ws, g = _quantized("int8", 2048, 32768, cuda)
    x = torch.randn(8, 2048, generator=g).to(cuda).bfloat16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    M.dequant_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - base < 16 * 2 ** 20


# (B, Tq, Tk, H, Hkv, D, causal, window, rel): the chip_smoke cases at
# test size, including a row that sees nothing (rel -70, causal)
TRAIN_CASES = {
    "mha": (2, 128, 128, 4, 4, 64, True, 0, 0),
    "gqa": (2, 128, 128, 8, 2, 128, True, 0, 0),
    "window": (1, 192, 192, 4, 4, 64, True, 40, 0),
    "rel": (1, 128, 192, 4, 2, 64, True, 0, 64),
    "ragged": (2, 100, 100, 4, 4, 128, True, 0, 0),
    "full": (1, 96, 80, 2, 2, 64, False, 0, 0),
    "empty-rows": (1, 128, 64, 2, 2, 64, True, 0, -70),
}


def _train_inputs(case, dtype, dev, seed=0):
    b, tq, tk, h, hkv, d, causal, window, rel = case
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev).to(dtype)

    q, do = rnd(b, tq, h, d), rnd(b, tq, h, d)
    k, v = rnd(b, tk, hkv, d), rnd(b, tk, hkv, d)
    return q, k, v, do, dict(causal=causal, window=window, rel=rel)


def _rel_err(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-6))


def _elementwise_ratio(got, ref, rounded, extra=None):
    """Worst |diff| / allowance over the elements under the kernels'
    rule (`FA.kernel_ratio`): 1e-4 of |ref| + mean |ref| (summation order
    in f32), plus one bf16 ulp of |ref| (<= 2^-7 |ref|) for an output
    rounded to bf16, plus `extra` (a `tc_rounding_terms` entry for the
    tensor-core builds' one rounding of P or dS)."""
    assert torch.isfinite(got).all()
    return FA.kernel_ratio(got, ref, rounded=rounded, extra=extra)[1]


def _check_training_kernels(q, k, v, do, kw):
    """K1, K2, K3 on the card against their plain versions, and which
    launcher each call counted on: bf16 on the tensor-core builds, f32
    on the FMA ones."""
    bf = q.dtype == torch.bfloat16
    tc = (FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc)
    fma = (FA.flash_fwd, FA.flash_dq, FA.flash_dkv)
    counters, idle = (tc, fma) if bf else (fma, tc)
    counts = [c.launches for c in counters + idle]
    o, lse = FA.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = FA.flash_fwd_reference(q, k, v, **kw)
    delta = FA.attention_delta(do, o)
    terms = FA.tc_rounding_terms(q, k, v, do, lse, delta, **kw) if bf else {}
    assert _elementwise_ratio(o, o_ref, bf, terms.get("o")) <= 1.0
    seen = lse_ref > -1e29            # rows that see at least one key
    assert torch.equal(lse > -1e29, seen)
    assert _rel_err(lse[seen], lse_ref[seen]) <= 1e-5
    dq = FA.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_dkv(q, k, v, do, lse, delta, **kw)
    dq_ref = FA.flash_dq_reference(q, k, v, do, lse, delta, **kw)
    dk_ref, dv_ref = FA.flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for got, ref, name in ((dq, dq_ref, "dq"), (dk, dk_ref, "dk"),
                           (dv, dv_ref, "dv")):
        assert got.dtype == torch.float32
        assert _elementwise_ratio(got, ref, False, terms.get(name)) <= 1.0
    assert [c.launches for c in counters + idle] == \
        [n + 1 for n in counts[:3]] + counts[3:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_training_kernels_match_plain_versions(cuda, dtype, case):
    """K1, K2, K3 on the card against their plain versions on the same
    inputs, per element (f32 results: summation order only; bf16 o: one
    rounding, and the backward reads the rounded o through delta in
    both; the bf16 builds also round P or dS to bf16 once, on tensor
    cores), with each launch counted on its dtype's launcher."""
    _check_training_kernels(*_train_inputs(TRAIN_CASES[case], dtype, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_tensor_core_kernels_read_fused_views(cuda, kvh):
    """The bf16 (tensor-core) K1, K2 and K3 on q, k, v that are strided
    slices of one fused (B, T, H + 2 Hkv, D) tensor, as the model's are,
    under the same rule."""
    g = torch.Generator(device="cpu").manual_seed(11 + kvh)
    b, t, h, d = 2, 200, 4, 128
    fused = torch.randn(b, t, h + 2 * kvh, d, generator=g).to(cuda).to(
        torch.bfloat16)
    q, k, v = fused[:, :, :h], fused[:, :, h:h + kvh], fused[:, :, h + kvh:]
    assert not (q.is_contiguous() or k.is_contiguous())
    do = torch.randn(b, t, h, d, generator=g).to(cuda).to(torch.bfloat16)
    _check_training_kernels(q, k, v, do, dict(causal=True, window=0, rel=0))


# the LM pipeline's stage calls at the 1.21B LM's width (chip_smoke
# phase 2's "stage", "sp-tile", "sp-tile-rel" and "ulysses-group"): a
# vpp chunk's one-row microbatch and an sp tile of a ring-flash hop, on
# and off the diagonal, on strided views of the fused qkv; an
# ulysses-flash cell's gathered head group, contiguous
STAGE_CASES = {
    "vpp-chunk": ((1, 2048, 2048, 16, 16, 128, True, 0, 0), True),
    "sp-tile": ((1, 1024, 1024, 16, 16, 128, True, 0, 0), True),
    "sp-tile-rel": ((1, 1024, 1024, 16, 16, 128, True, 0, 1024), True),
    "ulysses-group": ((1, 2048, 2048, 8, 8, 128, True, 0, 0), False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_tensor_core_kernels_at_the_pipeline_stage_shapes(cuda, case):
    """The bf16 K1, K2 and K3 at the shapes a vpp chunk, an sp tile and
    an ulysses head group give them, under the same rule."""
    shape, fused = STAGE_CASES[case]
    b, t, _, h, hkv, d, causal, window, rel = shape
    if not fused:
        _check_training_kernels(*_train_inputs(shape, torch.bfloat16, cuda))
        return
    g = torch.Generator(device="cpu").manual_seed(17)
    qkv = torch.randn(b, t, h + 2 * hkv, d, generator=g).to(cuda).to(
        torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    do = torch.randn(b, t, h, d, generator=g).to(cuda).to(torch.bfloat16)
    _check_training_kernels(q, k, v, do,
                            dict(causal=causal, window=window, rel=rel))


@pytest.mark.cuda
def test_tensor_core_kernels_take_a_cotangent_broadcast_over_the_batch(
        cuda):
    """A cotangent broadcast over the batch (stride 0 there, head_dim
    contiguous) reaches the bf16 K2 and K3 as it is, through TMA maps
    built on its strides, and gives the gradients of the same cotangent
    made contiguous, bit for bit (the kernels are deterministic)."""
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g).to(cuda)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    cot = torch.randn(1, 128, 4, 64, generator=g).to(cuda).to(
        torch.bfloat16).expand(2, -1, -1, -1)
    assert cot.stride(0) == 0 and FA.kernel_ready(cot)
    grads = []
    for c in (cot, cot.contiguous()):
        o = FA.flash_attention(q, k, v, True, 0)
        grads.append(torch.autograd.grad(o, (q, k, v), c))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mha", "gqa", "window", "ragged"])
def test_rule_sees_an_e4m3_rounding_of_p_and_ds(cuda, case):
    """The tensor-core rule is not loose: the plain version with P (for
    o) and dS (for dQ and dK) rounded to float8_e4m3fn before the second
    product fails it on the card, where the same rounding to bf16
    passes."""
    q, k, v, do, kw = _train_inputs(TRAIN_CASES[case], torch.bfloat16, cuda)
    o, lse = FA.flash_fwd_reference(q, k, v, **kw)
    delta = FA.attention_delta(do, o)
    dq = FA.flash_dq_reference(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    terms = FA.tc_rounding_terms(q, k, v, do, lse, delta, **kw)
    for p_dtype, fails in ((torch.bfloat16, False),
                           (torch.float8_e4m3fn, True)):
        s_o, s_dq, s_dk, s_dv = FA.rounded_reference(q, k, v, do, lse, delta,
                                                     p_dtype, **kw)
        ratios = (_elementwise_ratio(s_o, o, True, terms["o"]),
                  _elementwise_ratio(s_dq, dq, False, terms["dq"]),
                  _elementwise_ratio(s_dk, dk, False, terms["dk"]))
        assert all((r > 1.0) == fails for r in ratios), (p_dtype, ratios)
        assert (_elementwise_ratio(s_dv, dv, False, terms["dv"]) > 1.0) \
            == fails


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kvh,window", [(4, 0), (2, 0), (4, 24)],
                         ids=["mha", "gqa", "window"])
def test_flash_attention_grads_match_plain_attention(cuda, dtype, tol, kvh,
                                                     window):
    """`flash_attention`'s output and input gradients on the card
    against torch autograd through the plain `attention`. The q, k, v
    given are strided slices of one fused tensor, as the model's are.
    bf16: both round o and the gradients once, at other points."""
    from shallowspeed_tpu_torch.ops.attention import attention

    g = torch.Generator(device="cpu").manual_seed(kvh + window)
    b, t, h, d = 2, 160, 4, 64
    fused = torch.randn(b, t, h + 2 * kvh, d, generator=g).to(cuda).to(dtype)
    cot = torch.randn(b, t, h, d, generator=g).to(cuda).to(dtype)
    outs = []
    for fn in (FA.flash_attention, attention):
        x = fused.clone().requires_grad_(True)
        q, k, v = x[:, :, :h], x[:, :, h:h + kvh], x[:, :, h + kvh:]
        o = fn(q, k, v, True, window)
        (gx,) = torch.autograd.grad(o, (x,), cot)
        outs.append((o, gx))
    (o, gx), (o_ref, gx_ref) = outs
    assert _rel_err(o, o_ref) <= tol
    assert _rel_err(gx, gx_ref) <= tol


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(cuda):
    """A shape the kernels refuse raises on the card; it does not fall
    back to the plain version."""
    q = torch.randn(1, 64, 2, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_fwd(q, q, q)
    pool = {"k": torch.zeros(4, 2, 8, 64, dtype=torch.int8, device=cuda),
            "k_s": torch.ones(4, 2, 8, device=cuda)}
    pool.update(v=pool["k"].clone(), v_s=pool["k_s"].clone())
    with pytest.raises(ValueError, match="k_s"):
        FA.paged_flash_decode(torch.zeros(2, 2, 64, device=cuda), pool,
                              torch.zeros(2, 1, dtype=torch.int32,
                                          device=cuda),
                              torch.zeros(2, dtype=torch.int32, device=cuda))


def _f64_ratio(got, x, y, out_dtype):
    """Worst |got - exact| / allowance per element, the exact product in
    f64 on the card: one rounding of the output (2^-8 |ref| for bf16, 0
    for f32) plus an f32 summation bound K 2^-24 (|x| @ |y|)."""
    xd, yd = x.double(), y.double()
    ref = xd @ yd
    allow = x.shape[1] * 2.0 ** -24 * (xd.abs() @ yd.abs())
    if out_dtype == torch.bfloat16:
        allow = allow + 2.0 ** -8 * ref.abs()
    assert torch.isfinite(got).all()
    return float(((got.double() - ref).abs() / allow).max())


# (M, K, N), blocks, input dtype, output dtype (None: the input's)
K5_CASES = {
    "f32": ((256, 128, 384), (64, 32, 128), torch.float32, None),
    "bf16": ((256, 128, 384), (128, 128, 384), torch.bfloat16, None),
    "bf16-f32-out": ((256, 128, 384), (64, 32, 128), torch.bfloat16,
                     torch.float32),
    "ragged-tile": ((200, 96, 136), (100, 32, 136), torch.bfloat16, None),
    "unaligned": ((64, 40, 70), (64, 40, 70), torch.float32,
                  torch.bfloat16),
    "unaligned-bf16": ((64, 44, 70), (64, 44, 70), torch.bfloat16, None),
    "rows-8": ((8, 2048, 6144), (8, 512, 1024), torch.bfloat16, None),
    "probe": ((16384, 1024, 4096), (512, 1024, 1024), torch.bfloat16, None),
    "probe-f32-out": ((16384, 2048, 8192), (512, 1024, 1024),
                      torch.bfloat16, torch.float32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K5_CASES))
def test_cuda_blocked_matmul_matches_plain_version(cuda, case):
    """K5 on the card and its plain version, each element within the
    f64 rule (`_f64_ratio`): the plain version passing shows the rule is
    fair to an f32 sum in another order. Shapes: the JAX test's, tiles
    with ragged edges, rows that are not 16-byte vectors, 8 rows, the
    probe's. Each call counts on the build `blocked_matmul_route` picks
    (bf16 at aligned shapes: the tensor-core `_blocked_matmul_tc`)."""
    from shallowspeed_tpu_torch.ops import matmul as M

    (m, k, n), (bm, bk, bn), dtype, out_dtype = K5_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(7)
    x = torch.randn(m, k, generator=g).to(cuda).to(dtype)
    y = torch.randn(k, n, generator=g).to(cuda).to(dtype)
    route = M.blocked_matmul_route(dtype, dtype, k, n)
    assert route == ("fma" if case in ("f32", "unaligned", "unaligned-bf16")
                     else "tc")
    counter = M._blocked_matmul_tc if route == "tc" else M.blocked_matmul
    before = counter.launches
    got = M.blocked_matmul(x, y, bm=bm, bk=bk, bn=bn, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert got.dtype == (out_dtype or dtype) and got.shape == (m, n)
    plain = M.blocked_matmul_reference(x, y, bm=bm, bk=bk, bn=bn,
                                       out_dtype=out_dtype)
    assert _f64_ratio(got, x, y, got.dtype) <= 1.0
    assert _f64_ratio(plain, x, y, got.dtype) <= 1.0


@pytest.mark.cuda
def test_cuda_blocked_matmul_rule_sees_a_bf16_accumulator(cuda):
    """The rule is tight: the plain arithmetic with the accumulator
    rounded to bf16 between k-slices fails it, and a non-dividing shape
    is refused on the card too."""
    from shallowspeed_tpu_torch.ops import matmul as M

    g = torch.Generator(device="cpu").manual_seed(8)
    x = torch.randn(256, 128, generator=g).to(cuda).bfloat16()
    y = torch.randn(128, 384, generator=g).to(cuda).bfloat16()
    acc = torch.zeros(256, 384, device=cuda)
    for k0 in range(0, 128, 32):
        acc = (acc + x[:, k0:k0 + 32].float() @ y[k0:k0 + 32].float()
               ).bfloat16().float()
    assert _f64_ratio(acc.bfloat16(), x, y, torch.bfloat16) > 1.0
    with pytest.raises(ValueError, match="must divide"):
        M.blocked_matmul(x, y, bm=96)


@pytest.mark.cuda
def test_cuda_spec_tick_streams_equal_spec_off(cuda):
    """The serving engine on the card with speculative drafts in the
    tick's free rows: K4 reads the rows that earlier draft rows of the
    same tick wrote, and the streams equal the spec-off streams token
    for token; K4 launches once per layer per tick."""
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.serving.engine import ServingEngine

    cfg = T.TransformerConfig(vocab=256, d_model=256, n_heads=2,
                              n_layers=2, max_seq=512, rope=True,
                              compute_dtype=torch.bfloat16)
    params = T.init(cfg, seed=1, device=cuda)
    rng = np.random.default_rng(6)
    prompts = [np.tile(rng.integers(0, 256, 16), n).astype(np.int32)
               for n in (5, 9)]

    def run(spec_k):
        eng = ServingEngine(params, cfg, n_blocks=128, block_size=16,
                            max_slots=8, prefill_chunk=64, spec_k=spec_k,
                            device=cuda)
        for i, p in enumerate(prompts):
            eng.submit(p, 40, rid=f"r{i}")
        before = FA.paged_flash_decode.launches
        out = eng.run()
        ticks = eng.counters["ticks"]
        assert FA.paged_flash_decode.launches - before == cfg.n_layers * ticks
        return out, eng

    off, _ = run(0)
    on, eng = run(4)
    assert eng.counters["spec_drafted"] > 0
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid], err_msg=rid)


# ------------------------------------------------ data and checkpoints


@pytest.mark.cuda
def test_cuda_prefetch_places_batches_in_order(cuda):
    """`place_on(cuda)` on the prefetcher's thread: int64 tensors on the
    card, in order, equal to the host batches, and read correctly by
    kernels the main thread launches on the default stream right after
    `next()` returns."""
    from shallowspeed_tpu_torch.data import DevicePrefetcher, place_on

    rng = np.random.default_rng(0)
    host = [(rng.integers(0, 32768, (4, 2048)).astype(np.int32),
             rng.integers(0, 32768, (4, 2048)).astype(np.int32))
            for _ in range(6)]
    with DevicePrefetcher(iter(host), place_on(cuda), depth=2) as pf:
        for (tok, tgt), (ht, hg) in zip(pf, host):
            assert tok.device.type == "cuda" and tok.dtype == torch.int64
            assert int(tok.sum()) == int(ht.astype(np.int64).sum())
            np.testing.assert_array_equal(tgt.cpu().numpy(), hg)


@pytest.mark.cuda
def test_cuda_resume_is_bit_identical_at_two_layers(cuda, tmp_path):
    """train_lm on the card (bf16, K1/K2/K3's tensor-core builds) from a
    token-shard corpus: a run saved after 2 steps and resumed with an
    async save prints, step for step, the losses of a straight 4-step
    run, bit for bit."""
    from shallowspeed_tpu_torch import train_lm
    from shallowspeed_tpu_torch.data import build_shards
    from shallowspeed_tpu_torch.parallel.context import (
        ContextParallelEngine)

    rng = np.random.default_rng(7)
    motifs = rng.integers(0, 512, (16, 16))
    build_shards(motifs[rng.integers(0, 16, 400)].reshape(-1), tmp_path / "d",
                 512, val_fraction=0.1)
    flags = ["--data-dir", str(tmp_path / "d"), "--seq-len", "256",
             "--batch-size", "2", "--d-model", "256", "--n-heads", "2",
             "--n-layers", "2", "--rope", "--norm", "rmsnorm", "--ffn",
             "swiglu", "--bf16", "--optimizer", "adamw", "--lr", "1e-3",
             "--grad-clip", "1.0", "--val-every", "2"]
    losses = []
    step = ContextParallelEngine.train_batch

    def recorded(self, tok, tgt):
        losses.append(step(self, tok, tgt))
        return losses[-1]

    ContextParallelEngine.train_batch = recorded
    try:
        train_lm.main([*flags, "--steps", "4"])
        straight = losses[:]
        losses.clear()
        ck = str(tmp_path / "ck")
        train_lm.main([*flags, "--steps", "2", "--save-dir", ck])
        train_lm.main([*flags, "--steps", "4", "--save-dir", ck,
                       "--resume", "--async-save"])
    finally:
        ContextParallelEngine.train_batch = step
    assert len(straight) == 4 and losses == straight
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_1", "ckpt_3"]


# ------------------------------------------------------------ the MLP path

MLP_SIZES = [784, 32, 31, 30, 29, 28, 27, 10]
MLP_LAYOUTS = [("fused", 1, 1, None), ("fused", 2, 1, None),
               ("vm", 1, 4, "PipeDreamSchedule"), ("vm", 2, 2, "GPipeSchedule"),
               ("spmd", 1, 2, None), ("spmd", 2, 4, None)]


@pytest.fixture(scope="module")
def mlp_data(tmp_path_factory):
    from shallowspeed_tpu_torch.data.mnist import prepare_mnist

    return prepare_mnist(tmp_path_factory.mktemp("mnist"), synthetic=True,
                         n_samples=1024)


def _mlp_train(layout, device, data_dir, n_batches=3):
    from shallowspeed_tpu_torch.data.dataset import Dataset
    from shallowspeed_tpu_torch.engine import FusedDPEngine
    from shallowspeed_tpu_torch.models.mlp import MLPStage
    from shallowspeed_tpu_torch.optim import SGD
    from shallowspeed_tpu_torch.parallel import schedules
    from shallowspeed_tpu_torch.parallel.mesh import make_mesh
    from shallowspeed_tpu_torch.parallel.spmd_pipeline import (
        SPMDPipelineEngine)
    from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor

    kind, dp, pp, sched = layout
    gbs, n_mu, mesh = 64, 4, make_mesh(dp, pp, device)
    ds = [Dataset(data_dir, gbs, gbs // dp // n_mu).load(r, dp)
          for r in range(dp)]
    if kind == "fused":
        eng = FusedDPEngine(MLPStage(MLP_SIZES, 0, 1, gbs), SGD(0.5), mesh)
    elif kind == "spmd":
        eng = SPMDPipelineEngine(MLP_SIZES, SGD(0.5), mesh, n_mu,
                                 gbs // dp // n_mu, gbs)
    else:
        eng = PipelineExecutor(mesh, [MLPStage(MLP_SIZES, s, pp, gbs)
                                      for s in range(pp)], SGD(0.5))
    for b in range(n_batches):
        if kind == "vm":
            eng.train_batch(getattr(schedules, sched), n_mu, b, ds)
        else:
            eng.train_batch(b, ds)
    return eng


@pytest.mark.cuda
@pytest.mark.parametrize("layout", MLP_LAYOUTS,
                         ids=["x".join(map(str, la[:3])) for la in MLP_LAYOUTS])
def test_cuda_mlp_engine_matches_cpu(cuda, mlp_data, layout):
    """Each MLP engine on the card against the same engine on the CPU
    after 3 batches, within the JAX package's cross-engine bound (rtol
    2e-4, atol 2e-6); every tensor on the card; replicas bit-identical."""
    from shallowspeed_tpu_torch.utils import (assert_replicas_in_sync,
                                              tree_leaves)

    got = _mlp_train(layout, cuda, mlp_data)
    ref = _mlp_train(layout, "cpu", mlp_data)
    for a, b in zip(got.get_canonical_params(), ref.get_canonical_params()):
        for k in ("W", "b"):
            np.testing.assert_allclose(np.asarray(torch.as_tensor(a[k]).cpu()),
                                       np.asarray(b[k]), rtol=2e-4, atol=2e-6)
    assert all(t.device.type == "cuda"
               for t in tree_leaves(got.replicas()))
    assert_replicas_in_sync(got.replicas())


@pytest.mark.cuda
def test_cuda_mlp_driver_default_device(cuda, mlp_data, tmp_path):
    """`train.main` with no --device runs on the card; a save and a
    resume reproduce the straight run's model hash."""
    from shallowspeed_tpu_torch import train

    base = ["--data-dir", str(mlp_data), "--batch-size", "64",
            "--max-batches", "4"]
    acc, eng = train.train(train.parse_args(base + ["--epochs", "2"]))
    assert eng.device.type == "cuda" and 0.0 <= acc <= 1.0
    train.main(base + ["--epochs", "1", "--save-dir", str(tmp_path)])
    _, resumed = train.train(train.parse_args(
        base + ["--epochs", "2", "--save-dir", str(tmp_path), "--resume"]))
    from shallowspeed_tpu_torch.utils import get_model_hash

    assert get_model_hash(resumed.params) == get_model_hash(eng.params)


# ------------------------------------- one-device training features (LM)

# a small bf16 LM the kernels take (head_dim 64), B 2 x T 128
FEATURE_LM = dict(vocab=256, d_model=128, n_heads=2, n_layers=2,
                  max_seq=128, rope=True, norm="rmsnorm", ffn="swiglu",
                  d_ff=256)


def _feature_grads(cuda, attn="flash", accum=1, **feature):
    """(loss, gradient tree, {K1, K2, K3 tensor-core launches, and
    "fma": their f32 builds'}) of one batch through a fresh engine, the
    launch counts zeroed just before."""
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import SGD
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    cfg = T.TransformerConfig(**FEATURE_LM, compute_dtype=torch.bfloat16,
                              **feature)
    eng = ContextParallelEngine(cfg, SGD(0.0), attn=attn, device=cuda,
                                accum=accum,
                                params=T.init_numpy(
                                    T.TransformerConfig(**FEATURE_LM), 0))
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 256, (4, 129))
    tc = (FA._flash_fwd_tc, FA._flash_dq_tc, FA._flash_dkv_tc)
    fma = (FA.flash_fwd, FA.flash_dq, FA.flash_dkv)
    for k in tc + fma:
        k.launches = 0
    loss, grads = eng.loss_and_grads(seq[:, :-1], seq[:, 1:])
    torch.cuda.synchronize()
    counts = {"k1": tc[0].launches, "k2": tc[1].launches,
              "k3": tc[2].launches, "fma": [k.launches for k in fma]}
    return float(loss), grads, counts


def _bf16_close(got, ref):
    """loss within 1e-3 relative, each gradient leaf within 5e-2 of its
    max (the bf16 bounds of tests/test_torch_train.py)."""
    from shallowspeed_tpu_torch.weights import leaves

    assert abs(got[0] - ref[0]) <= 1e-3 * abs(ref[0])
    for a, b in zip(leaves(got[1]), leaves(ref[1])):
        assert a.device.type == "cuda"
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 5e-2 * max(scale, 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_cuda_remat_launches_and_grads(cuda, policy):
    """Each remat policy on the card against no remat: K1 launches 2 x
    n_layers under "full" (the backward reruns it) and n_layers under
    "attn" and "dots" (its outputs are kept), K2 and K3 n_layers; the
    FMA builds never; gradients within the bf16 bounds."""
    nl = FEATURE_LM["n_layers"]
    ref = _feature_grads(cuda)
    assert ref[2] == {"k1": nl, "k2": nl, "k3": nl, "fma": [0, 0, 0]}
    got = _feature_grads(cuda, remat=True, remat_policy=policy)
    k1 = 2 * nl if policy == "full" else nl
    assert got[2] == {"k1": k1, "k2": nl, "k3": nl, "fma": [0, 0, 0]}
    _bf16_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("row", ["xent-128", "xent-100", "accum-2",
                                 "dropout-remat", "attn-dropout-remat"])
def test_cuda_feature_matches_its_counterpart(cuda, row):
    """Chunked cross-entropy (even, and with a remainder chunk) against
    unchunked; accum 2 against 1 (K1-K3 each launched 2 x n_layers);
    dropout under "full" remat against no remat at the same key (the
    masks repeat); attention dropout through the plain attention, which
    launches no kernel, under "full" remat against no remat."""
    nl = FEATURE_LM["n_layers"]
    if row.startswith("xent"):
        got = _feature_grads(cuda, xent_chunk=int(row.split("-")[1]))
        ref, want = _feature_grads(cuda), (nl, nl)
    elif row == "accum-2":
        got, ref, want = (_feature_grads(cuda, accum=2),
                          _feature_grads(cuda), (2 * nl, 2 * nl))
    elif row == "dropout-remat":
        got = _feature_grads(cuda, dropout=0.1, remat=True)
        ref, want = _feature_grads(cuda, dropout=0.1), (2 * nl, nl)
        assert ref[0] != _feature_grads(cuda)[0]
    else:
        got = _feature_grads(cuda, attn="ring", attn_dropout=0.1,
                             remat=True)
        ref, want = _feature_grads(cuda, attn="ring", attn_dropout=0.1), \
            (0, 0)
    assert got[2] == {"k1": want[0], "k2": want[1], "k3": want[1],
                      "fma": [0, 0, 0]}
    _bf16_close(got, ref)


@pytest.mark.cuda
def test_cuda_adafactor_step_matches_cpu(cuda):
    """Three Adafactor steps (factored and full leaves, beta1, decay,
    clipping) on the card against the CPU: parameters and slots within
    1e-5 of their max (f32, another summation order)."""
    from shallowspeed_tpu_torch.optim import Adafactor
    from shallowspeed_tpu_torch.weights import leaves

    rng = np.random.default_rng(0)
    tree = {"W": rng.normal(size=(64, 48)).astype(np.float32),
            "e": rng.normal(size=(3, 16, 8)).astype(np.float32),
            "b": rng.normal(size=(48,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in tree.items()} for _ in range(3)]
    out = []
    for dev in (cuda, torch.device("cpu")):
        opt = Adafactor(1e-2, beta1=0.9, weight_decay=0.1, grad_clip=1.0)
        p = {k: torch.from_numpy(v).to(dev) for k, v in tree.items()}
        state = opt.init(p)
        for g in grads:
            p, state = opt.step(
                p, {k: torch.from_numpy(v).to(dev) for k, v in g.items()},
                state)
        out.append((p, state["slots"]))
    for a, b in zip(leaves(out[0]), leaves(out[1])):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(
            b.abs().max())


@pytest.mark.cuda
def test_cuda_moe_engine_trains(cuda):
    """The one-device MoE engine on the card (plain attention, no kernel
    launch): losses fall over 3 steps on a repeated batch, the routing
    stats sum to 1, and its logits equal `T.forward`'s."""
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import AdamW
    from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine

    cfg = T.TransformerConfig(**FEATURE_LM, n_experts=4,
                              compute_dtype=torch.bfloat16)
    eng = ExpertParallelEngine(cfg, AdamW(1e-3), device=cuda)
    rng = np.random.default_rng(4)
    seq = rng.integers(0, 256, (4, 129))
    FA._flash_fwd_tc.launches = FA.flash_fwd.launches = 0
    losses = [eng.train_batch(seq[:, :-1], seq[:, 1:]) for _ in range(3)]
    assert FA._flash_fwd_tc.launches == FA.flash_fwd.launches == 0
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    stats = eng.router_stats(seq[:, :-1])
    assert sum(stats["expert_load"]) == pytest.approx(1.0, abs=1e-3)
    tok = torch.from_numpy(seq[:, :-1]).to(cuda)
    with torch.no_grad():
        ref = T.forward(eng.params, tok, cfg)
    assert torch.equal(eng.logits(seq[:, :-1]), ref)


_K123 = ("_flash_fwd_tc", "_flash_fwd_tc_f32o", "_flash_dq_tc",
         "_flash_dkv_tc", "flash_fwd", "flash_dq", "flash_dkv")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tp2", "fsdp-dp2"])
def test_cuda_gspmd_engine_matches_cpu(cuda, layout):
    """`TensorParallelEngine` at tp 2 and `FSDPEngine` at dp 2 on the card
    (every cell the card) at a small f32 width against the same engine
    on the CPU: 3 steps' losses within 1e-4 relative and the parameters
    within 1e-4 absolute (f32 sums in other orders); the plain attention,
    so no K1-K3 launch."""
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import MomentumSGD
    from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine
    from shallowspeed_tpu_torch.parallel.mesh import (make_fsdp_mesh,
                                                      make_tp_mesh)
    from shallowspeed_tpu_torch.parallel.tensor import TensorParallelEngine
    from shallowspeed_tpu_torch.weights import leaves

    cfg = T.TransformerConfig(**FEATURE_LM)

    def engine(dev):
        opt = MomentumSGD(0.05, grad_clip=1.0)
        if layout == "tp2":
            return TensorParallelEngine(cfg, opt, 1,
                                        mesh=make_tp_mesh(1, 2, dev))
        return FSDPEngine(cfg, opt, 1, mesh=make_fsdp_mesh(2, dev))

    rng = np.random.default_rng(5)
    seq = rng.integers(0, 256, (4, 129))
    for name in _K123:
        getattr(FA, name).launches = 0
    gpu, cpu = engine(cuda), engine("cpu")
    for _ in range(3):
        a = gpu.train_batch(seq[:, :-1], seq[:, 1:])
        b = cpu.train_batch(seq[:, :-1], seq[:, 1:])
        assert abs(a - b) <= 1e-4 * abs(b)
    assert all(getattr(FA, name).launches == 0 for name in _K123)
    for x, y in zip(leaves(gpu.params), leaves(cpu.params)):
        assert float((x.cpu() - y).abs().max()) <= 1e-4


# ------------------------------------------- fp8 training, the guard


def _fp8_inputs(m, k, n, dev, seed=0):
    from shallowspeed_tpu_torch.ops import matmul as MM

    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, k, generator=g) * 3).to(dev)
    w = (torch.randn(k, n, generator=g) * 0.05).to(dev)
    sx = torch.clamp(torch.amax(x.abs()) / MM.E4M3_MAX, min=1e-12)
    sw = MM._w_scale(w)
    return x, w, sx, sw


# the e4m3 GEMM's tensor-core build against its exact-f32 FMA build on
# the same inputs: ||tc - exact|| <= FP8_TC_VS_FMA ||fma - exact||
# (chip_smoke.py's rule: twice the largest ratio an H100 read, 4.07 at
# K 8192; a 14-bit accumulator must land past it)
FP8_TC_VS_FMA = 8.0


def _fp8_exact(xq, wq, scale):
    """The exact product (f64) and the f32 order bound K 2^-24
    sum|terms| per element."""
    xd, wd, sd = xq.double(), wq.double(), scale.double()
    bound = xq.shape[1] * 2.0 ** -24 * (xd.abs() @ wd.abs()) * sd
    return (xd @ wd) * sd, bound


def _rel(got, exact):
    return float((got.double() - exact).norm() / exact.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 2048, 2048), (256, 8192, 384),
                                   (100, 2048, 130), (100, 2048, 144),
                                   (128, 784, 128), (128, 127, 126),
                                   (128, 123, 10)])
def test_cuda_fp8_matmul_routes_and_bound(cuda, m, k, n):
    """The e4m3 GEMM on the build its route picks (one launch), within
    the f32 order bound K 2^-24 sum|terms| of the exact product, the
    tensor-core build within FP8_TC_VS_FMA of the FMA build's error,
    its quantized bytes the CPU's, a NaN input row a NaN output row."""
    from shallowspeed_tpu_torch.ops import matmul as MM

    x, w, sx, sw = _fp8_inputs(m, k, n, cuda, m + k)
    xq, wq = MM.fp8_quantize(x, sx), MM.fp8_quantize(w, sw)
    assert torch.equal(xq.view(torch.uint8).cpu(),
                       MM.fp8_quantize(x.cpu(), sx.cpu()).view(torch.uint8))
    route = MM.fp8_matmul_route(k, n)
    counter = {"tc": MM._fp8_matmul_tc, "fma": MM._fp8_matmul_fma}[route]
    before = counter.launches
    got = MM.fp8_matmul(xq, wq, sx * sw)
    assert counter.launches == before + 1
    exact, bound = _fp8_exact(xq, wq, sx * sw)
    assert bool(((got.double() - exact).abs() <= bound).all())
    if route == "tc":
        fma = MM._fp8_matmul_fma(xq, wq, sx * sw)
        assert _rel(got, exact) <= FP8_TC_VS_FMA * _rel(fma, exact)
    x[m // 2] = float("nan")
    out = MM.fp8_matmul(MM.fp8_quantize(x, sx), wq, sx * sw)
    assert torch.isnan(out[m // 2]).all() and torch.isfinite(out[0]).all()


@pytest.mark.cuda
def test_cuda_fp8_matmul_coarse_accumulator_fails_rule(cuda):
    """The FP8_TC_VS_FMA rule catches an accumulator coarser than f32:
    the product summed 32 values of K at a time into an f32 accumulator
    truncated to 14 significant bits (the 8-bit wgmma's) lands past it
    at a tensor-core shape."""
    from shallowspeed_tpu_torch.ops import matmul as MM

    x, w, sx, sw = _fp8_inputs(512, 2048, 384, cuda, 5)
    xq, wq, scale = MM.fp8_quantize(x, sx), MM.fp8_quantize(w, sw), sx * sw
    acc = torch.zeros(512, 384, device=cuda)
    for k0 in range(0, 2048, 32):
        part = xq[:, k0:k0 + 32].double() @ wq[k0:k0 + 32].double()
        acc = ((acc.double() + part).float().view(torch.int32)
               & ~((1 << 10) - 1)).view(torch.float32)
    exact, _ = _fp8_exact(xq, wq, scale)
    fma = MM._fp8_matmul_fma(xq, wq, scale)
    assert _rel(acc * scale, exact) > FP8_TC_VS_FMA * _rel(fma, exact)


@pytest.mark.cuda
def test_cuda_fp8_dense_grads_match_cpu(cuda):
    """fp8_dense's forward and straight-through gradients on the card
    against the CPU's on the same inputs: the same bytes; the card's
    forward is the tensor-core build, an f32 sum in another order
    (inside the f32 order bound), and the gradients inherit the
    difference through the cotangent 2y: 1e-3 of each tensor's largest
    entry."""
    from shallowspeed_tpu_torch.ops import matmul as MM

    x, w, sx, _ = _fp8_inputs(256, 2048, 384, cuda)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        tx = x.detach().to(dev).requires_grad_(True)
        tw = w.detach().to(dev).requires_grad_(True)
        y = MM.fp8_dense(tx, tw, sx.to(dev))
        y.square().sum().backward()
        out[dev.type] = [t.detach().cpu() for t in (y, tx.grad, tw.grad)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_fp8_engine_matches_cpu(cuda):
    """Fp8TrainEngine at the MLP's full width, 6 steps with shadow
    parity, on the card and on the CPU: losses within 1e-3 relative
    (an amax an ulp apart can move a delayed scale across an e4m3 tie);
    the first layer (784 -> 128) on the tensor-core build, the others
    (widths not multiples of 16) on the FMA build."""
    from shallowspeed_tpu_torch.fp8 import Fp8TrainEngine
    from shallowspeed_tpu_torch.ops import matmul as MM
    from shallowspeed_tpu_torch.optim import SGD

    sizes = [784, 128, 127, 126, 125, 124, 123, 10]
    rng = np.random.default_rng(0)
    batches = [(rng.random((128, 784)).astype(np.float32),
                np.eye(10, dtype=np.float32)[rng.integers(0, 10, 128)])
               for _ in range(6)]
    losses = {}
    for dev in (cuda, "cpu"):
        eng = Fp8TrainEngine(sizes, SGD(0.006), device=dev)
        losses[str(dev)] = [eng.train_batch(x, y) for x, y in batches]
        par = eng.shadow_parity(*batches[-1])
        assert np.isfinite(par["parity_loss_rel"])
    before = (MM._fp8_matmul_tc.launches, MM._fp8_matmul_fma.launches)
    Fp8TrainEngine(sizes, SGD(0.006), device=cuda).train_batch(*batches[0])
    assert (MM._fp8_matmul_tc.launches, MM._fp8_matmul_fma.launches) == (
        before[0] + 1, before[1] + len(sizes) - 2)
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-3)


@pytest.mark.cuda
def test_cuda_guard_skips_bit_for_bit(cuda):
    """health="guard" on the card: a NaN batch leaves the fused MLP
    engine's parameters and momentum bit for bit, and the pack counts
    the skip; the next batch trains."""
    from shallowspeed_tpu_torch.engine import FusedDPEngine
    from shallowspeed_tpu_torch.models.mlp import MLPStage
    from shallowspeed_tpu_torch.optim import MomentumSGD
    from shallowspeed_tpu_torch.parallel.mesh import make_mesh
    from shallowspeed_tpu_torch.weights import leaves

    sizes = [784, 128, 127, 126, 125, 124, 123, 10]
    eng = FusedDPEngine(MLPStage(sizes, 0, 1, batch_size=128),
                        MomentumSGD(0.006), make_mesh(1, 1, cuda),
                        health="guard")
    g = torch.Generator().manual_seed(1)
    xs = [torch.rand(4, 32, 784, generator=g).to(cuda)]
    ys = [torch.eye(10)[torch.randint(0, 10, (4, 32), generator=g)].to(cuda)]
    eng._step(xs, ys)

    def state():
        return [t.clone() for t in leaves((eng.params, eng.opt_state))]

    before = state()
    eng._step([xs[0] * float("nan")], ys)
    assert all(torch.equal(a, b) for a, b in zip(state(), before))
    snap = eng.health_snapshot()
    assert snap["skipped"] == 1 and snap["skipped_total"] == 1
    eng._step(xs, ys)
    assert not all(torch.equal(a, b) for a, b in zip(state(), before))


# ------------------------------------------- ring attention, (dp, sp) grid

RING_CHUNK_CASES = {"rel0": (0, 0, 4), "relT": (128, 0, 4),
                    "rel-T-window": (-128, 64, 4), "gqa": (0, 0, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RING_CHUNK_CASES))
def test_f32_output_build_matches_plain_version(cuda, case):
    """K1's bf16 build with the f32 epilogue (`_flash_fwd_tc_f32o`, ring
    attention's chunks) against its plain version with `out_dtype`
    float32, per element under the kernels' rule (no bf16 ulp: o is
    f32; the P term of `tc_rounding_terms`); a fully masked chunk gives
    o 0 and lse -1e30; the bf16 build's o is this o rounded once."""
    rel, window, kvh = RING_CHUNK_CASES[case]
    g = torch.Generator(device="cpu").manual_seed(rel + window + kvh)
    b, t, h, d = 2, 128, 4, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(cuda).to(torch.bfloat16)

    q, k, v = rnd(b, t, h, d), rnd(b, t, kvh, d), rnd(b, t, kvh, d)
    kw = dict(causal=True, window=window, rel=rel)
    before = (FA._flash_fwd_tc_f32o.launches, FA._flash_fwd_tc.launches)
    o, lse = FA.flash_fwd(q, k, v, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert (FA._flash_fwd_tc_f32o.launches, FA._flash_fwd_tc.launches) == \
        (before[0] + 1, before[1])
    o_ref, lse_ref = FA.flash_fwd_reference(q, k, v,
                                            out_dtype=torch.float32, **kw)
    if rel < 0:
        assert not o.any() and bool((lse == -1e30).all())
        assert not o_ref.any()
        return
    terms = FA.tc_rounding_terms(q, k, v, **kw)
    assert _elementwise_ratio(o, o_ref, False, terms["o"]) <= 1.0
    assert _rel_err(lse, lse_ref) <= 1e-5
    o16, _ = FA.flash_fwd(q, k, v, **kw)
    assert _elementwise_ratio(o16, o, True) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("rel", [0, 1024], ids=["rel0", "rel1024"])
def test_f32_output_build_at_the_ring_hop_shape(cuda, rel):
    """The f32-output K1 as a ring-flash hop inside a pipeline stage
    calls it (chip_smoke phase 12a's RING_HOP_CASES): a one-row sp tile
    at the 1.21B LM's width, q, k, v the strided views of the fused qkv,
    on and off the diagonal, under the same rule."""
    g = torch.Generator(device="cpu").manual_seed(23 + rel)
    qkv = torch.randn(1, 1024, 16, 3, 128, generator=g).to(cuda).to(
        torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    kw = dict(causal=True, window=0, rel=rel)
    before = FA._flash_fwd_tc_f32o.launches
    o, lse = FA.flash_fwd(q, k, v, out_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32
    assert FA._flash_fwd_tc_f32o.launches == before + 1
    o_ref, lse_ref = FA.flash_fwd_reference(q, k, v,
                                            out_dtype=torch.float32, **kw)
    terms = FA.tc_rounding_terms(q, k, v, **kw)
    assert _elementwise_ratio(o, o_ref, False, terms["o"]) <= 1.0
    assert _rel_err(lse, lse_ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("sp,window", [(2, 0), (4, 0), (4, 96)],
                         ids=["sp2", "sp4", "sp4-window"])
def test_ring_flash_attention_on_the_card(cuda, sp, window):
    """`ring_flash_attention` over sp cells of the card against
    `flash_attention` over the gathered sequence: o and the input
    gradients within the bf16 bound of
    `test_flash_attention_grads_match_plain_attention` (both round o and
    the gradients once, at other points), and K1 (f32 o), K2, K3
    launched sp (sp + 1) / 2 times each (sp^2 with a window)."""
    g = torch.Generator(device="cpu").manual_seed(sp + window)
    b, t, h, d = 2, 512, 4, 128
    q, k, v, do = (torch.randn(b, t, h, d, generator=g).to(cuda).to(
        torch.bfloat16) for _ in range(4))
    outs = []
    counters = (FA._flash_fwd_tc_f32o, FA._flash_dq_tc, FA._flash_dkv_tc)
    for fn in (FA.flash_attention,
               lambda a, b_, c, causal, w: FA.ring_flash_attention(
                   a, b_, c, [cuda] * sp, causal, w)):
        before = [c.launches for c in counters]
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs, True, window)
        grads = torch.autograd.grad(o, xs, do)
        torch.cuda.synchronize()
        outs.append((o.detach(), grads, [c.launches - n for c, n in
                                         zip(counters, before)]))
    (o_ref, g_ref, _), (o, grads, launched) = outs
    want = sp * (sp + 1) // 2 if window == 0 else sp * sp
    assert launched == [want] * 3
    assert _rel_err(o, o_ref) <= 2e-2
    for got, ref in zip(grads, g_ref):
        assert _rel_err(got, ref) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("attn,zero", [("ring-flash", "zero2"),
                                       ("ulysses-flash", "zero1"),
                                       ("ring", "")])
def test_context_engine_grid_on_the_card_matches_the_cpu(cuda, attn, zero):
    """The (2, 2) engine in f32 on the card (the FMA builds of K1-K3)
    against the same engine on the CPU (their plain versions), three
    steps with accum 2: losses 1e-4 relative and parameters 1e-4
    absolute (f32 sums in another order)."""
    from shallowspeed_tpu_torch import optim as O
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.parallel.context import (
        ContextParallelEngine)
    from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh

    cfg = T.TransformerConfig(vocab=128, d_model=256, n_heads=2,
                              n_kv_heads=2, n_layers=2, max_seq=256,
                              rope=True, norm="rmsnorm", ffn="swiglu")
    engines = [ContextParallelEngine(
        cfg, O.MomentumSGD(0.05, momentum=0.9, grad_clip=1.0), seed=4,
        attn=attn, mesh=make_context_mesh(2, 2, dev), accum=2,
        **({zero: True} if zero else {})) for dev in (cuda, "cpu")]
    rng = np.random.default_rng(8)
    fwd = FA.flash_fwd.launches
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (4, cfg.max_seq)).astype(np.int32)
        tgt = np.roll(tok, -1, axis=1)
        got, ref = (e.train_batch(tok, tgt) for e in engines)
        assert abs(got - ref) <= 1e-4 * abs(ref)
    if attn != "ring":
        assert FA.flash_fwd.launches > fwd
    for a, b in zip(*(
            [p.detach().float().cpu() for p in _leaves(e.params)]
            for e in engines)):
        assert float((a - b).abs().max()) <= 1e-4


def _leaves(tree):
    from shallowspeed_tpu_torch.weights import leaves

    return list(leaves(tree))


# --------------------------------------------------------- the LM pipeline


@pytest.mark.cuda
@pytest.mark.parametrize("layout,schedule,kw", [
    ((1, 2, 1), "gpipe", {}), ((2, 2, 1), "1f1b", {"zero2": True}),
    ((1, 4, 1), "zb", {}), ((1, 2, 2), "1f1b", {}),
    ((2, 2, 1), "gpipe", {"fsdp": True})],
    ids=["pp2-gpipe", "dp2-pp2-1f1b-zero2", "pp4-zb", "pp2-tp2-1f1b",
         "dp2-pp2-gpipe-fsdp"])
def test_pipeline_on_the_card_matches_the_cpu(cuda, layout, schedule, kw):
    """`PipelineLMEngine` in f32 on the card (the FMA builds of K1-K3,
    counted: n_layers x n_mu x dp x tp a step each, K1 twice under 1f1b)
    against the same engine on the CPU (their plain versions), three
    steps: losses 1e-4 relative and parameters 1e-4 absolute."""
    from shallowspeed_tpu_torch import optim as O
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    cfg = T.TransformerConfig(vocab=128, d_model=256, n_heads=2,
                              n_kv_heads=2, n_layers=4, max_seq=128,
                              rope=True, norm="rmsnorm", ffn="swiglu")
    dp, pp, tp = layout
    engines = [PipelineLMEngine(
        cfg, O.MomentumSGD(0.05, momentum=0.9, grad_clip=1.0),
        make_pipeline_mesh(dp, pp, tp, dev), n_mubatches=2, seed=4,
        schedule=schedule, attn="flash", **kw) for dev in (cuda, "cpu")]
    rng = np.random.default_rng(9)
    for name in _K123:
        getattr(FA, name).launches = 0
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (4, cfg.max_seq)).astype(np.int32)
        got, ref = (e.train_batch(tok, np.roll(tok, -1, axis=1))
                    for e in engines)
        assert abs(got - ref) <= 1e-4 * abs(ref)
    n = 3 * 4 * 2 * dp * tp
    assert (FA.flash_fwd.launches, FA.flash_dq.launches,
            FA.flash_dkv.launches) == (
        2 * n if schedule == "1f1b" else n, n, n)
    for a, b in zip(*(_leaves(e.get_canonical_params()) for e in engines)):
        assert float((a.float().cpu() - b).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zb"])
def test_pipeline_bf16_on_the_tensor_cores(cuda, schedule):
    """bf16 at pp 2 on the card: K1-K3 launch on their tensor-core
    builds as the schedule implies, the losses stay finite and fall, and
    the pipelined decode's greedy stream equals `generate`'s."""
    from shallowspeed_tpu_torch import optim as O
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.models.generate import generate
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    cfg = T.TransformerConfig(vocab=128, d_model=256, n_heads=2,
                              n_layers=2, max_seq=256, rope=True,
                              norm="rmsnorm", ffn="swiglu",
                              compute_dtype=torch.bfloat16)
    eng = PipelineLMEngine(cfg, O.AdamW(3e-3), make_pipeline_mesh(1, 2,
                                                                  devices=cuda),
                           n_mubatches=2, schedule=schedule, attn="flash")
    for name in _K123:
        getattr(FA, name).launches = 0
    rng = np.random.default_rng(3)
    tok = rng.integers(0, cfg.vocab, (4, cfg.max_seq)).astype(np.int32)
    losses = [eng.train_batch(tok, np.roll(tok, -1, axis=1))
              for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    n = 4 * 2 * 2
    assert (FA._flash_fwd_tc.launches, FA._flash_dq_tc.launches,
            FA._flash_dkv_tc.launches) == (
        2 * n if schedule == "1f1b" else n, n, n)
    assert FA.flash_fwd.launches == FA.flash_dq.launches == 0
    prompt = tok[:2, :9]
    assert np.array_equal(
        eng.generate(prompt, 12, temperature=0.0),
        generate(eng.get_canonical_params(), prompt, cfg, 12,
                 temperature=0.0))


# ----------------------------------------------------------- comm overlap


def _overlap_pair(kind, dev):
    """(overlap off, overlap on) engines of one kind on `dev`, at a small
    size, and a step function step(engine, i) -> loss."""
    from shallowspeed_tpu_torch import optim as O
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.parallel.overlap import OverlapConfig

    ov = OverlapConfig(bucket_mb=0.25, double_buffer_hops=kind != "spmd-1")
    rng = np.random.default_rng(6)
    if kind in ("fused", "spmd-1", "spmd-2"):
        from shallowspeed_tpu_torch.engine import FusedDPEngine
        from shallowspeed_tpu_torch.models.mlp import MLPStage
        from shallowspeed_tpu_torch.parallel.mesh import make_mesh
        from shallowspeed_tpu_torch.parallel.spmd_pipeline import (
            SPMDPipelineEngine)

        sizes, gbs, n_mu = [784, 128, 127, 126, 125, 124, 123, 10], 64, 4
        if kind == "fused":
            def build(o):
                return FusedDPEngine(MLPStage(sizes, 0, 1, batch_size=gbs),
                                     O.SGD(0.05), make_mesh(2, 1, dev),
                                     overlap=o)
        else:
            def build(o):
                return SPMDPipelineEngine(sizes, O.SGD(0.05),
                                          make_mesh(2, 2, dev), n_mu,
                                          gbs // 2 // n_mu, gbs, overlap=o)
        xs = rng.standard_normal((3, 2, n_mu, gbs // 2 // n_mu, 784),
                                 dtype=np.float32)
        ys = np.eye(10, dtype=np.float32)[
            rng.integers(0, 10, (3, 2, n_mu, gbs // 2 // n_mu))]

        def step(e, i):
            x = torch.from_numpy(xs[i]).to(dev)
            if kind != "fused":
                x = torch.nn.functional.pad(x, (0, e.wmax - 784))
            y = torch.from_numpy(ys[i]).to(dev)
            if kind == "fused":
                e._step(list(x), list(y))
            else:
                e._step(x, y)
            return 0.0
        return build(None), build(ov), step
    cfg = T.TransformerConfig(vocab=128, d_model=256, n_heads=2,
                              n_layers=2, max_seq=256, rope=True,
                              norm="rmsnorm", ffn="swiglu",
                              compute_dtype=torch.bfloat16)
    opt = O.AdamW(1e-3, weight_decay=0.01, grad_clip=1.0)
    if kind == "fsdp":
        from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine
        from shallowspeed_tpu_torch.parallel.mesh import make_fsdp_mesh

        def build(o):
            return FSDPEngine(cfg, opt, 4, mesh=make_fsdp_mesh(4, dev),
                              overlap=o)
    else:
        from shallowspeed_tpu_torch.parallel.context import (
            ContextParallelEngine)
        from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh

        dp, sp, attn, kw = {"context": (2, 1, "flash", {"accum": 2}),
                            "context-zero2": (2, 2, "ring-flash",
                                              {"zero2": True, "accum": 2})
                            }[kind]

        def build(o):
            return ContextParallelEngine(
                cfg, opt, seed=4, attn=attn,
                mesh=make_context_mesh(dp, sp, dev), overlap=o, **kw)
    toks = rng.integers(0, cfg.vocab, (3, 4, cfg.max_seq)).astype(np.int32)

    def step(e, i):
        return e.train_batch(toks[i], np.roll(toks[i], -1, axis=1))
    return build(None), build(ov), step


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["context", "context-zero2", "fsdp",
                                  "fused", "spmd-1", "spmd-2"])
def test_overlap_on_equals_off_on_the_card(cuda, kind):
    """Each overlapped engine on the card at a small size (bf16 LM: K1-K3
    on their tensor-core builds; the MLP in f32) against the same engine
    with overlap off, three steps: losses, parameters and optimizer
    state bit for bit, the same K1-K3 launches, and buckets issued on
    the side stream."""
    from shallowspeed_tpu_torch.parallel.overlap import BucketReducer

    off, on, step = _overlap_pair(kind, cuda)
    counts = []
    for e in (off, on):
        for name in _K123:
            getattr(FA, name).launches = 0
        before = BucketReducer.side_buckets
        losses = [step(e, i) for i in range(3)]
        torch.cuda.synchronize()
        counts.append((losses, BucketReducer.side_buckets - before, [
            getattr(FA, n).launches for n in (
                "_flash_fwd_tc", "_flash_fwd_tc_f32o", "_flash_dq_tc",
                "_flash_dkv_tc")]))
    (l_off, side_off, k_off), (l_on, side_on, k_on) = counts
    assert l_on == l_off and k_on == k_off
    assert side_off == 0 and side_on >= 3
    if kind.startswith("context"):
        assert all(np.isfinite(l_on)) and sum(k_on) > 0
    for a, b in zip(_leaves(off.params), _leaves(on.params)):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(off.opt_state), _leaves(on.opt_state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
