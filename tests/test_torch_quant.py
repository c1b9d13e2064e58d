"""The port's quantized decode — int8 KV caches, quantized weight storage
and the contiguous `generate()` — against the JAX package's, on the
CPU, on the same seeded numpy inputs.

The JAX side runs as its own tests run it: on the CPU, its Pallas
kernels (the paged decode kernel's int8 branch, the flash forward of a
long-prompt prefill) in interpret mode. Its serving engine is built with
`param_read_bytes` shimmed, as in `tests/test_torch_serving.py`: the
reference prices its parameter bytes through `analysis.walker`, which
fails to import on jax 0.9; the byte count feeds only log lines. For the
same reason the byte models here are held against an independent count,
never against the reference's walker-based helpers.

Tolerances (each test's docstring says which applies):
- quantizers, pool writes and gathers: equal, value for value;
- attention and decode kernels in f32: 1e-5 of max |ref| (the same
  arithmetic, summed in another order);
- logits of prefill and decode steps in f32: 1e-4 of max |ref| (the
  same, through two layers and a vocabulary projection);
- token streams: equal.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve as jax_serve
from shallowspeed_tpu.models import generate as JG
from shallowspeed_tpu.models import kv_cache as JK
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.ops.flash_attention import _pick_block as j_pick_block
from shallowspeed_tpu.ops.flash_attention import paged_flash_decode as j_paged
from shallowspeed_tpu.ops.matmul import dequant_matmul as j_dequant
from shallowspeed_tpu.serving import cache as JC
from shallowspeed_tpu.serving import engine as JE
from shallowspeed_tpu_torch import train_lm as tdriver
from shallowspeed_tpu_torch.models import generate as G
from shallowspeed_tpu_torch.models import kv_cache as K
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.ops.matmul import dequant_matmul
from shallowspeed_tpu_torch.serving import cache as C
from shallowspeed_tpu_torch.serving.engine import ServingEngine
from shallowspeed_tpu_torch.weights import leaves, params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
LOGITS_TOL = 1e-4

STREAM_CFG = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                  n_layers=2, max_seq=128, rope=True)
GEN_CFG = dict(vocab=96, d_model=32, n_heads=2, n_layers=2, max_seq=256,
               rope=True, norm="rmsnorm", ffn="swiglu", d_ff=48)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-6,
                                                float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    """A torch or jax array as numpy, float8 as its uint8 bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype == jnp.float8_e4m3fn else a


def _kv_values(seed, shape):
    """Normal values with a per-row spread of scales over four decades,
    and one all-zero row (the 1e-8 scale floor)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-2, 2, shape[:-1] + (1,))
    x = x.astype(np.float32)
    x.reshape(-1, shape[-1])[3] = 0.0
    return x


def toks(seed, t, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, t).astype(np.int32)


# --------------------------------------------------------- quantizers


def test_quantize_kv_matches_reference():
    """Equal int8 values and scales to the reference `quantize_kv` run
    as written (op by op). Inside a jitted program XLA turns the
    division by 127 into a multiplication by its reciprocal, so there a
    scale may sit one f32 ulp away; the int8 values then differ by at
    most one step, in at most 1 % of the elements (measured: none)."""
    x = _kv_values(0, (3, 2, 40, 16))
    q, s = K.quantize_kv(_t(x))
    jq, js = JK.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert float(s.min()) == pytest.approx(1e-8)     # the zero row
    jq, js = jax.jit(JK.quantize_kv)(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=2.0 ** -23,
                               atol=0)
    step = np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int))
    assert step.max() <= 1 and (step > 0).mean() <= 0.01


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_weights_matches_reference(mode):
    """Every dense becomes {"Wq", "Ws", "b"} with values (fp8 compared
    bit for bit) and scales equal to the reference's; embeddings, norms
    and biases untouched; quantizing twice changes nothing; the mode
    reads back; `cast_params` keeps Wq/Ws in their storage dtypes."""
    jcfg = JT.TransformerConfig(**STREAM_CFG)
    np_params = JT.init(jcfg, seed=4)
    ref = JT.quantize_weights(jax.tree_util.tree_map(jnp.asarray, np_params),
                              mode)
    got = T.quantize_weights(params_from_numpy(np_params, "cpu"), mode)
    ref_l, ref_tree = jax.tree_util.tree_flatten_with_path(ref)
    got_l = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [p for p, _ in got_l] == [p for p, _ in ref_l]
    for (path, g), (_, r) in zip(got_l, ref_l):
        assert str(g.dtype)[6:] == str(r.dtype), path
        np.testing.assert_array_equal(_np(g), _np(r), err_msg=str(path))
    assert T.weight_quant_mode(got) == JT.weight_quant_mode(ref) == mode
    again = T.quantize_weights(got, mode)
    assert all(a is b for a, b in zip(leaves(again), leaves(got)))
    cast = T.cast_params(got, torch.bfloat16)
    blk, cblk = got["blocks"][0], cast["blocks"][0]
    assert cblk["up"]["Wq"] is blk["up"]["Wq"]
    assert cblk["up"]["Ws"].dtype == torch.float32
    assert cblk["up"]["b"].dtype == torch.bfloat16
    assert cast["tok_emb"].dtype == torch.bfloat16
    assert T.weight_quant_mode(params_from_numpy(np_params, "cpu")) == ""


def test_init_kv_cache_and_pools_match_reference():
    """Shapes and dtypes of the contiguous cache and the block pools in
    both modes equal the reference's; an unknown mode is a ValueError."""
    jcfg = JT.TransformerConfig(**STREAM_CFG)
    cfg = T.TransformerConfig(**STREAM_CFG)
    for mode in ("", "int8"):
        for got, ref in ((K.init_kv_cache(cfg, 3, 40, mode),
                          JK.init_kv_cache(jcfg, 3, 40, mode)),
                         (C.init_block_pool(cfg, 7, 8, mode, device="cpu"),
                          JC.init_block_pool(jcfg, 7, 8, mode))):
            assert len(got) == len(ref) == cfg.n_layers
            for g, r in zip(got, ref):
                assert sorted(g) == sorted(r)
                for name in r:
                    assert tuple(g[name].shape) == r[name].shape
                    assert str(g[name].dtype)[6:] == str(r[name].dtype)
                    assert not g[name].any()
    with pytest.raises(ValueError, match="int4"):
        K.init_kv_cache(cfg, 1, 8, "int4")
    with pytest.raises(ValueError, match="int4"):
        C.init_block_pool(cfg, 4, 8, "int4", device="cpu")


def test_int8_write_rows_and_gather_table_match_reference():
    """int8 pools: `write_rows` quantizes per (row, head) and the
    gathered table carries the scale planes; every leaf equal to the
    reference's."""
    jcfg = JT.TransformerConfig(**STREAM_CFG)
    cfg = T.TransformerConfig(**STREAM_CFG)
    jpool = JC.init_block_pool(jcfg, 6, 4, "int8")[0]
    pool = C.init_block_pool(cfg, 6, 4, "int8", device="cpu")[0]
    rng = np.random.default_rng(3)
    for i in range(4):
        k, v = (_kv_values(10 * i + j, (3, cfg.kv_heads, cfg.head_dim))
                for j in range(2))
        blk = rng.integers(1, 6, 3).astype(np.int32)
        off = rng.permutation(4)[:3].astype(np.int32)
        jpool = {**jpool, **JC.write_rows(jpool, jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(blk),
                                          jnp.asarray(off), True)}
        C.write_rows(pool, _t(k), _t(v), _t(blk), _t(off))
    bt = np.asarray([[3, 1, 0], [5, 2, 4]], np.int32)
    want = JC.gather_table(jpool, jnp.asarray(bt))
    got = C.gather_table(pool, _t(bt))
    assert sorted(got) == ["k", "k_s", "v", "v_s"]
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


# ------------------------------------------------- attention, int8


def _int8_cache(seed, b, hkv, s, hd):
    k, v = _kv_values(seed, (b, hkv, s, hd)), _kv_values(seed + 1,
                                                         (b, hkv, s, hd))
    kq, ks = JK.quantize_kv(jnp.asarray(k))
    vq, vs = JK.quantize_kv(jnp.asarray(v))
    return {n: np.array(a) for n, a in
            (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs))}


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_masked_attention_int8_matches_reference(kvh):
    """`masked_attention` over an int8 cache (f32 compute) against the
    reference's on the same cache and mask: 1e-5 of max |ref|."""
    cfg = JT.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                               n_kv_heads=kvh, n_layers=1, max_seq=64)
    b, tq, s, hd = 2, 3, 24, 8
    cache = _int8_cache(kvh, b, kvh, s, hd)
    rng = np.random.default_rng(kvh)
    q = rng.normal(size=(b, tq, 4, hd)).astype(np.float32)
    pos = rng.integers(0, s, (b, tq))
    valid = (np.arange(s)[None, None, :] <= pos[..., None])
    valid = valid[:, None, None, :, :]
    ref = JK.masked_attention(jnp.asarray(q), {n: jnp.asarray(a) for n, a
                                               in cache.items()},
                              jnp.asarray(valid), cfg)
    got = K.masked_attention(_t(q), {n: _t(a) for n, a in cache.items()},
                             _t(valid))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= TOL


def test_cache_write_and_cached_attention_int8_match_reference():
    """A prefill-sized write then a one-token write into an int8
    contiguous cache (equal leaves), and the attention of the token over
    it (1e-5 of max |ref|)."""
    kw = dict(STREAM_CFG, attn_window=5)
    jcfg, cfg = JT.TransformerConfig(**kw), T.TransformerConfig(**kw)
    jc = JK.init_kv_cache(jcfg, 2, 16, "int8")[0]
    c = K.init_kv_cache(cfg, 2, 16, "int8")[0]
    shape = (2, 9, cfg.kv_heads, cfg.head_dim)
    for pos, t in ((0, 9), (9, 1)):
        k, v = (_kv_values(pos + j, shape[:1] + (t,) + shape[2:])
                for j in range(2))
        jc = JK.cache_write(jc, jnp.asarray(k), jnp.asarray(v), pos)
        K.cache_write(c, _t(k), _t(v), pos)
    for name in jc:
        np.testing.assert_array_equal(c[name].numpy(), np.asarray(jc[name]))
    q = np.random.default_rng(5).normal(size=(2, 1, 4, 8)).astype(np.float32)
    ref = JK.cached_attention(jnp.asarray(q), jc, 9, jcfg)
    got = K.cached_attention(_t(q), c, 9, cfg.attn_window)
    assert _rel(got.numpy(), ref) <= TOL


def _paged_int8_inputs(kvh, seed, n=16, bs=8, s=4, w=3, heads=4, hd=8):
    rng = np.random.default_rng(seed)
    hkv = kvh or heads
    pools = _int8_cache(seed, n, hkv, bs, hd)
    bt = rng.integers(1, n, (s, w)).astype(np.int32)
    pos = np.asarray([bs * w - 1, 13, 20, 0], np.int32)
    q = rng.normal(size=(s, heads, hd)).astype(np.float32)
    return q, pools, bt, pos


@pytest.mark.parametrize("kvh,window", [(0, 0), (2, 0), (0, 6)],
                         ids=["mha", "gqa", "window"])
def test_paged_decode_int8_matches_jax_kernel_and_gather_reference(kvh,
                                                                   window):
    """K4's int8 branch on the CPU (its plain version, which the CUDA
    kernel is held against on the card) against the JAX Pallas kernel's
    quant branch in interpret mode and against the JAX gather reference,
    on int8 pools: 1e-5 of max |ref|."""
    q, pools, bt, pos = _paged_int8_inputs(kvh, seed=kvh + window)
    got = FA.paged_flash_decode(_t(q), {n: _t(a) for n, a in pools.items()},
                                _t(bt), _t(pos), window=window).numpy()
    jpool = {n: jnp.asarray(a) for n, a in pools.items()}
    kern = np.asarray(j_paged(jnp.asarray(q), jpool, jnp.asarray(bt),
                              jnp.asarray(pos), window=window,
                              interpret=True))
    cfg = JT.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                               n_kv_heads=kvh, n_layers=1, max_seq=128)
    span = np.arange(bt.shape[1] * 8)
    valid = span[None, :] <= pos[:, None]
    if window > 0:
        valid &= span[None, :] > pos[:, None] - window
    ref = np.asarray(JK.masked_attention(
        jnp.asarray(q)[:, None], JC.gather_table(jpool, jnp.asarray(bt)),
        jnp.asarray(valid)[:, None, None, None, :], cfg))[:, 0]
    assert got.shape == q.shape and np.isfinite(got).all()
    assert _rel(got, kern) <= TOL
    assert _rel(got, ref) <= TOL


def test_paged_decode_int8_scratch_rows_are_finite_and_match():
    """Inactive slots (pos 0, table all scratch) over int8 pools come out
    finite and equal the JAX kernel's rows; int8 pools without their
    scale planes are refused before a launch."""
    q, pools, _, _ = _paged_int8_inputs(0, seed=9)
    for name in pools:
        pools[name][0] = 0
    bt = np.zeros((4, 2), np.int32)
    pos = np.zeros((4,), np.int32)
    got = FA.paged_flash_decode(
        _t(q), {n: _t(a) for n, a in pools.items()}, _t(bt), _t(pos))
    kern = np.asarray(j_paged(jnp.asarray(q), {n: jnp.asarray(a) for n, a
                                               in pools.items()},
                              jnp.asarray(bt), jnp.asarray(pos),
                              interpret=True))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), kern, atol=TOL)
    with pytest.raises(TypeError, match="int8 pools"):
        FA._check(_t(q), _t(pools["k"]), _t(pools["v"]), _t(bt), _t(pos), 0)


def _int8_kernel_args(hd=64, q_dtype=torch.float32, s_shape=None,
                      s_dtype=torch.float32):
    q = torch.zeros(4, 4, hd, dtype=q_dtype)
    k = torch.zeros(8, 4, 8, hd, dtype=torch.int8)
    ks = torch.ones(s_shape or (8, 4, 8, 1), dtype=s_dtype)
    return [q, k, k.clone(), torch.zeros(4, 3, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), 0, (ks, ks.clone())]


@pytest.mark.parametrize("mutate,err", [
    (lambda a: a, None),
    (lambda a: _int8_kernel_args(q_dtype=torch.bfloat16), None),
    (lambda a: _int8_kernel_args(s_shape=(8, 4, 8)), ValueError),
    (lambda a: _int8_kernel_args(s_dtype=torch.bfloat16), ValueError),
    (lambda a: _int8_kernel_args(q_dtype=torch.float16), TypeError),
    (lambda a: a[:1] + [a[1].float()] + a[2:], TypeError),
    (lambda a: a[:6] + [(a[6][0].to("meta"), a[6][1])], ValueError),
    (lambda a: a[:6] + [(a[6][0], a[6][1].transpose(0, 1).contiguous()
                         .transpose(0, 1))], ValueError),
], ids=["ok", "ok-bf16-q", "scale-shape", "scale-dtype", "float16-q",
        "float-pool", "scale-device", "scale-non-contiguous"])
def test_int8_kernel_argument_checks(mutate, err):
    """What the CUDA wrapper refuses before an int8 launch (checked on
    CPU tensors: the checks read only shapes, dtypes, devices and
    layout)."""
    args = mutate(_int8_kernel_args())
    if err is None:
        FA._check(*args)
    else:
        with pytest.raises(err):
            FA._check(*args)


# ------------------------------------------------- quantized weights


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("cdt", ["f32", "bf16"])
def test_dequant_matmul_and_dense_match_reference(mode, cdt):
    """`dequant_matmul` and `_dense` on a quantized dense against the
    reference's, on the same quantized leaves. f32: 1e-5 of max |ref|.
    bf16: both take the product of bf16 x and the weight's values summed
    in f32, scale it in f32 and round the result to bf16 once, so each
    element is within one bf16 rounding step (2^-8 |ref|) plus f32
    summation-order noise (1e-5 of max |ref|)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    w = (rng.normal(size=(48, 40)) / 7.0).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    jq = JT.quantize_weights({"W": jnp.asarray(w), "b": jnp.asarray(b)},
                             mode)
    tq = T.quantize_weights({"W": _t(w), "b": _t(b)}, mode)
    np.testing.assert_array_equal(_np(tq["Wq"]), _np(jq["Wq"]))
    jdt, tdt = ((jnp.float32, torch.float32) if cdt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx, tx = jnp.asarray(x).astype(jdt), _t(x).to(tdt)
    ref = np.asarray(j_dequant(jx, jq["Wq"], jq["Ws"]).astype(jnp.float32))
    got = dequant_matmul(tx, tq["Wq"], tq["Ws"])
    assert got.dtype == tdt
    got = got.float().numpy()
    if cdt == "f32":
        assert _rel(got, ref) <= TOL
    else:
        allow = 2.0 ** -8 * np.abs(ref) + TOL * np.abs(ref).max()
        assert (np.abs(got - ref) <= allow).all()
    jb = {**jq, "b": jq["b"].astype(jdt)}
    tb = {**tq, "b": tq["b"].to(tdt)}
    ref = np.asarray(JT._dense(jb, jx).astype(jnp.float32))
    got = T._dense(tb, tx).float().numpy()
    tol = TOL if cdt == "f32" else 2.0 ** -7
    assert _rel(got, ref) <= tol


# ---------------------------------------------------------- serving


def _jax_engine(monkeypatch, params, cfg, **kw):
    monkeypatch.setattr(JE, "param_read_bytes", lambda params, cfg: 0)
    return JE.ServingEngine(params, cfg, attn_impl="flash", **kw)


@pytest.mark.parametrize("quant", [{"kv_quant": "int8"},
                                   {"weight_quant": "int8"},
                                   {"weight_quant": "fp8"}],
                         ids=["kv-int8", "weight-int8", "weight-fp8"])
def test_quantized_greedy_streams_match_jax_engine(monkeypatch, quant):
    """With int8 pools, or int8 / fp8 weights, more requests than slots
    and a pool too small for all of them (evict-newest fires): every
    greedy stream equals the JAX engine's with the same flags, and the
    allocator balances at drain."""
    jcfg = JT.TransformerConfig(**STREAM_CFG)
    cfg = T.TransformerConfig(**STREAM_CFG)
    np_params = JT.init(jcfg, seed=6)
    reqs = {f"q{i}": (toks(80 + i, 18 + 4 * i), 12) for i in range(4)}
    kw = dict(n_blocks=12, block_size=8, max_slots=3, prefill_chunk=16,
              **quant)

    def drive(eng):
        for rid, (p, mn) in reqs.items():
            eng.submit(p, mn, rid=rid)
        return eng.run()

    jeng = _jax_engine(monkeypatch, jax.tree_util.tree_map(
        jnp.asarray, np_params), jcfg, **kw)
    want = drive(jeng)
    eng = ServingEngine(params_from_numpy(np_params, "cpu"), cfg,
                        attn_impl="flash", device="cpu", **kw)
    got = drive(eng)
    assert eng.counters["preempted"] >= 1
    assert (eng.kv_quant, eng.weight_quant) == (quant.get("kv_quant", ""),
                                                quant.get("weight_quant", ""))
    assert T.weight_quant_mode(eng.params) == quant.get("weight_quant", "")
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert eng.alloc.n_free == eng.alloc.n_usable and eng.alloc.n_live == 0


def test_serve_driver_quantized_matches_reference_engine(tmp_path,
                                                        monkeypatch):
    """`python -m shallowspeed_tpu_torch.serve --device cpu --kv-quant
    int8 --weight-quant int8` prints the result token lists of the
    reference engine built from the root `serve.py`'s flags, and a
    summary with a balanced allocator."""
    reqs = tmp_path / "reqs.jsonl"
    lines = [{"id": "a", "prompt_len": 20, "prompt_seed": 1, "max_new": 8},
             {"id": "b", "prompt_len": 45, "prompt_seed": 2, "max_new": 10},
             {"id": "c", "prompt": [3, 9, 27, 81, 5], "max_new": 9}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in lines))
    flags = ["--vocab", "128", "--d-model", "32", "--n-heads", "4",
             "--n-layers", "2", "--max-seq", "128", "--rope",
             "--n-blocks", "12", "--slots", "2", "--prefill-chunk", "16",
             "--init-seed", "3", "--kv-quant", "int8", "--weight-quant",
             "int8", "--prefix-cache", "off", "--requests", str(reqs)]
    r = subprocess.run([sys.executable, "-m", "shallowspeed_tpu_torch.serve",
                        "--device", "cpu", *flags], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = [json.loads(ln) for ln in r.stdout.splitlines() if ln.strip()]
    got = {o["id"]: o["tokens"] for o in out if o["event"] == "result"}
    assert out[-1]["event"] == "summary"
    assert out[-1]["blocks_free_at_drain"] == "11/11"

    args = jax_serve.parse_args(flags + ["--attn-impl", "flash"])
    jcfg = JT.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.max_seq, rope=args.rope)
    jeng = _jax_engine(
        monkeypatch, jax.device_put(JT.init(jcfg, seed=args.init_seed)),
        jcfg, n_blocks=args.n_blocks, block_size=args.block_size,
        max_slots=args.slots, prefill_chunk=args.prefill_chunk,
        table_bucket=args.table_bucket, kv_quant=args.kv_quant,
        weight_quant=args.weight_quant)
    for q in jax_serve.load_requests(args.requests, jcfg.vocab):
        jeng.submit(q["prompt"], q["max_new"], rid=q["id"])
    assert got == {k: v.tolist() for k, v in jeng.run().items()}


# --------------------------------------------------- contiguous decode


def test_prompt_bucket_and_prefill_regime_match_reference():
    """The 64-token bucket and the plain/flash prefill switch are the
    reference's for every length, threshold and budget tried."""
    for tp in (1, 5, 63, 64, 65, 100, 127, 128, 200, 1000, 2048):
        for max_new, max_seq in ((8, 4096), (64, 1100), (1, 300)):
            if tp + max_new > max_seq:
                continue
            b = G.prompt_bucket_len(tp, max_new, max_seq)
            assert b == JG.prompt_bucket_len(tp, max_new, max_seq)
            for at in (0, 128, 1024, 2048):
                want = ("flash" if at > 0 and b >= at
                        and j_pick_block(b, 512) >= 128 else "plain")
                assert G.prefill_attn_impl(b, at) == want, (b, at)
    assert G.FLASH_PREFILL_THRESHOLD == JG.FLASH_PREFILL_THRESHOLD


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("tp", [40, 100], ids=["plain", "flash"])
def test_prefill_and_decode_logits_match_reference(kv_quant, tp):
    """The port's `prefill` (right-padded to the bucket, the regime of
    `prefill_attn_impl` with the switch lowered to 128, so the longer
    prompt prefills through flash attention on both sides — the JAX
    kernel in interpret mode) and 6 teacher-forced `decode_step`s
    against the reference's on the same weights and tokens, f32:
    1e-4 of max |logit| per step."""
    jcfg, cfg = JT.TransformerConfig(**GEN_CFG), T.TransformerConfig(**GEN_CFG)
    np_params = JT.init(jcfg, seed=7)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    n_new = 6
    prompt = toks(tp, tp, vocab=96)[None]
    tp_b = G.prompt_bucket_len(tp, n_new, cfg.max_seq)
    impl = G.prefill_attn_impl(tp_b, 128)
    assert impl == ("flash" if tp > 64 else "plain")
    padded = np.zeros((1, tp_b), np.int32)
    padded[:, :tp] = prompt
    feed = toks(tp + 1, n_new, vocab=96)

    jcache = JK.init_kv_cache(jcfg, 1, tp_b + n_new, kv_quant)
    ref, jcache = JG.prefill(jparams, jnp.asarray(padded), jcfg, jcache,
                             last_idx=tp - 1,
                             attn_impl="flash" if impl == "flash" else "xla")
    refs = [np.asarray(ref)]
    cache = K.init_kv_cache(cfg, 1, tp_b + n_new, kv_quant)
    gots = [G.prefill(params, _t(padded).long(), cfg, cache, last_idx=tp - 1,
                      attn_impl=impl).numpy()]
    for i, tok in enumerate(feed):
        ref, jcache = JG.decode_step(jparams, jnp.asarray([tok]), tp + i,
                                     jcache, jcfg)
        refs.append(np.asarray(ref))
        gots.append(G.decode_step(params, torch.tensor([int(tok)]), tp + i,
                                  cache, cfg).numpy())
    for step, (g, r) in enumerate(zip(gots, refs)):
        assert _rel(g, r) <= LOGITS_TOL, step


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["float", "int8"])
def test_greedy_generate_streams_match_reference(kv_quant):
    """Greedy `generate` over a batch of two prompts, one each side of a
    lowered flash switch (128), equals the reference's streams."""
    jcfg, cfg = JT.TransformerConfig(**GEN_CFG), T.TransformerConfig(**GEN_CFG)
    np_params = JT.init(jcfg, seed=8)
    params = params_from_numpy(np_params, "cpu")
    for tp in (40, 100):
        prompt = np.stack([toks(tp + r, tp, vocab=96) for r in range(2)])
        want = np.asarray(JG.generate(
            jax.tree_util.tree_map(jnp.asarray, np_params),
            jnp.asarray(prompt), jcfg, 10, temperature=0.0,
            kv_quant=kv_quant, flash_prefill_at=128))
        got = G.generate(params, prompt, cfg, 10, temperature=0.0,
                         kv_quant=kv_quant, flash_prefill_at=128)
        assert got.dtype == np.int32 and got.shape == (2, 10)
        np.testing.assert_array_equal(got, want, err_msg=str(tp))


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["float", "int8"])
@pytest.mark.parametrize("temp", [0.0, 0.9], ids=["greedy", "sampled"])
def test_solo_paged_stream_equals_contiguous_generate(kv_quant, temp):
    """A request served alone by the port's engine (chunked paged
    prefill, paged decode) and the port's contiguous `generate` with the
    same seed draw the same tokens: both sample token i from the (seed,
    i) generator of `sample_rows`."""
    cfg = T.TransformerConfig(**STREAM_CFG)
    params = T.init(cfg, seed=9, device="cpu")
    prompt = toks(5, 37)
    eng = ServingEngine(params, cfg, n_blocks=32, block_size=8,
                        max_slots=2, prefill_chunk=16, kv_quant=kv_quant,
                        top_k=20, top_p=0.9, device="cpu")
    eng.submit(prompt, 16, temperature=temp, seed=21, rid="solo")
    paged = eng.run()["solo"]
    contig = G.generate(params, prompt[None], cfg, 16, temperature=temp,
                        top_k=20, top_p=0.9, seed=21, kv_quant=kv_quant)
    np.testing.assert_array_equal(paged, contig[0])


def test_generate_rejects_requests_past_max_seq():
    cfg = T.TransformerConfig(**STREAM_CFG)
    params = T.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        G.generate(params, np.zeros((1, 120), np.int32), cfg, 9)


# --------------------------------------------------------- byte models


def _bytes_by_hand(np_params, mode, compute_bytes):
    """Parameter bytes as decode reads them, counted leaf by leaf from
    the numpy draw: quantized matrices at 1 byte + 4-byte scales, norm
    leaves at their f32 master size, the rest at the compute size."""
    total = 0
    for path, a in jax.tree_util.tree_leaves_with_path(np_params):
        keys = [getattr(k, "key", None) for k in path]
        if any(k in ("ln1", "ln2", "ln_f") for k in keys):
            total += a.size * 4
        elif mode and keys[-1] == "W" and a.ndim == 2:
            total += a.size + a.shape[1] * 4
        else:
            total += a.size * compute_bytes
    return total


@pytest.mark.parametrize("kv_quant,weight_quant",
                         [("", ""), ("int8", ""), ("int8", "fp8")],
                         ids=["float", "kv-int8", "kv-int8-weight-fp8"])
def test_byte_models_match_an_independent_count(kv_quant, weight_quant):
    """The contiguous decode's read/write bytes per step and the paged
    tick's read bytes, against a count by hand (bf16 compute); the
    tick's model equals the reference's given the same parameter
    bytes, and the write model equals the reference's."""
    kw = dict(STREAM_CFG, compute_dtype=torch.bfloat16)
    cfg = T.TransformerConfig(**kw)
    jcfg = JT.TransformerConfig(**dict(STREAM_CFG,
                                       compute_dtype=jnp.bfloat16))
    np_params = JT.init(JT.TransformerConfig(**STREAM_CFG), seed=0)
    params = T.quantize_weights(params_from_numpy(np_params, "cpu"),
                                weight_quant)
    p_bytes = _bytes_by_hand(np_params, weight_quant, 2)
    per_pos = 2 * cfg.kv_heads * (cfg.head_dim + 4 if kv_quant
                                  else 2 * cfg.head_dim)
    b, cache_len = 3, 80
    assert G.decode_read_bytes_per_token(params, cfg, b, cache_len,
                                         kv_quant) == \
        p_bytes + cfg.n_layers * b * cache_len * per_pos + b * 4
    write = G.decode_write_bytes_per_token(cfg, b, kv_quant)
    assert write == cfg.n_layers * b * per_pos + b * cfg.vocab * 4
    assert write == JG.decode_write_bytes_per_token(jcfg, b, kv_quant)
    served = C.param_read_bytes(T.cast_params(params, cfg.compute_dtype))
    assert served == p_bytes
    tick = C.paged_read_bytes_per_tick(cfg, served, 9, 8, 4, kv_quant)
    assert tick == p_bytes + cfg.n_layers * 9 * 8 * per_pos + 4 * 4
    assert tick == JC.paged_read_bytes_per_tick(
        np_params, jcfg, 9, 8, 4, kv_quant, p_bytes=served)


def test_decode_report_fields_on_the_cpu():
    """tokens/s and bytes per step from the byte model; no bandwidth is
    known for the CPU, so no share of it is claimed."""
    cfg = T.TransformerConfig(**STREAM_CFG)
    params = T.init(cfg, device="cpu")
    rep = G.decode_report(params, cfg, 2, 64, 10, 0.5, kv_quant="int8")
    assert rep["tokens_per_sec"] == 40.0 and rep["steps_per_sec"] == 20.0
    assert rep["bytes_per_token"] == (
        G.decode_read_bytes_per_token(params, cfg, 2, 64, "int8")
        + G.decode_write_bytes_per_token(cfg, 2, "int8"))
    assert rep["hbm_util"] is None and rep["hbm_peak_gbps"] is None
    with pytest.raises(ValueError):
        G.decode_report(params, cfg, 2, 64, 0, 0.5)


# ---------------------------------------------------------- the driver


def test_train_lm_samples_after_training(tmp_path, capsys, monkeypatch):
    """`train_lm --device cpu --steps 2 --generate 8 --kv-int8` prints
    the decode, prompt and sample lines; the sample is the port's
    `generate` on the trained parameters (int8 cache, the driver's
    sampler and seed), and the log gets a "generate" event."""
    seen = {}
    orig = tdriver.sample_and_print

    def spy(args, engine, cfg, metrics=None, **data):
        out = orig(args, engine, cfg, metrics, **data)
        seen.update(params=engine.get_canonical_params(), cfg=cfg, out=out)
        return out

    monkeypatch.setattr(tdriver, "sample_and_print", spy)
    log = tmp_path / "m.jsonl"
    args = tdriver.parse_args([
        "--device", "cpu", "--steps", "2", "--seq-len", "64", "--d-model",
        "32", "--n-heads", "4", "--batch-size", "2", "--generate", "8",
        "--kv-int8", "--top-k", "40", "--seed", "3", "--log-file",
        str(log)])
    tdriver.train(args)
    out = capsys.readouterr().out.splitlines()
    dec = [ln for ln in out if ln.startswith("decode: ")]
    assert len(dec) == 1 and re.match(
        r"decode: [\d,]+ tok/s  ~[\d.]+ MiB/token sweep -> [\d.]+ GB/s "
        r"\[includes prefill\]$", dec[0]), dec
    prompt = tdriver.make_batch(args, seen["cfg"].vocab, 0)[0][:1, :16]
    assert f"prompt: {bytes(int(x) for x in prompt[0])!r}" in out
    want = G.generate(seen["params"], prompt, seen["cfg"], 8,
                      temperature=0.8, top_k=40, seed=3, kv_quant="int8")
    np.testing.assert_array_equal(seen["out"], want)
    assert f"sample: {bytes(int(x) for x in want[0])!r}" in out
    events = [json.loads(x) for x in log.read_text().splitlines()]
    gen = [e for e in events if e["event"] == "generate"]
    assert len(gen) == 1 and gen[0]["hbm_util"] is None


def test_train_lm_sampling_flags_are_validated():
    """--prompt and --sample-only imply --generate 128 (then too long for
    a 64-token sequence), an oversized --generate is refused at parse
    time, and --sample-only needs --save-dir (it samples a checkpoint)."""
    args = tdriver.parse_args(["--device", "cpu", "--prompt", "hi",
                               "--seq-len", "256"])
    assert args.generate == 128
    with pytest.raises(SystemExit, match="exceeds --seq-len"):
        tdriver.parse_args(["--device", "cpu", "--prompt", "hi",
                            "--seq-len", "64"])
    with pytest.raises(SystemExit, match="exceeds --seq-len"):
        tdriver.parse_args(["--device", "cpu", "--generate", "60",
                            "--seq-len", "64"])
    with pytest.raises(SystemExit, match="vocab"):
        tdriver.parse_args(["--device", "cpu", "--prompt", "hi",
                            "--vocab", "64"])
    with pytest.raises(SystemExit, match="require --save-dir"):
        tdriver.parse_args(["--device", "cpu", "--sample-only",
                            "--seq-len", "256"])
    args = tdriver.parse_args(["--device", "cpu", "--sample-only",
                               "--save-dir", "ck", "--seq-len", "256"])
    assert args.sample_only and args.generate == 128
    with pytest.raises(SystemExit, match="exceeds --seq-len"):
        tdriver.parse_args(["--device", "cpu", "--sample-only",
                            "--save-dir", "ck", "--seq-len", "64"])
