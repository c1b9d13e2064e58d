"""The port's fp8 training path against the JAX package's, on the CPU:
`ops.matmul`'s e4m3 quantize, clamp statistics, weight scale and
`fp8_dense` (forward and straight-through gradients), a 2-layer
`fp8_dense` transformer's loss and gradients, `fp8.Fp8TrainEngine`
(one step from equal state, the bf16 fallback, shadow parity, a short
trajectory), the routes of the card's e4m3 GEMM, and the fp8 driver
`train --engine fp8` against the root driver's `train_fp8`.

Tolerances. torch's `float8_e4m3fn` cast is the reference's bit for
bit, so on the same f32 inputs the quantized bytes are EQUAL. The
products then differ only in the f32 summation order: a forward output
is held within the f32 order bound K * 2^-24 * sum|terms|, and so are
the straight-through gradients (f32 products of the same e4m3 values).
Through several layers or steps the inputs of a quantize differ by
summation-order ulps, and an ulp can move a value (or a scale) across
an e4m3 rounding tie, changing one byte by one e4m3 step (2^-3
relative): the model- and trajectory-level checks are therefore
relative tolerances (stated per test), never bit equality.
"""

import json
import re
import signal
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import fp8 as JF
from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.ops import matmul as JM
from shallowspeed_tpu_torch import fp8 as PF
from shallowspeed_tpu_torch import optim as PO
from shallowspeed_tpu_torch import train as driver
from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import matmul as M
from shallowspeed_tpu_torch.weights import leaves, params_from_numpy

from torch_parity import flat

F32_ULP = 2.0 ** -24


def _values(seed=0, n=1 << 14):
    """f32 values over ~40 octaves with zeros, e4m3 subnormals, values
    past ±448 and NaN."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * np.exp2(rng.uniform(-18, 18, n)))
    v[:64] = 0.0
    v[64:128] = rng.uniform(-1, 1, 64) * 2.0 ** -9       # subnormals
    v[128:192] = rng.uniform(440, 2000, 64) * rng.choice([-1, 1], 64)
    v[192:200] = np.nan
    return v.astype(np.float32)


# --------------------------------------------------------- quantize


@pytest.mark.parametrize("scale", [1.0, 2.0 ** -7, 3.7e-3, 1e-12, 5.0])
def test_quantize_bytes_equal_the_reference(scale):
    x = _values()
    s = np.float32(scale)
    ref = np.asarray(JM.fp8_quantize(jnp.asarray(x), s)).view(np.uint8)
    got = M.fp8_quantize(torch.from_numpy(x), torch.tensor(s)).view(
        torch.uint8).numpy()
    np.testing.assert_array_equal(got, ref)
    # NaN stays NaN (0x7F or 0xFF), saturation at ±448 (0x7E / 0xFE)
    assert set(got[192:200].tolist()) <= {0x7F, 0xFF}


def test_quantize_bytes_equal_the_jitted_reference():
    x = _values(1)
    s = np.float32(2.0 ** -5)
    ref = np.asarray(jax.jit(JM.fp8_quantize)(jnp.asarray(x), s))
    got = M.fp8_quantize(torch.from_numpy(x), torch.tensor(s))
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  ref.view(np.uint8))


@pytest.mark.parametrize("scale", [1.0, 2.0 ** -7, 1e-3])
def test_clamp_stats_equal_the_reference(scale):
    x = _values(2)[200:]        # the stats of finite inputs
    s = np.float32(scale)
    ro, ru = JM.fp8_clamp_stats(jnp.asarray(x), s)
    go, gu = M.fp8_clamp_stats(torch.from_numpy(x), torch.tensor(s))
    # the same counts; XLA may turn the mean's division into a product
    # with 1/n, one f32 ulp from torch's quotient
    n, nz = x.size, int(np.sum(np.abs(x) / s > 0))
    assert round(float(go) * n) == round(float(ro) * n)
    assert round(float(gu) * nz) == round(float(ru) * nz)
    assert float(go) == pytest.approx(float(ro), rel=2.0 ** -22)
    assert float(gu) == pytest.approx(float(ru), rel=2.0 ** -22)


@pytest.mark.parametrize("shape", [(64, 48), (784, 128), (123, 10)])
def test_weight_scale_equals_the_reference(shape):
    w = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0                       # a zero column: the 1e-12 floor
    np.testing.assert_array_equal(
        M._w_scale(torch.from_numpy(w)).numpy(),
        np.asarray(JM._w_scale(jnp.asarray(w))))


# -------------------------------------------------------- fp8_dense


def _dense_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    sx = np.float32(np.abs(x).max() / 448.0)
    return x, w, sx


def _order_bound(xq, wq, scale):
    """K 2^-24 sum_k |xq w q| * scale, per output element (f64)."""
    terms = np.abs(xq.astype(np.float64)) @ np.abs(wq.astype(np.float64))
    return xq.shape[1] * F32_ULP * terms * np.abs(scale)


@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (128, 784, 128),
                                   (128, 127, 126), (7, 123, 10)])
def test_fp8_dense_forward_within_the_order_bound(m, k, n):
    x, w, sx = _dense_inputs(m, k, n, m + k)
    ref = np.asarray(JM.fp8_dense(jnp.asarray(x), jnp.asarray(w), sx))
    got = M.fp8_dense(torch.from_numpy(x), torch.from_numpy(w),
                      torch.tensor(sx)).numpy()
    xq = M.fp8_quantize(torch.from_numpy(x), torch.tensor(sx)).float()
    sw = M._w_scale(torch.from_numpy(w))
    wq = M.fp8_quantize(torch.from_numpy(w), sw).float()
    bound = _order_bound(xq.numpy(), wq.numpy(), (sx * sw).numpy())
    assert np.all(np.abs(got - ref) <= 2 * bound + 1e-30)
    plain = M.fp8_dense_reference(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.tensor(sx)).numpy()
    np.testing.assert_array_equal(plain, got)


@pytest.mark.parametrize("m,k,n", [(16, 64, 32), (128, 127, 126)])
def test_fp8_dense_straight_through_grads(m, k, n):
    x, w, sx = _dense_inputs(m, k, n, 7 * m + k)
    g = np.random.default_rng(9).standard_normal((m, n)).astype(np.float32)

    def jloss(x, w, s):
        return jnp.sum(JM.fp8_dense(x, w, s) * g)

    jdx, jdw, jds = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), sx)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    ts = torch.tensor(sx, requires_grad=True)
    (M.fp8_dense(tx, tw, ts) * torch.from_numpy(g)).sum().backward()
    assert float(jds) == 0.0
    assert ts.grad is None or float(ts.grad) == 0.0
    # each gradient is an f32 product of e4m3 values: the order bound
    sw = M._w_scale(torch.from_numpy(w)).numpy()
    xq = M.fp8_quantize(tx.detach(), ts.detach()).float().numpy()
    wq = M.fp8_quantize(tw.detach(), torch.from_numpy(sw)).float().numpy()
    gs = np.abs(g.astype(np.float64) * sw)
    dx_bound = n * F32_ULP * (gs @ np.abs(wq.T)) * sx
    dw_bound = m * F32_ULP * (np.abs(xq.T) @ np.abs(g)) * sx
    assert np.all(np.abs(tx.grad.numpy() - np.asarray(jdx))
                  <= 2 * dx_bound + 1e-30)
    assert np.all(np.abs(tw.grad.numpy() - np.asarray(jdw))
                  <= 2 * dw_bound + 1e-30)


@pytest.mark.parametrize("xs,ws,what", [((2, 3, 4), (4, 5), "2-D"),
                                        ((3, 4), (5, 6), "mismatch")])
def test_fp8_dense_typed_errors(xs, ws, what):
    with pytest.raises(ValueError, match=what):
        JM.fp8_dense(jnp.zeros(xs), jnp.zeros(ws), 1.0)
    with pytest.raises(ValueError, match=what):
        M.fp8_dense(torch.zeros(xs), torch.zeros(ws), torch.tensor(1.0))


@pytest.mark.parametrize("k,n,route", [(2048, 6144, "tc"), (8192, 2048, "tc"),
                                       (2048, 32768, "tc"), (784, 128, "tc"),
                                       (16, 16, "tc"), (2040, 128, "fma"),
                                       (128, 127, "fma"), (127, 126, "fma"),
                                       (123, 10, "fma"), (2048, 10, "fma")])
def test_fp8_matmul_route(k, n, route):
    """The tensor-core build takes K and N multiples of 16 (whole
    16-byte chunks of xq's and wq's rows); the rest go to the exact-f32
    FMA build."""
    assert M.fp8_matmul_route(k, n) == route


def test_fp8_matmul_plain_version_nan_rows():
    x, w, sx = _dense_inputs(8, 64, 16, 1)
    x[3] = np.nan
    xq = M.fp8_quantize(torch.from_numpy(x), torch.tensor(sx))
    wq = M.fp8_quantize(torch.from_numpy(w), torch.ones(16))
    out = M.fp8_matmul(xq, wq, torch.ones(16))
    assert torch.isnan(out[3]).all() and torch.isfinite(out[:3]).all()


# ---------------------------------------------- the fp8 transformer

MODEL = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, max_seq=32,
             fp8_dense=True)


@pytest.mark.parametrize("extra", [dict(rope=True, norm="rmsnorm",
                                        ffn="swiglu", n_kv_heads=2),
                                   dict()],
                         ids=["gqa-rope-swiglu", "gelu-learned-pos"])
def test_fp8_transformer_loss_and_grads_match_jax(extra):
    """A 2-layer fp8_dense transformer: loss within 1e-5 relative and
    every gradient leaf within 2e-3 of its largest entry (a quantize
    input a summation ulp apart can land one e4m3 step away)."""
    kw = dict(MODEL, **extra)
    params = JT.init(JT.TransformerConfig(**kw), seed=3)
    rng = np.random.default_rng(4)
    tok = rng.integers(0, 64, (2, 32)).astype(np.int32)
    tgt = rng.integers(0, 64, (2, 32)).astype(np.int32)
    jcfg = JT.TransformerConfig(**kw)
    jl, jg = jax.value_and_grad(
        lambda p: JT.loss(p, jnp.asarray(tok), jnp.asarray(tgt), jcfg))(
        jax.tree_util.tree_map(jnp.asarray, params))
    tp = params_from_numpy(params, "cpu")
    for p in leaves(tp):
        p.requires_grad_(True)
    cfg = T.TransformerConfig(**kw)
    tl = T.loss(tp, torch.from_numpy(tok), torch.from_numpy(tgt), cfg)
    grads = torch.autograd.grad(tl, list(leaves(tp)), allow_unused=True,
                                materialize_grads=True)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    # the tree's own key order, as leaves() walks it
    got = flat({"g": _unflatten_like(params, grads)})
    ref = flat({"g": jax.device_get(jg)})
    for key in ref:
        scale = max(np.abs(ref[key]).max(), 1e-30)
        assert np.abs(got[key] - ref[key]).max() <= 2e-3 * scale, key


def _unflatten_like(tree, flat_leaves):
    it = iter(flat_leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)

    return walk(tree)


def test_fp8_transformer_runs_the_fp8_products():
    """Every dense of a block and the untied head go through fp8_dense:
    a forward counts 5 per layer + 1 (qkv, proj, gate, up, down)."""
    kw = dict(MODEL, rope=True, norm="rmsnorm", ffn="swiglu")
    cfg = T.TransformerConfig(**kw)
    params = params_from_numpy(T.init_numpy(cfg, 0), "cpu")
    calls = []
    orig = M._Fp8Dense.forward

    def counted(ctx, *a):
        calls.append(a[1].shape)
        return orig(ctx, *a)

    M._Fp8Dense.forward = staticmethod(counted)
    try:
        T.loss(params, torch.zeros(1, 8, dtype=torch.long),
               torch.zeros(1, 8, dtype=torch.long), cfg)
    finally:
        M._Fp8Dense.forward = staticmethod(orig)
    assert len(calls) == 5 * cfg.n_layers + 1


# ------------------------------------------------- Fp8TrainEngine

SIZES = [48, 32, 31, 10]


def _mlp_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((16, SIZES[0])).astype(np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)])
            for _ in range(n)]


def _engines(opt="sgd", precision="fp8"):
    kw = {"sgd": dict(lr=0.05), "momentum": dict(lr=0.05),
          "adamw": dict(lr=1e-3)}[opt]
    je = JF.Fp8TrainEngine(SIZES, JO.OPTIMIZERS[opt](**kw),
                           precision=precision)
    pe = PF.Fp8TrainEngine(SIZES, PO.OPTIMIZERS[opt](**kw),
                           precision=precision, device="cpu")
    return je, pe


def test_init_is_the_reference_draw():
    ref = JF.init_fp8_mlp(SIZES, seed=4)
    got = PF.init_fp8_mlp(SIZES, seed=4)
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("precision", ["fp8", "bf16"])
@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_one_step_from_equal_state(opt, precision):
    """One step of each precision from the same state: the loss within
    1e-6, params within 1e-6 of their largest entry, the amax history
    and every pack key (fp8_amax / fp8_scale / fp8_overflow /
    fp8_underflow, norms, update ratio) equal or within 1e-5."""
    je, pe = _engines(opt, precision)
    x, y = _mlp_batches(1)[0]
    jl, pl = je.train_batch(x, y), pe.train_batch(x, y)
    assert abs(jl - pl) <= 1e-6 * abs(jl)
    jp = flat(jax.device_get(je.params))
    pp = flat(pe.params)
    for key in jp:
        assert np.abs(jp[key] - pp[key]).max() \
            <= 1e-6 * max(np.abs(jp[key]).max(), 1e-30), key
    np.testing.assert_allclose(pe.amax_hist.numpy(),
                               np.asarray(je.amax_hist), rtol=1e-6)
    js, ps = je.health_snapshot(), pe.health_snapshot()
    assert sorted(js) == sorted(ps)
    for key in ("fp8_amax", "fp8_scale", "fp8_overflow", "fp8_underflow"):
        np.testing.assert_allclose(ps[key], js[key], rtol=1e-6)
    for key in ("grad_norm", "param_norm", "update_ratio"):
        assert ps[key] == pytest.approx(js[key], rel=1e-5)
    assert ps["nonfinite"] == js["nonfinite"] == 0
    assert ps["groups"].keys() == js["groups"].keys()


def test_trajectory_and_shadow_parity():
    """Eight steps with shadow parity at step 4: losses within 1e-3
    relative (an amax a summation ulp apart can move a delayed scale
    across an e4m3 tie, one byte one step), the parity loss rel-err
    within 1e-3 absolute of the reference's, a fallback midway keeps
    both engines together."""
    je, pe = _engines("sgd")
    for step, (x, y) in enumerate(_mlp_batches(8, seed=2)):
        if step == 5:
            je.fallback_bf16()
            pe.fallback_bf16()
        jl, pl = je.train_batch(x, y), pe.train_batch(x, y)
        assert abs(jl - pl) <= 1e-3 * abs(jl), step
        if step == 4:
            jp, pp = je.shadow_parity(x, y), pe.shadow_parity(x, y)
            assert pp.keys() == jp.keys()
            assert abs(pp["parity_loss_rel"] - jp["parity_loss_rel"]) \
                <= 1e-3
    assert pe.precision == je.precision == "bf16"
    assert pe.eval_loss(x, y) == pytest.approx(je.eval_loss(x, y),
                                               rel=1e-3)
    ps = pe.health_snapshot()
    assert ps["fp8_overflow"] == [0.0] * 3   # the fallback quantizes nothing


def test_amax_history_rolls():
    _, pe = _engines()
    x, y = _mlp_batches(1)[0]
    marker = float(pe.amax_hist[0, 0])
    pe.train_batch(x, y)
    assert float(pe.amax_hist[0, 0]) == pytest.approx(
        float(np.abs(x).max()), rel=1e-6)
    assert float(pe.amax_hist[0, 1]) == marker


def test_fp8_typed_errors():
    with pytest.raises(ValueError, match="unsupported precision"):
        PF.Fp8TrainEngine(SIZES, PO.SGD(0.01), precision="int4",
                          device="cpu")
    with pytest.raises(ValueError, match="positive dims"):
        PF.Fp8TrainEngine([12], PO.SGD(0.01), device="cpu")
    with pytest.raises(ValueError, match="positive dims"):
        PF.Fp8TrainEngine([12, 0, 10], PO.SGD(0.01), device="cpu")


# ------------------------------------------------------- the driver

FP8_ARGV = ["--engine", "fp8", "--epochs", "1", "--max-batches", "14",
            "--shadow-every", "4", "--log-every", "4", "--health", "guard"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_fp8")
    prepare_mnist(d, synthetic=True, n_samples=4096)
    return d


def _lines(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture
def root_fp8(monkeypatch):
    """The root driver's `train_fp8`, imported with its walker-importing
    overlap module stood in for (`tests/test_torch_mlp_driver.py`), and
    the SIGTERM handler it installs put back afterwards."""
    monkeypatch.setitem(sys.modules, "shallowspeed_tpu.parallel.overlap",
                        types.SimpleNamespace(from_flags=lambda m, b: None))
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent))
    sys.modules.pop("train", None)
    import train as root

    handler = signal.getsignal(signal.SIGTERM)
    try:
        yield lambda argv: root.train_fp8(root.parse_args(argv))
    finally:
        signal.signal(signal.SIGTERM, handler)
        sys.modules.pop("train", None)


def test_fp8_driver_matches_the_root_driver(data_dir, tmp_path, capsys,
                                            root_fp8):
    """The port's `train --engine fp8` (14 steps, shadow every 4, log
    every 4, --health guard) against the root driver's `train_fp8` on
    the same data: the same step lines with the same keys, losses within 1e-3
    relative and parity within 1e-3 absolute, precision fp8, 3 shadow samples, the
    final validation loss within 1e-4 relative."""
    rlog, plog = tmp_path / "root.jsonl", tmp_path / "port.jsonl"
    ref = root_fp8(FP8_ARGV + ["--data-dir", str(data_dir), "--log-file",
                               str(rlog)])
    got, eng = driver.train(driver.parse_args(
        FP8_ARGV + ["--data-dir", str(data_dir), "--log-file", str(plog),
                    "--device", "cpu"]))
    assert got == pytest.approx(ref, rel=1e-4)
    assert eng.precision == "fp8"
    rs = [e for e in _lines(rlog) if e["event"] == "step"]
    ps = [e for e in _lines(plog) if e["event"] == "step"]
    assert [e["step"] for e in ps] == [e["step"] for e in rs] \
        == [3, 7, 11, 13]
    for r, p in zip(rs, ps):
        assert set(p) == set(r)
        assert p["loss"] == pytest.approx(r["loss"], rel=1e-3)
        assert p["num_precision"] == r["num_precision"] == "fp8"
        if "num_parity_loss_rel" in r:
            # a rel-err of two losses 1e-3..1e-2 apart: the losses'
            # own agreement bounds it absolutely, not relatively
            assert abs(p["num_parity_loss_rel"]
                       - r["num_parity_loss_rel"]) <= 1e-3
    assert ps[-1]["num_shadow_total"] == rs[-1]["num_shadow_total"] == 3
    out = capsys.readouterr().out
    assert re.findall(r"shadow samples (\d+)", out) == ["3", "3"]


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--pp", "2"],
                                  ["--save-dir", "x"], ["--overlap", "on"]])
def test_fp8_driver_refuses_layouts(data_dir, flag):
    with pytest.raises(SystemExit, match=re.escape(flag[0])):
        driver.main(["--engine", "fp8", "--device", "cpu", "--data-dir",
                     str(data_dir), *flag])
