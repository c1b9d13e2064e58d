"""The port's blocked matmul (K5, `shallowspeed_tpu_torch.ops.matmul.
blocked_matmul`) and its probe (`shallowspeed_tpu_torch.bench_matmul`)
against the JAX package's, on the CPU.

On the CPU the wrapper computes its plain version (the CUDA kernel runs
on the card only: `tests/test_torch_cuda.py`, `chip_smoke.py`); the JAX
kernel runs in Pallas interpret mode, as its own test runs it
(`tests/test_functional.py::test_blocked_matmul_matches_xla`).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from shallowspeed_tpu.ops.matmul import blocked_matmul as jax_blocked
from shallowspeed_tpu_torch import bench_matmul
from shallowspeed_tpu_torch.ops.matmul import (blocked_matmul,
                                               blocked_matmul_reference,
                                               blocked_matmul_route,
                                               dequant_matmul_route,
                                               tc_splits, tc_warpgroups)

ROOT = Path(__file__).resolve().parent.parent


def _inputs(m=256, k=128, n=384, seed=0):
    """The JAX test's inputs: normals from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _bf16_ulp(v):
    """One bf16 ulp at each value of v (f32): 2^(exponent - 7)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("blocks", [(64, 32, 128), (128, 128, 384)],
                         ids=["64-32-128", "128-128-384"])
def test_plain_f32_matches_jax_kernel(blocks):
    """f32 at the JAX test's shapes and blocks: both sum the same f32
    products per k-slice, in another order inside a slice (rtol 1e-5,
    atol 1e-4, the JAX test's tolerance against x @ y)."""
    x, y = _inputs()
    bm, bk, bn = blocks
    want = np.asarray(jax_blocked(jnp.asarray(x), jnp.asarray(y), bm=bm,
                                  bk=bk, bn=bn, interpret=True))
    got = blocked_matmul(torch.from_numpy(x), torch.from_numpy(y), bm=bm,
                         bk=bk, bn=bn)
    assert got.dtype == torch.float32 and got.shape == (256, 384)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("blocks", [(64, 32, 128), (128, 128, 384)],
                         ids=["64-32-128", "128-128-384"])
def test_plain_bf16_within_one_ulp_of_jax_kernel(blocks):
    """bf16 in and out: the f32 sums agree to summation order and are
    rounded once each, so the outputs sit within one bf16 ulp."""
    x, y = _inputs()
    bm, bk, bn = blocks
    want = np.asarray(jax_blocked(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(y, jnp.bfloat16), bm=bm,
                                  bk=bk, bn=bn, interpret=True))
    assert want.dtype == ml_dtypes.bfloat16
    got = blocked_matmul(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(y).bfloat16(), bm=bm, bk=bk, bn=bn)
    assert got.dtype == torch.bfloat16
    want = want.astype(np.float32)
    diff = np.abs(got.float().numpy() - want)
    assert (diff <= _bf16_ulp(want)).all(), diff.max()


def test_plain_bf16_in_f32_out_matches_jax_kernel():
    """bf16 inputs with an f32 output: exact bf16 products summed in f32
    in both, never rounded to bf16."""
    x, y = _inputs(seed=1)
    xb, yb = (torch.from_numpy(a).bfloat16() for a in (x, y))
    want = np.asarray(jax_blocked(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(y, jnp.bfloat16), bm=64,
                                  bk=32, bn=128, out_dtype=jnp.float32,
                                  interpret=True))
    got = blocked_matmul(xb, yb, bm=64, bk=32, bn=128,
                         out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    exact = xb.double() @ yb.double()
    assert float((got.double() - exact).abs().max()) < 1e-3


def test_blocks_clip_to_the_dimensions():
    """Blocks larger than a dimension clip to it, as in the reference:
    the defaults (512, 512, 1024) on a (256, 128) @ (128, 384) product
    run one block and give the JAX kernel's result."""
    x, y = _inputs(seed=2)
    want = np.asarray(jax_blocked(jnp.asarray(x), jnp.asarray(y),
                                  interpret=True))
    got = blocked_matmul(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        got.numpy(), blocked_matmul(torch.from_numpy(x), torch.from_numpy(y),
                                    bm=256, bk=128, bn=384).numpy())


@pytest.mark.parametrize("shapes,blocks", [
    (((256, 128), (128, 384)), dict(bm=96)),
    (((256, 128), (128, 384)), dict(bk=48)),
    (((256, 128), (128, 384)), dict(bn=256)),
    (((100, 128), (128, 384)), dict(bm=64)),
    (((256, 100), (100, 384)), dict(bk=64)),
    (((256, 128), (96, 384)), {}),
], ids=["bm", "bk", "bn", "ragged-m", "ragged-k", "k-mismatch"])
def test_both_packages_refuse_the_same_shapes(shapes, blocks):
    """A shape the clipped blocks do not divide (or mismatched K) is
    refused by both: the reference asserts, the port raises a ValueError
    naming the shapes and blocks."""
    rng = np.random.default_rng(3)
    x, y = (rng.normal(size=s).astype(np.float32) for s in shapes)
    with pytest.raises(AssertionError):
        jax_blocked(jnp.asarray(x), jnp.asarray(y), interpret=True, **blocks)
    with pytest.raises(ValueError, match=r"\(\d+, ?\d+\)"):
        blocked_matmul(torch.from_numpy(x), torch.from_numpy(y), **blocks)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, y = (torch.from_numpy(a) for a in _inputs(seed=4))
    before = blocked_matmul.launches
    got = blocked_matmul(x, y, bm=64, bk=32, bn=128)
    assert torch.equal(got, blocked_matmul_reference(x, y, bm=64, bk=32,
                                                     bn=128))
    assert blocked_matmul.launches == before


def test_probe_prints_the_reference_records(capsys):
    """`bench_matmul.main(["--device", "cpu", "--m", "64", "--iters",
    "1"])` prints one record per (shape, variant), 12 in all, with the
    reference probe's keys, shapes and record order; "torch" stands
    where the reference's "xla" stands and "blocked" where its "pallas"
    does. The reference probe runs at the same flags for the
    comparison."""
    recs = bench_matmul.main(["--device", "cpu", "--m", "64", "--iters",
                              "1"])
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed == recs and len(recs) == 12
    r = subprocess.run([sys.executable, "scripts/bench_matmul.py", "--m",
                        "64", "--iters", "1"], capture_output=True, text=True,
                       cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    ref = [json.loads(l) for l in r.stdout.splitlines() if l.strip()]
    names = {"xla": "torch", "pallas": "blocked"}
    assert [(q["m"], q["k"], q["n"], names[q["variant"]]) for q in ref] == \
        [(q["m"], q["k"], q["n"], q["variant"]) for q in recs]
    for q, want in zip(recs, ref):
        assert set(want) <= set(q)
        assert q["metric"] == "matmul_tflops" and q["error"] is None
        assert q["device"] == "cpu" and q["ms"] > 0


@pytest.mark.parametrize("x_dtype,y_dtype,k,n,route", [
    (torch.bfloat16, torch.bfloat16, 1024, 4096, "tc"),
    (torch.bfloat16, torch.bfloat16, 128, 384, "tc"),
    (torch.bfloat16, torch.bfloat16, 100, 384, "fma"),   # K % 8
    (torch.bfloat16, torch.bfloat16, 128, 380, "fma"),   # N % 8
    (torch.float32, torch.float32, 1024, 4096, "fma"),   # f32 stays f32
    (torch.bfloat16, torch.float32, 128, 384, "fma"),
])
def test_blocked_matmul_route(x_dtype, y_dtype, k, n, route):
    """K5's build is chosen from dtypes and shape alone, before any
    launch: bf16 with TMA's 16-byte row strides goes to the tensor
    cores, everything else to the f32-FMA kernel."""
    assert blocked_matmul_route(x_dtype, y_dtype, k, n) == route


@pytest.mark.parametrize("x_dtype,k,n,route", [
    (torch.bfloat16, 2048, 6144, "tc"),
    (torch.bfloat16, 2048, 32768, "tc"),
    (torch.bfloat16, 48, 40, "fma"),        # N % 16
    (torch.bfloat16, 44, 48, "fma"),        # K % 8
    (torch.float32, 2048, 6144, "fma"),     # the f32 logits checks
])
def test_dequant_matmul_route(x_dtype, k, n, route):
    """`dequant_matmul` on the card: bf16 x at aligned shapes through
    the tensor-core GEMM with a 1-byte B, the rest through the f32-FMA
    kernel with a 1-byte y."""
    assert dequant_matmul_route(x_dtype, k, n) == route


@pytest.mark.parametrize("m,n,k", [(8, 6144, 2048), (8, 2048, 2048),
                                   (8, 2048, 8192), (8, 8192, 2048),
                                   (8, 32768, 2048), (300, 2048, 8192),
                                   (16384, 4096, 1024), (8, 64, 64)])
def test_tc_splits_fill_the_card_without_empty_splits(m, n, k):
    """The split of K: none where the output tiles give every SM a
    block; else at most two blocks an SM, at least 4 k tiles of 64 a
    split, and every split of the kernel's even share (ceil(tiles /
    splits)) non-empty."""
    sms = 132
    splits = tc_splits(m, n, k, sms)
    tiles = -(-n // 128) * -(-m // (64 * tc_warpgroups(m)))
    k_tiles = -(-k // 64)
    if tiles >= sms or k_tiles < 8:
        assert splits == 1
    else:
        assert splits > 1 and tiles * splits <= 2 * sms + tiles
        per = -(-k_tiles // splits)
        assert per >= 4 and (splits - 1) * per < k_tiles


def test_tc_warpgroups_follow_the_rows():
    """One warpgroup (64 rows) for the decode tick's 8 rows, two above
    64."""
    assert [tc_warpgroups(m) for m in (1, 8, 64, 65, 300)] == [1, 1, 1, 2, 2]


@pytest.mark.parametrize("mode", [torch.int8, torch.float8_e4m3fn])
def test_cpu_dequant_matmul_is_the_plain_version(mode):
    """On the CPU `dequant_matmul` is `dequant_matmul_reference` and
    launches nothing on either route."""
    from shallowspeed_tpu_torch.ops import matmul as M

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 8, 64)).astype(np.float32))
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 48)).astype(
        np.float32)).to(mode)
    ws = torch.from_numpy(rng.uniform(0.01, 0.1, 48).astype(np.float32))
    before = (M._dequant_matmul_tc.launches, M._dequant_matmul_fma.launches)
    for xx in (x, x.bfloat16()):
        got = M.dequant_matmul(xx, wq, ws)
        assert got.dtype == xx.dtype and got.shape == (3, 8, 48)
        assert torch.equal(got, M.dequant_matmul_reference(xx, wq, ws))
    assert (M._dequant_matmul_tc.launches,
            M._dequant_matmul_fma.launches) == before
