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
                                               blocked_matmul_reference)

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
