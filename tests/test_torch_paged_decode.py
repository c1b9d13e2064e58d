"""The port's paged flash decode (`shallowspeed_tpu_torch.ops.
flash_attention`) against the JAX package's.

On the CPU the port's wrapper computes its plain torch version, which
is what the CUDA kernel is held against on the card (`chip_smoke.py`
and `tests/test_torch_cuda.py`). Here that plain version is held
against the JAX Pallas kernel in interpret mode and against the JAX
gather reference (`gather_table` + `masked_attention`), on the same
numpy inputs. Tolerance: 1e-5 of max |ref| in f32 — the functions are
the same, only the order of the f32 sums differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.models.kv_cache import masked_attention as j_masked
from shallowspeed_tpu.ops.flash_attention import paged_flash_decode as j_paged
from shallowspeed_tpu.serving.cache import gather_table as j_gather
from shallowspeed_tpu_torch.ops import flash_attention as FA

TOL = 1e-5


def _inputs(kvh, seed, n=16, bs=8, s=4, w=3, heads=4, hd=8):
    """Pools full of random values (masked positions hold garbage the
    mask must ignore), tables of random non-scratch blocks, positions
    covering a full table, partial ones and a row at position 0."""
    rng = np.random.default_rng(seed)
    hkv = kvh or heads
    k = rng.normal(size=(n, hkv, bs, hd)).astype(np.float32)
    v = rng.normal(size=(n, hkv, bs, hd)).astype(np.float32)
    bt = rng.integers(1, n, (s, w)).astype(np.int32)
    pos = np.asarray([bs * w - 1, 13, 20, 0], np.int32)
    q = rng.normal(size=(s, heads, hd)).astype(np.float32)
    return q, k, v, bt, pos


def _port(q, k, v, bt, pos, window):
    out = FA.paged_flash_decode(
        torch.from_numpy(q), {"k": torch.from_numpy(k),
                              "v": torch.from_numpy(v)},
        torch.from_numpy(bt), torch.from_numpy(pos), window=window)
    return out.numpy()


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / max(1e-6,
                                                float(np.abs(ref).max()))


@pytest.mark.parametrize("kvh,window", [(0, 0), (2, 0), (0, 6)],
                         ids=["mha", "gqa", "window"])
def test_paged_decode_matches_jax_kernel_and_gather_reference(kvh, window):
    q, k, v, bt, pos = _inputs(kvh, seed=kvh + window)
    got = _port(q, k, v, bt, pos, window)
    pool = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    kern = np.asarray(j_paged(jnp.asarray(q), pool, jnp.asarray(bt),
                              jnp.asarray(pos), window=window,
                              interpret=True))
    cfg = JT.TransformerConfig(vocab=64, d_model=32, n_heads=4,
                               n_kv_heads=kvh, n_layers=1, max_seq=128,
                               attn_window=window)
    w, bs = bt.shape[1], k.shape[2]
    span = np.arange(w * bs)
    valid = span[None, :] <= pos[:, None]
    if window > 0:
        valid &= span[None, :] > pos[:, None] - window
    ref = np.asarray(j_masked(jnp.asarray(q)[:, None],
                              j_gather(pool, jnp.asarray(bt)),
                              jnp.asarray(valid)[:, None, None, None, :],
                              cfg))[:, 0]
    assert got.shape == q.shape
    assert _rel(got, kern) <= TOL
    assert _rel(got, ref) <= TOL


# The split kernel's edges on the card (tests/test_torch_cuda.py holds
# the CUDA kernel against the plain version there): the plain version
# against the JAX kernel and the gather reference at the same edges.
# (heads, kv heads, bs, W, positions, window)
EDGES = {
    "g8": (16, 2, 8, 3, [23, 13, 20, 0], 0),
    "bs32": (4, 4, 32, 3, [95, 40, 64, 0], 0),
    "window-in-block": (4, 4, 8, 6, [45, 30, 47, 0], 13),
    "w1": (4, 4, 8, 1, [7, 3, 0, 5], 0),
    "ragged-rows": (4, 2, 8, 8, [63, 0, 5, 33], 0),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_paged_decode_edges_match_jax_kernel_and_gather_reference(edge):
    heads, kvh, bs, w, pos, window = EDGES[edge]
    rng = np.random.default_rng(len(edge))
    n, hd = 20, 8
    k = rng.normal(size=(n, kvh, bs, hd)).astype(np.float32)
    v = rng.normal(size=(n, kvh, bs, hd)).astype(np.float32)
    bt = rng.integers(1, n, (len(pos), w)).astype(np.int32)
    pos = np.asarray(pos, np.int32)
    q = rng.normal(size=(len(pos), heads, hd)).astype(np.float32)
    got = _port(q, k, v, bt, pos, window)
    pool = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    kern = np.asarray(j_paged(jnp.asarray(q), pool, jnp.asarray(bt),
                              jnp.asarray(pos), window=window,
                              interpret=True))
    cfg = JT.TransformerConfig(vocab=64, d_model=heads * hd, n_heads=heads,
                               n_kv_heads=kvh, n_layers=1, max_seq=128,
                               attn_window=window)
    span = np.arange(w * bs)
    valid = span[None, :] <= pos[:, None]
    if window > 0:
        valid &= span[None, :] > pos[:, None] - window
    ref = np.asarray(j_masked(jnp.asarray(q)[:, None],
                              j_gather(pool, jnp.asarray(bt)),
                              jnp.asarray(valid)[:, None, None, None, :],
                              cfg))[:, 0]
    assert got.shape == q.shape
    assert _rel(got, kern) <= TOL
    assert _rel(got, ref) <= TOL


# (slots, kv heads, W): the serving tick's shape first, then GQA,
# single-slot, narrow-table and wide shapes
SPLIT_SHAPES = [(8, 16, 128), (8, 2, 64), (1, 1, 2048), (4, 4, 1),
                (8, 16, 4), (64, 8, 256), (2, 32, 16)]


@pytest.mark.parametrize("slots,kvh,w", SPLIT_SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 1])
def test_decode_splits_is_at_least_one_and_at_most_the_table(slots, kvh, w,
                                                             sms):
    n = FA.decode_splits(slots, kvh, w, sms)
    assert isinstance(n, int)
    assert 1 <= n <= w
    assert n <= FA.DECODE_MAX_SPLITS


def test_decode_splits_cover_the_sms_at_the_serving_shape():
    """8 slots x 16 kv heads over a 128-column table bucket on an H100's
    132 SMs: the (slot, kv head, split) blocks are enough for every SM to
    hold DECODE_BLOCKS_PER_SM of them."""
    n = FA.decode_splits(8, 16, 128, 132)
    assert n > 1
    assert 8 * 16 * n >= FA.DECODE_BLOCKS_PER_SM * 132


@pytest.mark.parametrize("slots,kvh,w", SPLIT_SHAPES)
def test_decode_splits_depends_on_the_shapes_alone(slots, kvh, w):
    """The same shapes give the same split count (the grid a CUDA graph
    captures), whatever was asked before."""
    first = FA.decode_splits(slots, kvh, w, 132)
    for other in SPLIT_SHAPES:
        FA.decode_splits(*other, 132)
    assert FA.decode_splits(slots, kvh, w, 132) == first


def test_paged_decode_scratch_rows_are_finite_and_match():
    """Inactive slots (pos 0, table all scratch) come out finite and
    equal the JAX kernel's rows."""
    rng = np.random.default_rng(7)
    k = np.zeros((4, 4, 8, 8), np.float32)
    v = np.zeros((4, 4, 8, 8), np.float32)
    k[1:] = rng.normal(size=(3, 4, 8, 8))
    q = np.ones((2, 4, 8), np.float32)
    bt = np.zeros((2, 2), np.int32)
    pos = np.zeros((2,), np.int32)
    got = _port(q, k, v, bt, pos, 0)
    kern = np.asarray(j_paged(jnp.asarray(q), {"k": jnp.asarray(k),
                                               "v": jnp.asarray(v)},
                              jnp.asarray(bt), jnp.asarray(pos),
                              interpret=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kern, atol=TOL)


def test_paged_decode_takes_int8_pools_through_the_int8_branch():
    """Pools carrying "k_s" go to K4's int8 branch: `paged_flash_decode`
    gives its plain version over the int8 pools, the dequantized pools'
    float attention to 1e-5 (tests/test_torch_quant.py holds the branch
    against the JAX kernel)."""
    q, k, v, bt, pos = _inputs(0, seed=1)
    pool = {}
    for name, x in (("k", k), ("v", v)):
        s = np.abs(x).max(axis=-1, keepdims=True) / 127.0
        pool[name] = torch.from_numpy(np.round(x / s).astype(np.int8))
        pool[name + "_s"] = torch.from_numpy(s.astype(np.float32))
    args = (torch.from_numpy(q), pool, torch.from_numpy(bt),
            torch.from_numpy(pos))
    got = FA.paged_flash_decode(*args).numpy()
    np.testing.assert_array_equal(got,
                                  FA.paged_flash_decode_reference(*args))
    deq = (pool["k"].numpy() * pool["k_s"].numpy(),
           pool["v"].numpy() * pool["v_s"].numpy())
    assert _rel(got, _port(q, *deq, bt, pos, 0)) <= TOL


def _kernel_args(hd=64, dtype=torch.float32, bt_dtype=torch.int32):
    q = torch.zeros(4, 4, hd, dtype=dtype)
    k = torch.zeros(8, 4, 8, hd, dtype=dtype)
    return [q, k, k.clone(), torch.zeros(4, 3, dtype=bt_dtype),
            torch.zeros(4, dtype=torch.int32), 0]


@pytest.mark.parametrize("mutate,err", [
    (lambda a: a, None),
    (lambda a: _kernel_args(hd=8), ValueError),
    (lambda a: _kernel_args(dtype=torch.float16), TypeError),
    (lambda a: _kernel_args(bt_dtype=torch.int64), TypeError),
    (lambda a: a[:1] + [a[1].to(torch.bfloat16)] + a[2:], TypeError),
    (lambda a: a[:3] + [torch.zeros(3, 3, dtype=torch.int32)] + a[4:],
     ValueError),
    (lambda a: [a[0].transpose(0, 1)] + a[1:], ValueError),
    (lambda a: a[:5] + [-1], ValueError),
], ids=["ok", "head_dim", "float16", "int64-table", "mixed-dtype",
        "table-rows", "non-contiguous", "negative-window"])
def test_kernel_argument_checks(mutate, err):
    """What the CUDA wrapper refuses before any launch (checked on CPU
    tensors: the checks read only shapes, dtypes and layout)."""
    args = mutate(_kernel_args())
    if err is None:
        FA._check(*args)
    else:
        with pytest.raises(err):
            FA._check(*args)
