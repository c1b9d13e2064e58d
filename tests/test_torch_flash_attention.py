"""The port's training attention (`shallowspeed_tpu_torch.ops.
flash_attention`: K1/K2/K3's plain versions and the `flash_attention`
autograd Function) against the JAX package's Pallas chunk kernels
(`_chunk_fwd`, `_chunk_dq`, `_chunk_dkv`, run in interpret mode) and
its `flash_attention` under `jax.grad`, on the same numpy inputs, in
float32 on the CPU. Tolerances are max |diff| / max |ref|: 1e-5 on o
and lse, 1e-4 on the gradients (the same f32 arithmetic, summed in
another order; the backward's three chained products lose one more
digit). `gradcheck` in float64 checks the hand-written backward on its
own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu.ops import flash_attention as JFA
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.ops.attention import attention

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
B, T, H, D = 2, 64, 4, 16
BLOCK = 16          # JAX tiles: 4 x 4 per head, so tile skipping is exercised


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-6,
                                                float(np.abs(ref).max()))


def _inputs(kvh, seed):
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return rnd(B, T, H, D), rnd(B, T, kvh, D), rnd(B, T, kvh, D), \
        rnd(B, T, H, D)


def _jax_chunks(q, k, v, do, causal, window, rel):
    """The JAX chunk kernels in their folded layout, unfolded back to
    (B, T, H, D) / (B, H, T)."""
    kvh = k.shape[2]
    g = H // kvh
    q3 = JFA._fold_q(jnp.asarray(q), kvh)
    k3, v3 = JFA._to_bhsd(jnp.asarray(k)), JFA._to_bhsd(jnp.asarray(v))
    do3 = JFA._fold_q(jnp.asarray(do), kvh)
    kw = dict(causal=causal, window=window, bq=BLOCK, bk=BLOCK,
              nqb_chunk=T // BLOCK, interpret=True)
    o3, lse3 = JFA._chunk_fwd(q3, k3, v3, rel, **kw)
    delta3 = JFA._delta_of(do3, o3, lse3)
    dq3 = JFA._chunk_dq(q3, k3, v3, do3, lse3, delta3, rel, **kw)
    dk3, dv3 = JFA._chunk_dkv(q3, k3, v3, do3, lse3, delta3, rel,
                              groups=g, **kw)

    def stats(x):        # (B*Hkv, G*T, 128 lanes) -> (B, H, T)
        return np.asarray(x[..., 0]).reshape(B, H, T)

    return {"o": np.asarray(JFA._unfold_q(o3, B, H)), "lse": stats(lse3),
            "delta": stats(delta3),
            "dq": np.asarray(JFA._unfold_q(dq3, B, H)),
            "dk": np.asarray(JFA._from_bhsd(dk3, B, kvh)),
            "dv": np.asarray(JFA._from_bhsd(dv3, B, kvh))}


MASKS = {"causal": (True, 0), "full": (False, 0), "window": (True, 8)}


@pytest.mark.parametrize("rel", [0, T], ids=["rel0", "relT"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_plain_kernels_match_jax_chunk_kernels(kvh, mask, rel):
    """K1, K2, K3's plain versions against the Pallas chunk kernels,
    including a diagonal offset rel = T (a ring chunk whose queries all
    follow its keys). With rel = T the window is widened to T + 16 so
    that it still masks yet leaves no row empty."""
    causal, window = MASKS[mask]
    if window and rel:
        window = T + 16
    q, k, v, do = _inputs(kvh, seed=kvh + rel + window)
    ref = _jax_chunks(q, k, v, do, causal, window, rel)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    kw = dict(causal=causal, window=window, rel=rel)
    o, lse = FA.flash_fwd_reference(tq, tk, tv, **kw)
    assert _rel(o, ref["o"]) <= FWD_TOL
    assert _rel(lse, ref["lse"]) <= FWD_TOL
    delta = FA.attention_delta(tdo, o)
    assert _rel(delta, ref["delta"]) <= FWD_TOL
    # the backward reads the JAX forward's lse, so each kernel is
    # compared on exactly its own inputs
    jlse = torch.from_numpy(ref["lse"].copy())
    dq = FA.flash_dq_reference(tq, tk, tv, tdo, jlse, delta, **kw)
    dk, dv = FA.flash_dkv_reference(tq, tk, tv, tdo, jlse, delta, **kw)
    assert _rel(dq, ref["dq"]) <= GRAD_TOL
    assert _rel(dk, ref["dk"]) <= GRAD_TOL
    assert _rel(dv, ref["dv"]) <= GRAD_TOL


def test_a_row_that_sees_nothing_comes_out_zero():
    """rel < 0 with causal leaves the first rows without a visible key
    (a ring chunk before its queries): o = 0 and lse = -1e30, finite, as
    the JAX kernel gives."""
    q, k, v, do = _inputs(2, seed=9)
    rel = -20
    ref = _jax_chunks(q, k, v, do, True, 0, rel)
    o, lse = FA.flash_fwd_reference(*map(torch.from_numpy, (q, k, v)),
                                    causal=True, rel=rel)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o[:, :20] == 0).all()
    assert (lse[:, :, :20] <= -1e30).all()
    assert _rel(o, ref["o"]) <= FWD_TOL
    np.testing.assert_array_equal(lse.numpy()[:, :, :20],
                                  ref["lse"][:, :, :20])


@pytest.mark.parametrize("kvh,window", [(4, 0), (2, 0), (2, 8)],
                         ids=["mha", "gqa", "gqa-window"])
def test_flash_attention_grads_match_jax(kvh, window):
    """The port's `flash_attention` Function (K1 forward, delta, K2, K3
    backward) against `jax.grad` through the JAX `flash_attention`
    custom_vjp, on sum(o * cotangent)."""
    q, k, v, cot = _inputs(kvh, seed=20 + kvh + window)

    def jloss(q, k, v):
        o = JFA.flash_attention(q, k, v, True, window, BLOCK, BLOCK, True)
        return jnp.sum(o * cot)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o = FA.flash_attention(tq, tk, tv, True, window)
    tl = (o * torch.from_numpy(cot)).sum()
    tg = torch.autograd.grad(tl, (tq, tk, tv))
    assert _rel(tl.detach(), jl) <= FWD_TOL
    for got, ref in zip(tg, jg):
        assert got.dtype == torch.float32
        assert _rel(got, ref) <= GRAD_TOL


@pytest.mark.parametrize("kvh,causal,window", [(2, True, 0), (1, True, 4),
                                               (2, False, 0)],
                         ids=["gqa-causal", "mqa-window", "gqa-full"])
def test_flash_attention_gradcheck_float64(kvh, causal, window):
    """The hand-written backward against finite differences in float64
    (independent of JAX)."""
    g = torch.Generator().manual_seed(kvh + window)
    q = torch.randn(1, 10, 2, 8, dtype=torch.float64, generator=g)
    k = torch.randn(1, 10, kvh, 8, dtype=torch.float64, generator=g)
    v = torch.randn(1, 10, kvh, 8, dtype=torch.float64, generator=g)
    args = tuple(x.requires_grad_(True) for x in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FA.flash_attention(q, k, v, causal, window), args)


def test_flash_attention_matches_plain_attention_and_counts_no_launch():
    """On CPU tensors the Function computes the plain versions — equal
    to the plain `attention` in f32 — and launches no kernel."""
    q, k, v, _ = _inputs(2, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = (FA.flash_fwd.launches, FA.flash_dq.launches,
              FA.flash_dkv.launches)
    got = FA.flash_attention(tq.requires_grad_(True), tk, tv, True, 8)
    got.sum().backward()
    ref = attention(tq.detach(), tk, tv, True, 8)
    assert _rel(got.detach(), ref) <= FWD_TOL
    assert (FA.flash_fwd.launches, FA.flash_dq.launches,
            FA.flash_dkv.launches) == before
