"""The port's sequence-parallel attention substrates against the JAX
package's under `shard_map` on an sp CPU mesh, on the same numpy
inputs in float32: `ring_attention`, `ulysses_attention` (plain and
with the flash kernels) and `ring_flash_attention`, forward and the
gradients of a weighted sum of the output, over sp 1/2/4, GQA, a
sliding window and non-causal masks; K1's f32-output plain version
against the Pallas `_chunk_fwd(out_dtype=f32)` in interpret mode; the
ring's hop schedule (which chunks launch K1/K2/K3).

Tolerances: max |diff| / max |ref|, 2e-5 on outputs (the same f32
arithmetic, summed in another order) and 1e-4 on gradients (three
chained products lose one more digit), the bounds of
`tests/test_torch_flash_attention.py`; K1's f32 output 1e-5.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from shallowspeed_tpu.ops.attention import ring_attention, ulysses_attention
from shallowspeed_tpu.ops import flash_attention as JFA
from shallowspeed_tpu.utils import shard_map
from shallowspeed_tpu_torch.ops import attention as A
from shallowspeed_tpu_torch.ops import flash_attention as FA

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
B, T, H, D = 2, 64, 4, 16


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


def _jax_fwd_grads(fn, q, k, v, w, sp, local_loss=False):
    """(o, (dq, dk, dv)) of a JAX substrate `fn(q, k, v)` under shard_map
    on an sp mesh; the gradients are of sum(o * w). A hand-written VJP
    (`ring_flash_attention`) is differentiated on each device's local
    part of the loss, whose reverse ring delivers the other devices'
    cotangents (the harness of `tests/test_flash_attention.py`); the
    autodiffed substrates through a psum of it."""
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, "sp")
    o = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                          out_specs=spec))(q, k, v)
    if local_loss:
        grads = jax.jit(shard_map(
            lambda a, b, c, ww: jax.grad(
                lambda x, y, z: (fn(x, y, z) * ww).sum(),
                argnums=(0, 1, 2))(a, b, c),
            mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 3))(
                q, k, v, w)
    else:
        loss = shard_map(
            lambda a, b, c, ww: jax.lax.psum((fn(a, b, c) * ww).sum(), "sp"),
            mesh=mesh, in_specs=(spec,) * 4, out_specs=P())
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v, w)
    return np.asarray(o), [np.asarray(g) for g in grads]


def _torch_fwd_grads(fn, q, k, v, w):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    o = fn(*ts)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(got, ref, name):
    (o, g), (jo, jg) = got, ref
    assert _rel(o, jo) <= FWD_TOL, f"{name} o"
    for x, gx, jx in zip("qkv", g, jg):
        assert _rel(gx, jx) <= GRAD_TOL, f"{name} d{x}"


MASKS = {"causal": (True, 0), "window": (True, 24), "full": (False, 0)}


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_attention_matches_jax(sp, kvh, mask):
    causal, window = MASKS[mask]
    q, k, v, w = _inputs(kvh, seed=sp + kvh)
    ref = _jax_fwd_grads(partial(ring_attention, axis_name="sp",
                                 causal=causal, window=window),
                         q, k, v, w, sp)
    got = _torch_fwd_grads(partial(A.ring_attention, devices=sp,
                                   causal=causal, window=window), q, k, v, w)
    _check(got, ref, "ring")


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ulysses_attention_matches_jax(sp, mask, use_flash):
    """GQA with kv heads = sp at sp 2 and 4 (one kv head per cell at 4),
    MHA at sp 1. The flash variant runs the JAX kernels in interpret
    mode and the port's plain K1/K2/K3."""
    causal, window = MASKS[mask]
    kvh = max(sp, 2)
    q, k, v, w = _inputs(kvh, seed=10 + sp)
    ref = _jax_fwd_grads(partial(ulysses_attention, axis_name="sp",
                                 causal=causal, window=window,
                                 use_flash=use_flash), q, k, v, w, sp)
    got = _torch_fwd_grads(partial(A.ulysses_attention, devices=sp,
                                   causal=causal, window=window,
                                   use_flash=use_flash), q, k, v, w)
    _check(got, ref, "ulysses")


def test_ulysses_refuses_indivisible_heads():
    """The reference's divisibility errors, word for word."""
    q, k, v, _ = _inputs(2, seed=3)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match=r"needs heads \(4\) divisible by "
                                         r"the 'sp' axis size \(8\)"):
        A.ulysses_attention(tq, tk, tv, devices=8)
    with pytest.raises(ValueError, match=r"with GQA needs kv_heads \(2\) "
                                         r"divisible by the 'sp' axis size "
                                         r"\(4\)"):
        A.ulysses_attention(tq, tk, tv, devices=4)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_flash_attention_matches_jax(sp, kvh, mask):
    """The ring with K1 (f32 chunk outputs), K2 and K3 as each chunk's
    compute, and its reverse ring, against the JAX ring's Pallas
    kernels in interpret mode."""
    causal, window = MASKS[mask]
    q, k, v, w = _inputs(kvh, seed=20 + sp + kvh)
    ref = _jax_fwd_grads(partial(JFA.ring_flash_attention, axis_name="sp",
                                 causal=causal, window=window),
                         q, k, v, w, sp, local_loss=True)
    got = _torch_fwd_grads(partial(FA.ring_flash_attention, devices=sp,
                                   causal=causal, window=window), q, k, v, w)
    _check(got, ref, "ring-flash")


def test_ring_substrates_agree_with_plain_attention():
    """At sp 4 the three substrates give plain attention's output on the
    gathered sequence (the single-device oracle)."""
    q, k, v, _ = _inputs(4, seed=31)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = A.attention(tq, tk, tv, causal=True, window=24)
    for fn in (A.ring_attention, FA.ring_flash_attention,
               partial(A.ulysses_attention, use_flash=True)):
        got = fn(tq, tk, tv, 4, causal=True, window=24)
        assert _rel(got, want) <= FWD_TOL


@pytest.mark.parametrize("rel", [0, T, -T], ids=["rel0", "relT", "rel-T"])
def test_k1_f32_output_matches_jax_chunk(rel):
    """K1's plain version with `out_dtype` float32 on bf16 inputs against
    `_chunk_fwd(out_dtype=jnp.float32)` (Pallas, interpret mode), both
    f32 throughout: rel 0 (the diagonal), T (every key before every
    query) and -T with a window (every row masked: o 0, lse -1e30)."""
    q, k, v, _ = _inputs(2, seed=40)
    window = 16 if rel < 0 else 0
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    kvh = 2
    q3 = JFA._fold_q(bf[0], kvh)
    k3, v3 = JFA._to_bhsd(bf[1]), JFA._to_bhsd(bf[2])
    o3, lse3 = JFA._chunk_fwd(q3, k3, v3, rel, causal=True, window=window,
                              bq=16, bk=16, nqb_chunk=T // 16,
                              interpret=True, out_dtype=jnp.float32)
    jo = np.asarray(JFA._unfold_q(o3, B, H))
    jlse = np.asarray(lse3[..., 0]).reshape(B, H, T)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16) for x in bf)
    o, lse = FA.flash_fwd(tq, tk, tv, causal=True, window=window, rel=rel,
                          out_dtype=torch.float32)
    assert o.dtype == torch.float32 and jo.dtype == np.float32
    if rel < 0:
        assert not o.any() and bool((lse == -1e30).all())
        assert not jo.any() and bool((jlse == -1e30).all())
        return
    assert _rel(o, jo) <= 1e-5 and _rel(lse, jlse) <= 1e-5
    # the bf16 output is the f32 one rounded once
    o16, _ = FA.flash_fwd(tq, tk, tv, causal=True, rel=rel)
    assert o16.dtype == torch.bfloat16
    assert torch.equal(o16, o.to(torch.bfloat16))


@pytest.mark.parametrize("causal,window,want", [
    (True, 0, "triangle"), (True, 24, "square"), (False, 0, "square")])
@pytest.mark.parametrize("sp", [1, 2, 4, 8])
def test_ring_hops_launch_counts(sp, causal, window, want):
    """Chunks (hence K1, K2 and K3 launches) per layer: sp (sp + 1) / 2
    under causal masking with no window, sp^2 otherwise; every cell
    starts on its own block at rel 0, and a visiting block's rel is i t
    or (i - sp) t."""
    t = 16
    hops = [list(FA.ring_hops(sp, idx, t, causal, window))
            for idx in range(sp)]
    n = sum(len(h) for h in hops)
    assert n == (sp * (sp + 1) // 2 if want == "triangle" else sp * sp)
    for idx, h in enumerate(hops):
        assert h[0] == (0, 0)
        assert [i for i, _ in h] == sorted(i for i, _ in h)
        for i, rel in h:
            assert rel == (i * t if idx >= i else (i - sp) * t)
