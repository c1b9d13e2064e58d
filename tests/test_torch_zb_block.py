"""The port's hand-split block backward (`shallowspeed_tpu_torch/parallel/
zb.py`) against the JAX package's `parallel/zb.py` on the same inputs —
the norm split, both attention cores (flash through the Pallas kernels
in interpret mode, as the JAX package's own tests run them on the CPU),
the block's F, B and W passes and the stage-level loops — and B + W
against torch autograd through the port's own `transformer._block`.

Tolerances (f32): 1e-5 relative per leaf (`torch_parity.worst`) against
JAX and against autograd; the passes are the same products in another
association order."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MODEL, worst

from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel import zb as JZB
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.ops.attention import attention
from shallowspeed_tpu_torch.ops.flash_attention import flash_attention
from shallowspeed_tpu_torch.parallel import zb as ZB

TOL = 1e-5
CONFIGS = {
    "gqa-rope-rms-swiglu": dict(MODEL),
    "mha-gelu-ln-window": dict(MODEL, n_kv_heads=0, rope=False,
                               norm="layernorm", ffn="gelu",
                               attn_window=8),
}
B, TT = 2, 32


def cfgs(name, n_layers=1):
    kw = dict(CONFIGS[name], n_layers=n_layers)
    return JT.TransformerConfig(**kw), T.TransformerConfig(**kw)


def rand(seed, *shape):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(
        np.float32)


def both(tree):
    """(jnp tree, torch tree) of one numpy tree."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def block_params(name, seed=3):
    """One block's numpy tree, norms and biases perturbed off their
    init so every term of the backward is exercised."""
    tcfg = cfgs(name)[1]
    blk = T.init_numpy(tcfg, seed)["blocks"][0]

    def jitter(path_seed, x):
        return (x + 0.1 * rand(path_seed, *x.shape)).astype(np.float32)

    return jax.tree_util.tree_map(
        lambda x: jitter(int(x.size) + x.ndim, x), blk)


def to_np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x.detach() if isinstance(x, torch.Tensor)
                             else x, np.float64), tree)


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_split_matches_jax(kind):
    p = {"g": 1.0 + 0.1 * rand(1, 64), "b": 0.1 * rand(2, 64)}
    x, dy = rand(3, B, TT, 64), rand(4, B, TT, 64)
    (jp, tp), (jx, tx), (jdy, tdy) = both(p), both(x), both(dy)
    jy, js = JZB.norm_fwd(jp, jx, kind)
    ty, ts = ZB.norm_fwd(tp, tx, kind)
    assert worst(to_np(ty), to_np(jy)) <= TOL
    assert worst(to_np(ts), to_np(js)) <= TOL
    jdx, jdp = JZB.norm_bwd(jp, jx, js, jdy, kind)
    tdx, tdp = ZB.norm_bwd(tp, tx, ts, tdy, kind)
    assert worst(to_np({"dx": tdx, **tdp}), to_np({"dx": jdx, **jdp})) <= TOL


@pytest.mark.parametrize("kvh,window", [(4, 0), (2, 8)],
                         ids=["mha", "gqa-window"])
@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_attention_core_matches_jax(attn, kvh, window):
    q, do = rand(5, B, TT, 4, 16), rand(6, B, TT, 4, 16)
    k, v = rand(7, B, TT, kvh, 16), rand(8, B, TT, kvh, 16)
    jf, jb = JZB.make_attn_core(attn, window)
    tf, tb = ZB.make_attn_core(attn, window)
    ji, ti = both({"q": q, "k": k, "v": v, "do": do})
    jo, jres = jf(ji["q"], ji["k"], ji["v"])
    to, tres = tf(ti["q"], ti["k"], ti["v"])
    assert worst(to_np(to), to_np(jo)) <= TOL
    jg = jb(ji["q"], ji["k"], ji["v"], jo, jres, ji["do"])
    tg = tb(ti["q"], ti["k"], ti["v"], to, tres, ti["do"])
    assert worst(to_np(list(tg)), to_np(list(jg))) <= TOL


def _block_io(name, attn):
    jcfg, tcfg = cfgs(name)
    blk = block_params(name)
    x, dy = rand(9, B, TT, 64), rand(10, B, TT, 64)
    (jblk, tblk), (jx, tx), (jdy, tdy) = both(blk), both(x), both(dy)
    return (jcfg, tcfg, jblk, tblk, jx, tx, jdy, tdy,
            JZB.make_attn_core(attn, jcfg.attn_window),
            ZB.make_attn_core(attn, tcfg.attn_window))


@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_block_passes_match_jax(name, attn):
    """F's output and residuals, B's dx, taps and norm grads, W's dense
    grads, each against the JAX pass on the same block and inputs."""
    (jcfg, tcfg, jblk, tblk, jx, tx, jdy, tdy, (jf, jb),
     (tf, tb)) = _block_io(name, attn)
    jpos, tpos = jnp.arange(TT), torch.arange(TT)
    jy, jrb, jrw = JZB.block_fwd(jblk, jx, jpos, jcfg, jf)
    ty, trb, trw = ZB.block_fwd(tblk, tx, tpos, tcfg, tf)
    assert worst(to_np(ty), to_np(jy)) <= TOL
    assert worst(to_np(trw), to_np(jrw)) <= TOL
    jdx, jtaps, jdn = JZB.block_bwd_x(jblk, jrb, jrw, jdy, jpos, jcfg, jb)
    tdx, ttaps, tdn = ZB.block_bwd_x(tblk, trb, trw, tdy, tpos, tcfg, tb)
    assert worst(to_np({"dx": tdx, "taps": ttaps, "n": tdn}),
                 to_np({"dx": jdx, "taps": jtaps, "n": jdn})) <= TOL
    stacked = partial(jax.tree_util.tree_map, lambda a: a[None])
    jw = jax.tree_util.tree_map(lambda a: a[0], JZB.stack_bwd_w(
        stacked(jrw), stacked(jtaps), jcfg))
    tw = ZB.block_bwd_w(trw, ttaps)
    assert worst(to_np(tw), to_np(jw)) <= TOL


@pytest.mark.parametrize("attn", ["xla", "flash"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_b_and_w_equal_autograd_of_the_block(name, attn):
    """B's dx and norm grads plus W's dense grads equal torch autograd
    through `transformer._block` on the substrate they replace."""
    _, tcfg, _, tblk, _, tx, _, tdy, _, (tf, tb) = _block_io(name, attn)
    pos = torch.arange(TT)
    y, rb, rw = ZB.block_fwd(tblk, tx, pos, tcfg, tf)
    dx, taps, dnorm = ZB.block_bwd_x(tblk, rb, rw, tdy, pos, tcfg, tb)
    got = {"x": dx, **dnorm, **ZB.block_bwd_w(rw, taps)}

    fn = flash_attention if attn == "flash" else attention
    p = jax.tree_util.tree_map(lambda a: a.clone().requires_grad_(True),
                               tblk)
    xi = tx.clone().requires_grad_(True)
    y_ref, _ = T._block(p, xi, tcfg, pos,
                        partial(fn, causal=True, window=tcfg.attn_window))
    assert worst(to_np(y), to_np(y_ref)) <= TOL
    names = list(got)
    ins = [xi] + [p[n] for n in names[1:]]
    grads = torch.autograd.grad(y_ref, jax.tree_util.tree_leaves(ins), tdy,
                                allow_unused=True, materialize_grads=True)
    want = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ins), list(grads))
    assert worst(to_np(dict(zip(names, [got[n] for n in names]))),
                 to_np(dict(zip(names, want)))) <= TOL


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_passes_match_jax(name):
    """Two layers through `stack_fwd`, `stack_bwd_x` (last layer first)
    and `stack_bwd_w` against the JAX scans over the stacked blocks."""
    jcfg, tcfg = cfgs(name, n_layers=2)
    blocks = T.init_numpy(tcfg, 4)["blocks"]
    jstack = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *blocks)
    tblocks = [jax.tree_util.tree_map(torch.from_numpy, b) for b in blocks]
    (jx, tx), (jdy, tdy) = both(rand(11, B, TT, 64)), both(rand(12, B, TT,
                                                                64))
    jf, jb = JZB.make_attn_core("xla", jcfg.attn_window)
    tf, tb = ZB.make_attn_core("xla", tcfg.attn_window)
    jpos, tpos = jnp.arange(TT), torch.arange(TT)
    jy, jrb, jrw = JZB.stack_fwd(jstack, jx, jpos, jcfg, jf)
    ty, trb, trw = ZB.stack_fwd(tblocks, tx, tpos, tcfg, tf)
    assert worst(to_np(ty), to_np(jy)) <= TOL
    jdx, jtaps, jdn = JZB.stack_bwd_x(jstack, jrb, jrw, jdy, jpos, jcfg, jb)
    tdx, ttaps, tdn = ZB.stack_bwd_x(tblocks, trb, trw, tdy, tpos, tcfg, tb)
    layer = [jax.tree_util.tree_map(lambda a, j=j: a[j], jdn)
             for j in range(2)]
    assert worst(to_np({"dx": tdx, "n": tdn}),
                 to_np({"dx": jdx, "n": layer})) <= TOL
    jw = JZB.stack_bwd_w(jrw, jtaps, jcfg)
    tw = ZB.stack_bwd_w(trw, ttaps)
    assert worst(to_np([jax.tree_util.tree_map(lambda a, j=j: a[j], jw)
                        for j in range(2)]), to_np(tw)) <= TOL


def test_flash_b_replays_k2_k3_and_never_k1(monkeypatch):
    """Under flash, F runs K1 once a layer and B runs K2 and K3 once a
    layer on the stash, with no K1 (the wrappers' plain versions
    counted on the CPU)."""
    calls = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    for n in calls:
        fn = getattr(FA, n)

        def counted(*a, n=n, fn=fn, **k):
            calls[n] += 1
            return fn(*a, **k)

        monkeypatch.setattr(FA, n, counted)
    _, tcfg = cfgs("gqa-rope-rms-swiglu", n_layers=3)
    blocks = [jax.tree_util.tree_map(torch.from_numpy, b)
              for b in T.init_numpy(tcfg, 4)["blocks"]]
    tf, tb = ZB.make_attn_core("flash", 0)
    pos = torch.arange(TT)
    y, rb, rw = ZB.stack_fwd(blocks, torch.from_numpy(rand(1, B, TT, 64)),
                             pos, tcfg, tf)
    assert calls == {"flash_fwd": 3, "flash_dq": 0, "flash_dkv": 0}
    ZB.stack_bwd_x(blocks, rb, rw, torch.ones_like(y), pos, tcfg, tb)
    assert calls == {"flash_fwd": 3, "flash_dq": 3, "flash_dkv": 3}
