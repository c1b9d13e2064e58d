"""The port's MoE FFN (`shallowspeed_tpu_torch.ops.moe`, the MoE half of
`models.transformer`, `parallel.expert.ExpertParallelEngine` at ep = 1)
against the JAX package's on the same numpy inputs, on the CPU.

Tolerances:
- routing (`topk_capacity_routing`): dispatch and combine exactly
  equal to JAX's on random logits, under sequence and priority routing,
  at a loose and at a tight capacity (drops occur); the balance loss
  and the stats within 1e-6;
- `moe_ffn`: output within 1e-5 of its max, aux and z within 1e-6;
- the MoE model's loss and gradients, f32: 1e-5 and 1e-4 per leaf, the
  bounds of `tests/test_torch_train.py`; `router_stats` within 1e-6;
- a 3-step engine trajectory against JAX's `ExpertParallelEngine` on
  a (1, 1) CPU mesh: losses 1e-5, parameters 1e-5 absolute, moments
  1e-4 per leaf; checkpoints across the packages bit for bit, then
  within 1e-4.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_parity import batch, jtree, worst

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.ops import moe as JM
from shallowspeed_tpu.parallel.expert import (
    ExpertParallelEngine as JaxExpertEngine)
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import moe as M
from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_grid
from shallowspeed_tpu_torch.weights import (leaves, params_from_numpy,
                                            unflatten)

MOE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, max_seq=16,
           n_experts=4, moe_top_k=2, moe_capacity_factor=2.0)


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("capacity", [16, 3], ids=["loose", "tight"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("priority", [False, True],
                         ids=["sequence", "priority"])
def test_routing_equals_jax(priority, top_k, capacity):
    """From the same router probabilities (JAX's softmax of the logits)
    the port's routing gives JAX's dispatch and combine exactly; from
    the logits, its own softmax makes the same choices (dispatch
    exactly) with combine within 1e-6 relative (XLA's f32 exp on the
    CPU is not torch's: ~9 % of them differ by an ulp). At capacity 3
    assignments drop; at 16 none do."""
    rng = np.random.default_rng(top_k + capacity)
    logits = rng.normal(size=(3, 16, 4)).astype(np.float32)
    jc, jd, ja, js = jax.device_get(JM.topk_capacity_routing(
        jnp.asarray(logits), capacity, top_k, priority=priority))
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    pc, pd, pa, ps = M.route(torch.from_numpy(probs), capacity, top_k,
                             priority=priority)
    np.testing.assert_array_equal(pd.numpy(), jd)
    np.testing.assert_array_equal(pc.numpy(), jc)
    assert float(pa) == pytest.approx(float(ja), abs=1e-6)
    tc, td, ta, ts = M.topk_capacity_routing(torch.from_numpy(logits),
                                             capacity, top_k,
                                             priority=priority)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-6, atol=0)
    assert abs(float(ta) - float(ja)) <= 1e-6
    for stats in (ps, ts):
        np.testing.assert_allclose(stats["load"].numpy(), js["load"],
                                   atol=1e-6)
        assert abs(float(stats["drop_fraction"])
                   - float(js["drop_fraction"])) <= 1e-6
    assert (float(js["drop_fraction"]) > 0) == (capacity == 3)


def test_capacity_and_z_loss_equal_jax():
    for args in [(16, 4, 2, 2.0), (7, 3, 1, 1.25), (2048, 4, 2, 2.0),
                 (5, 8, 2, 0.1)]:
        assert M.expert_capacity(*args) == JM.expert_capacity(*args)
    logits = np.random.default_rng(1).normal(size=(2, 8, 4)).astype(
        np.float32) * 3
    assert float(M.router_z_loss(torch.from_numpy(logits))) == \
        pytest.approx(float(JM.router_z_loss(jnp.asarray(logits))),
                      rel=1e-6)


@pytest.mark.parametrize("priority", [False, True],
                         ids=["sequence", "priority"])
def test_moe_ffn_equals_jax(priority):
    cfg = JT.TransformerConfig(**MOE)
    p = JT.init(cfg, seed=3)["blocks"][0]["moe"]
    x = np.random.default_rng(4).normal(size=(2, 16, 32)).astype(np.float32)
    jy, ja, jz, js = jax.device_get(JM.moe_ffn(
        jtree(p), jnp.asarray(x), 2, 1.0, priority=priority))
    ty, ta, tz, ts = M.moe_ffn(params_from_numpy(p, "cpu"),
                               torch.from_numpy(x), 2, 1.0,
                               priority=priority)
    assert float(np.abs(ty.numpy() - jy).max() / np.abs(jy).max()) <= 1e-5
    assert abs(float(ta) - float(ja)) <= 1e-6
    assert abs(float(tz) - float(jz)) <= 1e-6
    assert worst(ts, js, absolute=True) <= 1e-6


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
def test_moe_init_equals_jax(ffn):
    """The same seed draws the same MoE tree (no dense FFN, no SwiGLU
    gate under experts), key for key and bit for bit."""
    kw = dict(MOE, ffn=ffn, n_kv_heads=2)
    ref = JT.init(JT.TransformerConfig(**kw), seed=7)
    got = T.init_numpy(T.TransformerConfig(**kw), seed=7)
    assert set(got["blocks"][0]) == set(ref["blocks"][0])
    assert "moe" in got["blocks"][0] and "up" not in got["blocks"][0]
    assert worst(got, ref) == 0.0
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(ref)


MODELS = {
    "sequence": dict(),
    "priority-z": dict(moe_routing="priority", moe_z_weight=1e-2,
                       moe_capacity_factor=1.0),
    "top1-gqa-rope": dict(moe_top_k=1, n_kv_heads=2, rope=True,
                          norm="rmsnorm"),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_moe_loss_and_grads_equal_jax(name):
    """`T.loss` (token loss + weighted balance and z losses) and every
    gradient leaf against `jax.value_and_grad(JT.loss)`."""
    kw = {**MOE, **MODELS[name]}
    jcfg = JT.TransformerConfig(**kw)
    params = JT.init(jcfg, seed=1)
    tok, tgt = batch(kw["vocab"], 2, t=16)
    jl, jg = jax.jit(jax.value_and_grad(JT.loss), static_argnums=3)(
        jtree(params), jnp.asarray(tok), jnp.asarray(tgt), jcfg)
    tp = params_from_numpy(params, "cpu")
    flat = list(leaves(tp))
    for p in flat:
        p.requires_grad_(True)
    tl = T.loss(tp, torch.from_numpy(tok), torch.from_numpy(tgt),
                T.TransformerConfig(**kw))
    tg = torch.autograd.grad(tl, flat, allow_unused=True,
                             materialize_grads=True)
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) / abs(float(jl)) <= 1e-5
    assert worst(unflatten(tp, tg), jax.device_get(jg)) <= 1e-4


def test_forward_with_aux_sums_layers_and_averages_stats():
    kw = dict(MOE, moe_capacity_factor=0.5)
    jcfg, tcfg = JT.TransformerConfig(**kw), T.TransformerConfig(**kw)
    params = JT.init(jcfg, seed=2)
    tok, _ = batch(kw["vocab"], 3, t=16)
    _, (ja, jz), js = jax.device_get(JT.forward_with_aux(
        jtree(params), jnp.asarray(tok), jcfg, with_stats=True))
    _, (ta, tz), ts = T.forward_with_aux(params_from_numpy(params, "cpu"),
                                         torch.from_numpy(tok), tcfg,
                                         with_stats=True)
    assert abs(float(ta) - float(ja)) <= 1e-6
    assert abs(float(tz) - float(jz)) <= 1e-5 * abs(float(jz))
    assert worst(ts, js, absolute=True) <= 1e-6
    assert float(ts["drop_fraction"]) > 0
    dense = T.TransformerConfig(**{**kw, "n_experts": 0})
    assert T.forward_with_aux(T.init(dense, 0, device="cpu"),
                              torch.from_numpy(tok), dense,
                              with_stats=True)[1:] == ((0.0, 0.0), None)


def test_moe_remat_is_bit_identical():
    kw = dict(MOE, dropout=0.1)
    tok, tgt = (torch.from_numpy(a) for a in batch(kw["vocab"], 4, t=16))
    out = []
    for remat in (False, True):
        cfg = T.TransformerConfig(**kw, remat=remat, remat_policy="dots",
                                  moe_z_weight=1e-2)
        params = T.init(cfg, 1, device="cpu")
        flat = list(leaves(params))
        for p in flat:
            p.requires_grad_(True)
        loss = T.loss(params, tok, tgt, cfg, dropout_key=5)
        out.append((loss.detach(), torch.autograd.grad(loss, flat)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# --------------------------------------------------------------- engine

def _engines(kw, opt, seed=5):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "ep"))
    je = JaxExpertEngine(JT.TransformerConfig(**kw), opt(JO), mesh,
                         seed=seed)
    te = ExpertParallelEngine(T.TransformerConfig(**kw), opt(O), seed=seed,
                              device="cpu")
    return je, te


# SGD and momentum: optimizers that normalize each element (AdamW,
# Adafactor's unfactored leaves) turn the f32 noise of a gradient that
# is 0 in exact arithmetic (the key bias's: softmax ignores a shift
# shared by every key) into updates of +-lr x scale whose sign is the
# noise's (`tests/test_torch_train_accum.py`), which says nothing of MoE
OPTS = {"momentum": (lambda M_: M_.MomentumSGD(
            M_.warmup_cosine(1e-2, 1, 3), momentum=0.9, grad_clip=1.0),
            ("v",)),
        "sgd": (lambda M_: M_.SGD(M_.warmup_linear(5e-2, 1, 3),
                                  grad_clip=1.0), ())}


@pytest.mark.parametrize("optname", list(OPTS))
def test_engine_trajectory_equals_jax_engine(optname):
    """Three steps of the one-device MoE engine against JAX's
    `ExpertParallelEngine` on a (1, 1) mesh: losses, parameters,
    optimizer state, then eval loss, logits and router stats on the
    trained weights."""
    opt, slots = OPTS[optname]
    kw = dict(MOE, moe_z_weight=1e-3)
    je, te = _engines(kw, opt)
    assert worst(te.get_canonical_params(),
                 jax.device_get(je.params)) == 0.0
    for step in range(3):
        tok, tgt = batch(kw["vocab"], 10 + step, b=4, t=16)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-5
    assert worst(te.params, jax.device_get(je.params),
                 absolute=True) <= 1e-5
    jstate = jax.device_get(je.opt_state)
    assert te.opt_state["t"] == int(jstate["t"]) == 3
    for key in slots:
        assert worst(te.opt_state[key], jstate[key]) <= 1e-4
    tok, tgt = batch(kw["vocab"], 20, b=4, t=16)
    assert te.eval_loss(tok, tgt) == pytest.approx(je.eval_loss(tok, tgt),
                                                   rel=1e-5)
    jlog = np.asarray(je.logits(tok))
    assert float(np.abs(te.logits(tok).numpy() - jlog).max()
                 / np.abs(jlog).max()) <= 1e-5
    jr, tr = je.router_stats(tok), te.router_stats(tok)
    assert tr["expert_load"] == pytest.approx(jr["expert_load"], abs=1e-4)
    assert tr["drop_fraction"] == pytest.approx(jr["drop_fraction"],
                                                abs=1e-4)


@pytest.mark.parametrize("kwargs,error", [
    (dict(ep=3), ValueError), (dict(axes=("dp", "tp")), ValueError),
    (dict(n_experts=0), ValueError), (dict(moe_top_k=5), ValueError)],
    ids=["ep3-indivisible", "tp-axes", "dense", "top-k"])
def test_engine_refusals(kwargs, error):
    """The reference engine's checks: experts divisible by ep, a
    ('dp'[, 'sp'], 'ep') grid, an MoE config, top-k within the
    experts (ep > 1 and dp > 1 run: tests/test_torch_expert_parallel.py)."""
    ep = kwargs.pop("ep", 1)
    axes = kwargs.pop("axes", ("dp", "ep"))
    cfg = T.TransformerConfig(**{**MOE, **kwargs})
    with pytest.raises(error):
        ExpertParallelEngine(cfg, O.SGD(0.1),
                             mesh=make_grid(axes, (1, ep), "cpu"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_moe_checkpoint_crosses_packages(tmp_path, writer):
    """A MoE engine (AdamW) trained 2 steps and saved by one package
    restores into the other's engine (another seed) bit for bit with
    no re-initialization; both continue within 1e-4."""
    kw = dict(MOE)

    def opt(M_):
        return M_.AdamW(1e-3, weight_decay=0.01)

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "ep"))
    je = JaxExpertEngine(JT.TransformerConfig(**kw), opt(JO), mesh,
                         seed=5 if writer == "jax" else 9)
    te = ExpertParallelEngine(T.TransformerConfig(**kw), opt(O),
                              seed=5 if writer == "port" else 9,
                              device="cpu")
    src, dst = (je, te) if writer == "jax" else (te, je)
    for s in range(2):
        src.train_batch(*batch(kw["vocab"], 30 + s, b=4, t=16))
    (JC if writer == "jax" else C).save(tmp_path, src, 1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert (C if writer == "jax" else JC).restore(
            dst, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    jstate = jax.device_get(je.opt_state)
    assert worst(te.params, jax.device_get(je.params)) == 0.0
    assert worst({k: te.opt_state[k] for k in "mv"},
                 {k: jstate[k] for k in "mv"}) == 0.0
    for s in (2, 3):
        tok, tgt = batch(kw["vocab"], 30 + s, b=4, t=16)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-4
