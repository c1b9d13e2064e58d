"""The port's one-device training features against the JAX package on
the same numpy inputs, on the CPU: Adafactor, chunked cross-entropy,
remat under each policy, dropout and attention dropout. The JAX flash
kernel runs in Pallas interpret mode; the port's flash attention takes
its plain version on CPU tensors.

Tolerances (max |diff| / max |ref| unless stated):
- Adafactor: 1e-6 on parameters and slots after 3 steps (the same f32
  formulas, term for term; measured ~3e-7);
- chunked cross-entropy: loss 1e-5, gradients 1e-4 per leaf, against
  JAX's chunked loss and against the port's unchunked loss (the same
  quantity reassociated per chunk; measured ~1e-7 and ~1e-6);
- remat: loss and gradients bit-identical to no remat (the same ops
  recomputed on the same inputs); against JAX's remat loss the f32
  bounds of `tests/test_torch_train.py` (1e-5, 1e-4);
- dropout: distributions, not bits (the masks are not threefry's): the
  kept fraction within 4 sigma of the binomial's mean.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import MODEL, batch, jtree, worst

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.ops.flash_attention import (
    flash_attention as j_flash)
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import dropout as D
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.ops.attention import attention
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.weights import (leaves, params_from_numpy,
                                            sorted_leaves, unflatten)


# ------------------------------------------------------------- Adafactor

ADAFACTOR = {
    "factored": {},
    "beta1": dict(beta1=0.9),
    "decay": dict(weight_decay=0.1),
    "clip": dict(grad_clip=0.5),
    "unscaled": dict(scale_parameter=False, weight_decay=0.1),
}


@pytest.mark.parametrize("schedule", [False, True],
                         ids=["constant", "cosine"])
@pytest.mark.parametrize("name", list(ADAFACTOR))
def test_adafactor_matches_jax(name, schedule):
    """Three steps on a tree of factored (ndim 3 and 2) and full (ndim
    1) leaves, with dict keys out of sorted order: parameters and every
    slot within 1e-6, the slots in the JAX package's leaf order."""
    rng = np.random.default_rng(7)
    tree = {"w": {"W": rng.normal(size=(6, 5)).astype(np.float32),
                  "b": rng.normal(size=(5,)).astype(np.float32)},
            "experts": [rng.normal(size=(3, 4, 5)).astype(np.float32)],
            "a": rng.normal(size=(7,)).astype(np.float32)}

    def opt(M):
        lr = M.warmup_cosine(1e-2, 1, 3) if schedule else 1e-2
        return M.Adafactor(lr, **ADAFACTOR[name])

    jo, to = opt(JO), opt(O)
    jp, tp = jtree(tree), params_from_numpy(tree, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    assert [sorted(s) for s in ts["slots"]] == [sorted(s) for s in
                                                js["slots"]]
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        jp, js = jo.step(jp, jtree(g), js)
        tp, ts = to.step(tp, params_from_numpy(g, "cpu"), ts)
    assert ts["t"] == int(js["t"]) == 3
    assert worst(tp, jax.device_get(jp)) <= 1e-6
    assert worst(ts["slots"], jax.device_get(js)["slots"]) <= 1e-6
    # the slots are keyed by the reference's flattening order
    assert [tuple(p.shape) for p in sorted_leaves(tp)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)]


def test_adafactor_state_is_not_params_shaped():
    opt = O.Adafactor(1e-2)
    state = opt.init({"W": torch.zeros(3, 4)})
    assert set(state["slots"][0]) == {"vr", "vc"}
    assert state["slots"][0]["vr"].shape == (3,)
    assert state["slots"][0]["vc"].shape == (4,)
    with pytest.raises(ValueError, match="not params-shaped"):
        opt.map_state_trees(state, lambda t: t)


# ------------------------------------------------- chunked cross-entropy

CHUNKS = {
    "even": (dict(), 16),
    "padded": (dict(), 24),
    "smoothing": (dict(label_smoothing=0.1), 20),
    "tied-softcap": (dict(tie_embeddings=True, logit_softcap=5.0), 40),
    "one-chunk": (dict(), 1000),
}


def _loss_and_grads(fn, params):
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss = fn(params)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), unflatten(params, grads)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", list(CHUNKS))
def test_chunked_loss_matches_jax_and_unchunked(name, train):
    """`T.loss` with xent_chunk (B*T = 64 positions) and its gradients
    against JAX's chunked loss, and against the port's unchunked loss;
    eval (train=False) drops the smoothing in both."""
    extra, chunk = CHUNKS[name]
    kw = {**MODEL, **extra}
    jcfg = JT.TransformerConfig(**kw, xent_chunk=chunk)
    params = JT.init(jcfg, seed=1)
    tok, tgt = batch(kw["vocab"], 2)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss(p, jnp.asarray(tok), jnp.asarray(tgt), jcfg,
                          train=train)))(jtree(params))
    tt, tg_ = torch.from_numpy(tok), torch.from_numpy(tgt)
    got = {}
    for c in (chunk, 0):
        cfg = T.TransformerConfig(**kw, xent_chunk=c)
        got[c] = _loss_and_grads(
            lambda p: T.loss(p, tt, tg_, cfg, train=train),
            params_from_numpy(params, "cpu"))
    loss, grads = got[chunk]
    assert abs(float(loss) - float(jl)) / abs(float(jl)) <= 1e-5
    assert worst(grads, jax.device_get(jg)) <= 1e-4
    assert abs(float(loss) - float(got[0][0])) / float(got[0][0]) <= 1e-5
    assert worst(grads, got[0][1]) <= 1e-4


def test_chunked_loss_never_holds_the_whole_logits(monkeypatch):
    """Every head product of the chunked loss covers at most xent_chunk
    positions, in the forward and in the backward's recompute."""
    cfg = T.TransformerConfig(**MODEL, xent_chunk=24)
    tok, tgt = batch(cfg.vocab, 3)
    rows = []
    orig = T.head_logits

    def spy(params, x, cfg):
        rows.append(x.reshape(-1, x.shape[-1]).shape[0])
        return orig(params, x, cfg)

    monkeypatch.setattr(T, "head_logits", spy)
    _loss_and_grads(lambda p: T.loss(p, torch.from_numpy(tok),
                                     torch.from_numpy(tgt), cfg),
                    T.init(cfg, 1, device="cpu"))
    assert rows == [24, 24, 16, 16, 24, 24]   # forward, then recomputes


# ----------------------------------------------------------------- remat

POLICIES = ["full", "attn", "dots"]


def _count_flash_fwd(monkeypatch):
    calls = [0]
    orig = FA.flash_fwd

    def spy(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(FA, "flash_fwd", spy)
    return calls


@pytest.mark.parametrize("substrate", ["flash", "plain"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_is_bit_identical_to_no_remat(monkeypatch, policy,
                                            substrate):
    """Loss and every gradient leaf under each policy equal no remat's
    bit for bit, with dropout and chunked cross-entropy on (the masks
    come from keys, so the recompute redraws them). With the flash
    substrate, K1 (`flash_fwd`) runs 2 x n_layers times under "full"
    (the backward reruns each block) and n_layers under "attn" and
    "dots" (its outputs are kept)."""
    calls = _count_flash_fwd(monkeypatch)
    fn = FA.flash_attention if substrate == "flash" else attention
    attn_fn = partial(fn, causal=True)
    extra = dict(dropout=0.1, xent_chunk=40)
    if substrate == "plain":
        extra["attn_dropout"] = 0.1
    tok, tgt = batch(MODEL["vocab"], 4)
    out = {}
    for remat in (False, True):
        cfg = T.TransformerConfig(**MODEL, **extra, remat=remat,
                                  remat_policy=policy)
        calls[0] = 0
        out[remat] = _loss_and_grads(
            lambda p: T.loss(p, torch.from_numpy(tok),
                             torch.from_numpy(tgt), cfg, attn_fn=attn_fn,
                             dropout_key=D.fold_key(3, 0, 0)),
            T.init(cfg, 1, device="cpu"))
        if substrate == "flash":
            runs = 2 if remat and policy == "full" else 1
            assert calls[0] == runs * cfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(leaves(out[True][1]), leaves(out[False][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_jax_remat(policy):
    """The port's remat loss and gradients (flash substrate) against
    `jax.value_and_grad` of the JAX package's remat loss (its flash
    kernel in interpret mode), f32 bounds."""
    kw = dict(MODEL, remat=True, remat_policy=policy)
    jcfg = JT.TransformerConfig(**kw)
    params = JT.init(jcfg, seed=1)
    tok, tgt = batch(kw["vocab"], 5)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss(p, jnp.asarray(tok), jnp.asarray(tgt), jcfg,
                          attn_fn=partial(j_flash, causal=True))))(
        jtree(params))
    cfg = T.TransformerConfig(**kw)
    loss, grads = _loss_and_grads(
        lambda p: T.loss(p, torch.from_numpy(tok), torch.from_numpy(tgt),
                         cfg, attn_fn=partial(FA.flash_attention,
                                              causal=True)),
        params_from_numpy(params, "cpu"))
    assert abs(float(loss) - float(jl)) / abs(float(jl)) <= 1e-5
    assert worst(grads, jax.device_get(jg)) <= 1e-4


class _CountDense(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the 2-D dense products (aten.mm / addmm) that run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_remat_policy_decides_what_the_backward_recomputes(policy):
    """The backward's dense products: no remat and "dots" run only the
    gradients' (2 per forward product), "full" and "attn" also rerun
    each block's forward products but its last (`down`, whose output
    no gradient needs: the recompute stops once it has what the
    backward saved)."""
    cfg = T.TransformerConfig(**MODEL, remat=policy is not None,
                              remat_policy=policy or "full")
    tok, tgt = batch(cfg.vocab, 6)
    params = T.init(cfg, 1, device="cpu")
    flat = list(leaves(params))
    for p in flat:
        p.requires_grad_(True)
    fwd = _CountDense()
    with fwd:
        loss = T.loss(params, torch.from_numpy(tok), torch.from_numpy(tgt),
                      cfg, attn_fn=partial(FA.flash_attention, causal=True))
    bwd = _CountDense()
    with bwd:
        torch.autograd.grad(loss, flat, allow_unused=True)
    rerun = 5 * cfg.n_layers                # q, kv, proj, gate, up
    recomputed = rerun if policy in ("full", "attn") else 0
    assert bwd.n == 2 * fwd.n + recomputed


# --------------------------------------------------------------- dropout

@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_the_binomial_fraction_and_the_mean(rate):
    """Over 2^16 elements the kept fraction lies within 4 sigma of
    1 - rate, kept values are x / (1 - rate), dropped ones 0, so the
    mean stays x's (within 4 sigma of its own estimate)."""
    n = 1 << 16
    x = torch.full((n,), 2.0)
    y = D.dropout(x, rate, D.fold_key(1, 2, 3))
    keep = 1.0 - rate
    kept = (y != 0).float()
    sigma = (keep * rate / n) ** 0.5
    assert abs(float(kept.mean()) - keep) <= 4 * sigma
    assert torch.all((y == 0) | (y == 2.0 / keep))
    assert abs(float(y.mean()) - 2.0) <= 4 * 2.0 / keep * sigma


def test_dropout_masks_follow_their_keys():
    """Equal keys give equal masks; a change of seed, step, microbatch,
    layer or site gives another mask; no key (eval) is the identity and
    draws nothing."""
    shape = (64, 64)
    parts = (1, 2, 3, 4, 5)       # (seed, step, microbatch, layer, site)

    def mask(*p):
        return D.keep_mask(shape, 0.5, D.fold_key(*p), "cpu")

    ref = mask(*parts)
    assert torch.equal(ref, mask(*parts))
    for i in range(len(parts)):
        other = list(parts)
        other[i] += 1
        assert not torch.equal(ref, mask(*other))
    x = torch.randn(shape)
    state = torch.random.get_rng_state()
    assert D.dropout(x, 0.5, None) is x
    assert D.dropout(x, 0.0, 7) is x
    assert torch.equal(state, torch.random.get_rng_state())


def test_attention_dropout_drops_probabilities():
    """The plain attention's probability dropout: with uniform scores
    and V = one-hot positions, each output row is the kept
    probabilities / (1 - rate), so the kept fraction of the visible
    (causal) entries is binomial and the row sum's mean is 1; no key
    is the identity."""
    b, t, h, d = 2, 64, 4, 64
    q = torch.zeros(b, t, h, d)
    v = torch.eye(t)[None, :, None, :].expand(b, t, h, t).contiguous()
    rate = 0.25
    out = attention(q, q, v, causal=True, dropout=rate,
                    dropout_key=D.fold_key(9))
    plain = attention(q, q, v, causal=True)
    assert torch.equal(attention(q, q, v, causal=True, dropout=rate),
                       plain)
    visible = torch.tril(torch.ones(t, t)).bool()[None, :, None, :]
    visible = visible.expand(b, t, h, t)
    kept = (out[visible] != 0).float()
    n, keep = kept.numel(), 1.0 - rate
    assert abs(float(kept.mean()) - keep) <= 4 * (keep * rate / n) ** 0.5
    assert torch.allclose(out[visible][kept.bool()],
                          plain[visible][kept.bool()] / keep)
    assert not torch.any(out[~visible])
    row_sum = out.sum(-1)
    assert abs(float(row_sum.mean()) - 1.0) <= 0.05


@pytest.mark.parametrize("field", ["dropout", "attn_dropout"])
def test_dropout_acts_in_training_only(field):
    """With a key the loss moves; without one (eval) it equals the
    config without dropout; the engine's masks differ across steps and
    microbatches, and equal keys give equal losses."""
    plain_cfg = T.TransformerConfig(**MODEL)
    cfg = T.TransformerConfig(**MODEL, **{field: 0.3})
    params = T.init(cfg, 1, device="cpu")
    tok, tgt = (torch.from_numpy(a) for a in batch(cfg.vocab, 10))

    def loss(c, key=None, train=True):
        return float(T.loss(params, tok, tgt, c, dropout_key=key,
                            train=train))

    base = loss(plain_cfg)
    assert loss(cfg) == base                       # no key: no dropout
    assert loss(cfg, train=False) == loss(plain_cfg, train=False)
    keys = [D.fold_key(0, s, m) for s in range(2) for m in range(2)]
    losses = [loss(cfg, k) for k in keys]
    assert len(set(losses)) == 4 and base not in losses
    assert loss(cfg, keys[0]) == losses[0]
    eng = ContextParallelEngine(cfg, O.SGD(0.0), device="cpu",
                                attn="ring", accum=2)
    assert eng.dropout_key(0) != eng.dropout_key(1)
    k0 = eng.dropout_key(0)
    eng.train_batch(tok.numpy(), tgt.numpy())
    assert eng.dropout_key(0) != k0
    assert ContextParallelEngine(plain_cfg, O.SGD(0.0),
                                 device="cpu").dropout_key(0) is None


def test_attention_dropout_needs_the_plain_substrate():
    cfg = T.TransformerConfig(**MODEL, attn_dropout=0.1)
    with pytest.raises(ValueError, match="plain attention"):
        ContextParallelEngine(cfg, O.SGD(0.1), device="cpu", attn="flash")
    tok, tgt = (torch.from_numpy(a) for a in batch(cfg.vocab, 11))
    with pytest.raises(ValueError, match="plain attention"):
        T.loss(T.init(cfg, 0, device="cpu"), tok, tgt, cfg,
               attn_fn=partial(FA.flash_attention, causal=True),
               dropout_key=1)
