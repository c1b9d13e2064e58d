"""The port's gradient accumulation and the 1.21B LM's training recipe
at a small size against the JAX package's `ContextParallelEngine` on a
(1, 1) CPU mesh, and Adafactor checkpoints across the packages. The
JAX flash kernel runs in Pallas interpret mode.

Tolerances: 3-step engine trajectories in f32, losses 1e-5 relative,
parameters 1e-5 absolute, optimizer moments and slots 1e-4 per leaf
(the bounds of `tests/test_torch_train.py`); checkpoints restore bit
for bit and continue within 1e-4, the bound of
`tests/test_torch_checkpoint.py`.
"""

import warnings

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from torch_parity import MODEL, batch, worst

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JaxEngine)
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine


# ------------------------------------------------ gradient accumulation

def _engines(kw, opt, accum, seed=5, attn="flash"):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    je = JaxEngine(JT.TransformerConfig(**kw), opt(JO), mesh, seed=seed,
                   attn="ring" if attn == "plain" else attn, accum=accum)
    te = ContextParallelEngine(T.TransformerConfig(**kw), opt(O), seed=seed,
                               attn="ring" if attn == "plain" else attn,
                               device="cpu", accum=accum)
    return je, te


def _trajectory(je, te, vocab, b=4, steps=3, slots=None):
    for step in range(steps):
        tok, tgt = batch(vocab, 20 + step, b=b)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-5
    assert worst(te.params, jax.device_get(je.params),
                  absolute=True) <= 1e-5
    jstate = jax.device_get(je.opt_state)
    assert te.opt_state["t"] == int(jstate["t"]) == steps
    for key in slots or ("m", "v"):
        assert worst(te.opt_state[key], jstate[key]) <= 1e-4


# AdamW divides each gradient element by its own RMS, so the f32 noise
# of an element that is 0 in exact arithmetic (the key bias's gradient:
# softmax ignores a shift shared by every key) becomes an update of
# +-lr with the noise's sign: on these batches AdamW's trajectory leaves
# the 1e-5 parameter bound at accum 1 as at 2 and 4 (1.2e-4 to 1.5e-3,
# measured), which says nothing of accumulation. The trajectories run
# Adafactor (factored moments on every matrix; measured 1.2e-7) and
# momentum instead.
ACCUM_OPTS = {
    "adafactor": (lambda M: M.Adafactor(1e-2, weight_decay=0.01,
                                        grad_clip=1.0), ("slots",)),
    "momentum": (lambda M: M.MomentumSGD(M.warmup_cosine(1e-2, 1, 3),
                                         momentum=0.9, grad_clip=1.0),
                 ("v",)),
}


@pytest.mark.parametrize("optname", list(ACCUM_OPTS))
@pytest.mark.parametrize("accum", [2, 4])
def test_accumulation_matches_jax_engine(accum, optname):
    """Three steps of B 4 in `accum` microbatches against the JAX
    engine with the same accum on a (1, 1) mesh."""
    opt, slots = ACCUM_OPTS[optname]
    je, te = _engines(MODEL, opt, accum)
    _trajectory(je, te, MODEL["vocab"], slots=slots)


def test_accumulation_equals_the_whole_batch():
    """accum 2's loss is the whole batch's mean (equal microbatches)
    and its gradients the whole batch's, to f32 summation order."""
    cfg = T.TransformerConfig(**MODEL)
    tok, tgt = batch(cfg.vocab, 8, b=4)
    out = [ContextParallelEngine(cfg, O.SGD(0.1), seed=2, device="cpu",
                                 accum=a).loss_and_grads(tok, tgt)
           for a in (1, 2)]
    assert abs(float(out[1][0]) - float(out[0][0])) <= 1e-6
    assert worst(out[1][1], out[0][1]) <= 1e-5


def test_accumulation_must_divide_the_rows():
    """Both packages refuse B 4 in 3 microbatches with the same
    message."""
    je, te = _engines(MODEL, lambda M: M.SGD(0.1), 3)
    tok, tgt = batch(MODEL["vocab"], 9, b=4)
    with pytest.raises(AssertionError, match=r"--accum 3 must divide") as j:
        je.train_batch(tok, tgt)
    with pytest.raises(ValueError, match=r"--accum 3 must divide") as t:
        te.train_batch(tok, tgt)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError):
        ContextParallelEngine(T.TransformerConfig(**MODEL), O.SGD(0.1),
                              device="cpu", accum=0)


# ------------------------------------------------------- the slice whole

RECIPES = {
    "adafactor-dots-chunk": (dict(remat=True, remat_policy="dots",
                                  xent_chunk=24), 1, "adafactor"),
    "adafactor-full-accum": (dict(remat=True, remat_policy="full"), 2,
                             "adafactor"),
    "momentum-attn-chunk-accum": (dict(remat=True, remat_policy="attn",
                                       xent_chunk=40, label_smoothing=0.1),
                                  2, "momentum"),
}


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_trajectory_matches_jax_engine(name):
    """The 1.21B LM's recipe at a small size (Adafactor, remat, chunked
    cross-entropy, flash attention) and its variants with accumulation
    and label smoothing: three steps against the JAX engine with the
    same config."""
    extra, accum, optname = RECIPES[name]
    kw = {**MODEL, **extra}
    opt, slots = ACCUM_OPTS[optname]
    je, te = _engines(kw, opt, accum)
    _trajectory(je, te, kw["vocab"], slots=slots)


# --------------------------------------------------------- checkpoints

CK = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          max_seq=16, rope=True, norm="rmsnorm", ffn="swiglu")


def _ck_batch(step):
    rng = np.random.default_rng([3, step])
    tok = rng.integers(0, CK["vocab"], (2, CK["max_seq"])).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1).astype(np.int32)


def _ck_engines(seed_j, seed_t):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    je = JaxEngine(JT.TransformerConfig(**CK),
                   JO.Adafactor(1e-2, beta1=0.9, weight_decay=0.01), mesh,
                   seed=seed_j, attn="ring")
    te = ContextParallelEngine(T.TransformerConfig(**CK),
                               O.Adafactor(1e-2, beta1=0.9,
                                           weight_decay=0.01),
                               seed=seed_t, attn="ring", device="cpu")
    return je, te


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_adafactor_checkpoint_crosses_packages(tmp_path, writer):
    """An Adafactor engine trained 2 steps and saved by one package
    restores into the other's engine (another seed) with the slots bit
    for bit in the reference's leaf order and `t` kept, without a
    re-initialization warning; both then take 2 more steps within
    1e-4."""
    je, te = _ck_engines(5 if writer == "jax" else 9,
                         5 if writer == "port" else 9)
    src, dst = (je, te) if writer == "jax" else (te, je)
    for s in range(2):
        src.train_batch(*_ck_batch(s))
    (JC if writer == "jax" else C).save(tmp_path, src, 1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert (C if writer == "jax" else JC).restore(
            dst, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    jstate = jax.device_get(je.opt_state)
    assert te.opt_state["t"] == int(jstate["t"]) == 2
    assert isinstance(te.opt_state["t"], int)
    assert worst(te.opt_state["slots"], jstate["slots"]) == 0.0
    assert worst(te.params, jax.device_get(je.params)) == 0.0
    for s in (2, 3):
        jl, tl = je.train_batch(*_ck_batch(s)), te.train_batch(*_ck_batch(s))
        assert abs(tl - jl) / abs(jl) <= 1e-4
