"""The port's transformer pieces (`shallowspeed_tpu_torch.models`)
against the JAX package's, on the same numpy inputs, in float32 on the
CPU. `init` must be bit-identical; every computed piece agrees to 1e-5
of max |ref| (the same arithmetic, summed in another order by another
library)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.models.generate import filter_logits as j_filter
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import filter_logits
from shallowspeed_tpu_torch.weights import params_from_numpy

TOL = 1e-5

CONFIGS = {
    "default": dict(vocab=96, d_model=32, n_heads=4, n_layers=2,
                    max_seq=64),
    "rope-rms-swiglu-gqa": dict(vocab=96, d_model=32, n_heads=4,
                                n_kv_heads=2, n_layers=2, max_seq=64,
                                rope=True, norm="rmsnorm", ffn="swiglu",
                                d_ff=48),
    "tied-window-softcap": dict(vocab=96, d_model=32, n_heads=4,
                                n_layers=2, max_seq=64, tie_embeddings=True,
                                attn_window=5, logit_softcap=3.0),
}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-6,
                                                float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_is_bit_identical(name):
    ref = JT.init(JT.TransformerConfig(**CONFIGS[name]), seed=3)
    got = T.init(T.TransformerConfig(**CONFIGS[name]), seed=3, device="cpu")
    ref_leaves, ref_tree = jax.tree_util.tree_flatten(ref)
    got_leaves, got_tree = jax.tree_util.tree_flatten(
        jax.tree_util.tree_map(lambda t: t.numpy(), got,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert got_tree == ref_tree
    for g, r in zip(got_leaves, ref_leaves):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_rope_rotate_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    pos = np.arange(5) + 37
    ref = JT.rope_rotate(jnp.asarray(x), jnp.asarray(pos), 500.0)
    got = T.rope_rotate(_t(x), _t(pos), 500.0)
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms_match(norm):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.normal(size=(2, 5, 32)) + 0.5).astype(np.float32)
    p = {"g": rng.normal(size=32).astype(np.float32),
         "b": rng.normal(size=32).astype(np.float32)}
    jfn = JT._rmsnorm if norm == "rmsnorm" else JT._layernorm
    tfn = T._rmsnorm if norm == "rmsnorm" else T._layernorm
    ref = jfn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tfn({k: _t(v) for k, v in p.items()}, _t(x))
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("ffn", ["gelu", "swiglu"])
def test_ffn_matches(ffn):
    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=1, max_seq=16,
              ffn=ffn)
    blk = JT.init(JT.TransformerConfig(**kw), seed=2)["blocks"][0]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    h = rng.normal(size=(2, 3, 32)).astype(np.float32)
    ref, _ = JT._ffn(jax.tree_util.tree_map(jnp.asarray, blk),
                     jnp.asarray(x), JT.TransformerConfig(**kw),
                     jnp.asarray(h))
    got, moe = T._ffn(params_from_numpy(blk, "cpu"), _t(x),
                      T.TransformerConfig(**kw), _t(h))
    assert moe == (0.0, 0.0, None)
    assert _rel(got.numpy(), ref) <= TOL


@pytest.mark.parametrize("top_k,top_p", [(0, 0.0), (5, 0.0), (0, 0.9),
                                         (7, 0.6)],
                         ids=["none", "top-k", "top-p", "both"])
def test_filter_logits_matches(top_k, top_p):
    rng = np.random.default_rng(top_k)
    logits = rng.normal(size=(3, 40)).astype(np.float32)
    ref = np.asarray(j_filter(jnp.asarray(logits), top_k, top_p))
    got = filter_logits(_t(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref))
    kept = ~np.isinf(ref)
    np.testing.assert_array_equal(got[kept], ref[kept])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches(name):
    jcfg = JT.TransformerConfig(**CONFIGS[name])
    params = JT.init(jcfg, seed=4)
    tokens = np.random.default_rng(4).integers(0, 96, (2, 11)).astype(
        np.int32)
    ref = JT.forward(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(tokens), jcfg)
    got = T.forward(params_from_numpy(params, "cpu"), _t(tokens).long(),
                    T.TransformerConfig(**CONFIGS[name]))
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= TOL


def test_cast_params_keeps_norms_in_master_dtype():
    cfg = T.TransformerConfig(**CONFIGS["default"],
                              compute_dtype=torch.bfloat16)
    cast = T.cast_params(T.init(cfg, device="cpu"), cfg.compute_dtype)
    blk = cast["blocks"][0]
    assert blk["ln1"]["g"].dtype == torch.float32
    assert cast["ln_f"]["b"].dtype == torch.float32
    assert blk["qkv"]["W"].dtype == torch.bfloat16
    assert cast["tok_emb"].dtype == torch.bfloat16


def test_unported_config_features_raise():
    # fp8_dense is ported (tests/test_torch_fp8.py): no longer refused
    assert T.TransformerConfig(fp8_dense=True).fp8_dense
    with pytest.raises(TypeError):
        T.TransformerConfig(compute_dtype=np.float16)
