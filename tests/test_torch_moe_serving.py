"""The port's serving engine on an MoE model against the JAX package's,
on the CPU: greedy streams must be equal.

An MoE FFN routes a prefill chunk as one group, whose expert capacity
and slot order count every row of the chunk. The reference pads each
chunk to the engine's `prefill_chunk` rows (token 0, its K/V writes
steered to the scratch block), so the port pads an MoE model's chunks
the same way (`serving.engine.prefill_chunk`). The shape is the one
that showed the difference: capacity factor 1.0 (tight), a chunk of 16
over prompts of 20-29 tokens, under both routings, with the prefix
cache and speculative decoding on as well. The JAX engine runs as
`tests/test_torch_spec_prefix.py` runs it (its byte-count helper
`param_read_bytes` replaced).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.serving import engine as JE
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.serving.engine import ServingEngine
from shallowspeed_tpu_torch.weights import params_from_numpy

CFG = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, max_seq=128,
           rope=True, n_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
ENGINE = dict(block_size=8, max_slots=3, prefill_chunk=16, n_blocks=14)


def _streams(eng):
    rng = np.random.default_rng(3)
    for i, n in enumerate((20, 23, 26, 29)):
        eng.submit(rng.integers(0, 64, n).astype(np.int32), 10, rid=f"r{i}")
    return eng.run()


@pytest.mark.parametrize("flags", [{}, dict(prefix_cache=True),
                                   dict(spec_k=2)],
                         ids=["plain", "prefix", "spec2"])
@pytest.mark.parametrize("routing", ["sequence", "priority"])
def test_moe_streams_equal_the_jax_engine(monkeypatch, routing, flags):
    monkeypatch.setattr(JE, "param_read_bytes", lambda params, cfg: 0)
    cfg = dict(CFG, moe_routing=routing)
    np_params = JT.init(JT.TransformerConfig(**cfg), seed=1)
    kw = dict(ENGINE, **flags)
    jeng = JE.ServingEngine(jax.tree_util.tree_map(jnp.asarray, np_params),
                            JT.TransformerConfig(**cfg), **kw)
    eng = ServingEngine(params_from_numpy(np_params, "cpu"),
                        T.TransformerConfig(**cfg), device="cpu", **kw)
    want, got = _streams(jeng), _streams(eng)
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert eng.counters["prefill_chunks"] == jeng.counters["prefill_chunks"]
