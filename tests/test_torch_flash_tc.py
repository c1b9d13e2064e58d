"""The rule the tensor-core (bf16) builds of K1, K2 and K3 are held to on
the card (`flash_attention.kernel_ratio` with `tc_rounding_terms`),
checked on the CPU where no kernel runs: those kernels round P (for o
and dV) and dS (for dQ and dK) to bf16 once before the second product,
which the plain
versions and the JAX kernels keep in f32. The rule must accept the plain
arithmetic with that one bf16 rounding (`rounded_reference`), accept
the exact plain output, and reject the same arithmetic with a float8
(e4m3) rounding. The plain versions themselves are held against the
JAX package's Pallas chunk kernels (interpret mode) at these head dims
and lengths, in float32 (max |diff| / max |ref|: 1e-5 forward, 1e-4
backward, as in test_torch_flash_attention.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu.ops import flash_attention as JFA
from shallowspeed_tpu_torch.ops import flash_attention as FA

FWD_TOL = 1e-5
GRAD_TOL = 1e-4

# (B, T, H, Hkv, D, causal, window, rel): MHA and GQA at head_dim 64 and
# 128, a window, a diagonal offset, a ragged length and a full mask
CASES = {
    "mha-64": (2, 64, 4, 4, 64, True, 0, 0),
    "gqa-128": (2, 128, 4, 2, 128, True, 0, 0),
    "window-64": (1, 128, 4, 4, 64, True, 40, 0),
    "rel-gqa-128": (1, 96, 4, 2, 128, True, 0, 32),
    "ragged-200": (2, 200, 4, 4, 128, True, 0, 0),
    "full-gqa-64": (1, 80, 4, 2, 64, False, 0, 0),
}


def _inputs(case, dtype=torch.bfloat16, seed=0):
    b, t, h, hkv, d, causal, window, rel = CASES[case]
    rng = np.random.default_rng(seed + d + t)

    def rnd(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).to(dtype)

    q, do = rnd(b, t, h, d), rnd(b, t, h, d)
    k, v = rnd(b, t, hkv, d), rnd(b, t, hkv, d)
    return q, k, v, do, dict(causal=causal, window=window, rel=rel)


def _plain(q, k, v, do, kw):
    """The plain versions' o, dK, dV (f32 sums), the lse and delta the
    backward reads, and the rule's rounding terms."""
    o, lse = FA.flash_fwd_reference(q, k, v, **kw)
    delta = FA.attention_delta(do, o)
    dk, dv = FA.flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    terms = FA.tc_rounding_terms(q, k, v, do, lse, delta, **kw)
    return (o, dk, dv), lse, delta, terms


def _ratios(got, ref, terms):
    """Worst element / allowance of (o, dK, dV) under the tensor-core
    rule; o is a bf16 output."""
    return (FA.kernel_ratio(got[0], ref[0], rounded=True,
                            extra=terms["o"])[1],
            FA.kernel_ratio(got[1], ref[1], extra=terms["dk"])[1],
            FA.kernel_ratio(got[2], ref[2], extra=terms["dv"])[1])


@pytest.mark.parametrize("case", list(CASES))
def test_rule_accepts_a_bf16_rounding_of_p_and_ds(case):
    """What the tensor-core kernels compute (up to summation order),
    the plain arithmetic with P and dS rounded to bf16 before the second
    product, lies within the rule on every output."""
    q, k, v, do, kw = _inputs(case)
    ref, lse, delta, terms = _plain(q, k, v, do, kw)
    o, _, dk, dv = FA.rounded_reference(q, k, v, do, lse, delta,
                                        torch.bfloat16, **kw)
    assert max(_ratios((o, dk, dv), ref, terms)) <= 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_rule_rejects_an_e4m3_rounding_of_p_and_ds(case):
    """A coarser rounding of the same operands (float8 e4m3, 3 mantissa
    bits) breaks the rule on o and on dK: the rounding term is not
    loose."""
    q, k, v, do, kw = _inputs(case)
    ref, lse, delta, terms = _plain(q, k, v, do, kw)
    o, _, dk, dv = FA.rounded_reference(q, k, v, do, lse, delta,
                                        torch.float8_e4m3fn, **kw)
    r_o, r_dk, _ = _ratios((o, dk, dv), ref, terms)
    assert r_o > 1.0 and r_dk > 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_rule_accepts_the_exact_plain_output(case):
    """The plain arithmetic in float64 on the same bf16 values (o
    rounded to bf16 as the kernel's is) lies within the rule, and within
    the f32 rule without the rounding term: summing in another order
    is allowed for."""
    q, k, v, do, kw = _inputs(case)
    ref, lse, delta, terms = _plain(q, k, v, do, kw)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    o64, _ = FA.flash_fwd_reference(q64, k64, v64, **kw)
    dk64, dv64 = FA.flash_dkv_reference(q64, k64, v64, do64, lse.double(),
                                        delta.double(), **kw)
    exact = (o64.to(torch.bfloat16), dk64.float(), dv64.float())
    assert max(_ratios(exact, ref, terms)) <= 1.0
    assert FA.kernel_ratio(exact[1], ref[1])[1] <= 1.0
    assert FA.kernel_ratio(exact[2], ref[2])[1] <= 1.0


def _dq_case(case):
    """A case's inputs, the plain dQ, lse, delta and the dq term."""
    q, k, v, do, kw = _inputs(case)
    o, lse = FA.flash_fwd_reference(q, k, v, **kw)
    delta = FA.attention_delta(do, o)
    dq = FA.flash_dq_reference(q, k, v, do, lse, delta, **kw)
    term = FA.tc_rounding_terms(q, k, v, do, lse, delta, **kw)["dq"]
    return (q, k, v, do, lse, delta, kw), dq, term


@pytest.mark.parametrize("case", list(CASES))
def test_dq_rule_accepts_a_bf16_rounding_of_ds(case):
    """K2's tensor-core build rounds dS to bf16 before dQ = dS K: the
    plain dQ with that one rounding lies within the rule with the dq
    term."""
    args, ref, term = _dq_case(case)
    _, got, _, _ = FA.rounded_reference(*args[:6], torch.bfloat16, **args[6])
    assert FA.kernel_ratio(got, ref, extra=term)[1] <= 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_dq_rule_rejects_an_e4m3_rounding_of_ds(case):
    """dS rounded to float8 e4m3 before dQ = dS K breaks the rule: the
    dq term is not loose."""
    args, ref, term = _dq_case(case)
    _, got, _, _ = FA.rounded_reference(*args[:6], torch.float8_e4m3fn,
                                        **args[6])
    assert FA.kernel_ratio(got, ref, extra=term)[1] > 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_dq_rule_accepts_the_exact_plain_dq(case):
    """The plain dQ in float64 on the same bf16 values lies within the
    rule with the dq term, and within the f32 rule without it."""
    (q, k, v, do, lse, delta, kw), ref, term = _dq_case(case)
    exact = FA.flash_dq_reference(*(x.double() for x in (q, k, v, do, lse,
                                                          delta)), **kw)
    assert FA.kernel_ratio(exact.float(), ref, extra=term)[1] <= 1.0
    assert FA.kernel_ratio(exact.float(), ref)[1] <= 1.0


@pytest.mark.parametrize("case", ["gqa-128", "window-64", "full-gqa-64"])
def test_rounded_reference_without_rounding_is_the_plain_versions(case):
    """`rounded_reference` at p_dtype None returns the plain versions'
    o, dQ, dK and dV exactly."""
    (q, k, v, do, lse, delta, kw), dq, _ = _dq_case(case)
    got = FA.rounded_reference(q, k, v, do, lse, delta, None, **kw)
    o, _ = FA.flash_fwd_reference(q, k, v, **kw)
    dk, dv = FA.flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    for a, b in zip(got, (o, dq, dk, dv)):
        assert torch.equal(a, b)


def test_rounded_reference_dq_matches_jax_chunk_dq():
    """`rounded_reference`'s dQ at p_dtype None against the JAX
    `_chunk_dq` in interpret mode (GQA, hd 128, rel != 0, f32), on the
    JAX forward's lse."""
    q, k, v, do, kw = _inputs("rel-gqa-128", torch.float32, seed=2)
    ref = _jax_chunks(*(x.numpy() for x in (q, k, v, do)), kw["causal"],
                      kw["window"], kw["rel"], 32)
    jlse = torch.from_numpy(ref["lse"].copy())
    o, _ = FA.flash_fwd_reference(q, k, v, **kw)
    delta = FA.attention_delta(do, o)
    _, dq, _, _ = FA.rounded_reference(q, k, v, do, jlse, delta, None, **kw)
    assert _rel(dq, ref["dq"]) <= GRAD_TOL


def test_rounding_terms_bound_each_output_by_its_own_magnitudes():
    """The terms are 2^-8 of the plain arithmetic over magnitudes: at
    least 2^-8 |o| and 2^-8 |dV| element by element (the triangle
    inequality), zero where nothing is seen, and summed over the group
    like dK and dV."""
    q, k, v, do, kw = _inputs("gqa-128", torch.float32)
    (o, dk, dv), _, _, terms = _plain(q, k, v, do, kw)
    assert terms["o"].shape == o.shape
    assert terms["dk"].shape == terms["dv"].shape == dk.shape
    dq = FA.flash_dq_reference(q, k, v, do, *FA.flash_fwd_reference(
        q, k, v, **kw)[1:], FA.attention_delta(do, o), **kw)
    assert terms["dq"].shape == q.shape
    for name, out in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        assert (terms[name] >= FA.BF16_ROUND * out.abs() - 1e-6).all(), name


@pytest.mark.parametrize("case", ["gqa-128", "ragged-200"])
def test_bf16_cpu_tensors_take_the_plain_versions(case):
    """bf16 tensors on the CPU go to the plain versions and launch
    nothing, the tensor-core launchers included."""
    q, k, v, do, kw = _inputs(case)
    counters = (FA.flash_fwd, FA._flash_fwd_tc, FA.flash_dq,
                FA._flash_dq_tc, FA.flash_dkv, FA._flash_dkv_tc)
    before = [c.launches for c in counters]
    o, lse = FA.flash_fwd(q, k, v, **kw)
    delta = FA.attention_delta(do, o)
    dq = FA.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(dq, FA.flash_dq_reference(q, k, v, do, lse, delta,
                                                 **kw))
    ref_o, ref_lse = FA.flash_fwd_reference(q, k, v, **kw)
    ref_dk, ref_dv = FA.flash_dkv_reference(q, k, v, do, lse, delta, **kw)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert torch.equal(dk, ref_dk) and torch.equal(dv, ref_dv)
    assert [c.launches for c in counters] == before


def _jax_chunks(q, k, v, do, causal, window, rel, block):
    """The JAX chunk kernels (interpret mode) in their folded layout,
    unfolded back to (B, T, H, D) / (B, H, T)."""
    b, t, h, _ = q.shape
    kvh = k.shape[2]
    q3 = JFA._fold_q(jnp.asarray(q), kvh)
    k3, v3 = JFA._to_bhsd(jnp.asarray(k)), JFA._to_bhsd(jnp.asarray(v))
    do3 = JFA._fold_q(jnp.asarray(do), kvh)
    kw = dict(causal=causal, window=window, bq=block, bk=block,
              nqb_chunk=t // block, interpret=True)
    o3, lse3 = JFA._chunk_fwd(q3, k3, v3, rel, **kw)
    delta3 = JFA._delta_of(do3, o3, lse3)
    dq3 = JFA._chunk_dq(q3, k3, v3, do3, lse3, delta3, rel, **kw)
    dk3, dv3 = JFA._chunk_dkv(q3, k3, v3, do3, lse3, delta3, rel,
                              groups=h // kvh, **kw)
    return {"o": np.asarray(JFA._unfold_q(o3, b, h)),
            "lse": np.asarray(lse3[..., 0]).reshape(b, h, t),
            "dq": np.asarray(JFA._unfold_q(dq3, b, h)),
            "dk": np.asarray(JFA._from_bhsd(dk3, b, kvh)),
            "dv": np.asarray(JFA._from_bhsd(dv3, b, kvh))}


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max()) / max(1e-6,
                                                float(np.abs(ref).max()))


@pytest.mark.parametrize("case,block", [("mha-64", 16), ("gqa-128", 32),
                                        ("window-64", 32),
                                        ("rel-gqa-128", 32),
                                        ("ragged-200", 40)])
def test_plain_versions_match_jax_chunk_kernels(case, block):
    """K1, K2, K3's plain versions against the Pallas chunk kernels at
    head_dim 64 and 128, GQA, a window, rel != 0 and T = 200, in f32;
    the backward reads the JAX forward's lse, so each kernel is compared
    on exactly its own inputs."""
    q, k, v, do, kw = _inputs(case, torch.float32, seed=1)
    ref = _jax_chunks(*(x.numpy() for x in (q, k, v, do)), kw["causal"],
                      kw["window"], kw["rel"], block)
    o, lse = FA.flash_fwd_reference(q, k, v, **kw)
    assert _rel(o, ref["o"]) <= FWD_TOL
    assert _rel(lse, ref["lse"]) <= FWD_TOL
    jlse = torch.from_numpy(ref["lse"].copy())
    delta = FA.attention_delta(do, o)
    dq = FA.flash_dq_reference(q, k, v, do, jlse, delta, **kw)
    dk, dv = FA.flash_dkv_reference(q, k, v, do, jlse, delta, **kw)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        assert _rel(got, ref[name]) <= GRAD_TOL, name
