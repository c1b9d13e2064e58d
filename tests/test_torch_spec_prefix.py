"""Speculative decoding and the prefix cache of the port's serving engine
(`shallowspeed_tpu_torch.serving`), against the JAX package's, on the CPU.

The JAX engine runs as `tests/test_torch_serving.py` runs it: with
`paged_flash_decode` in Pallas interpret mode and its byte-count helper
`param_read_bytes` replaced (on the installed jax its import chain reads
the removed `jax.core.ClosedJaxpr`; the count feeds only log lines).
Greedy streams, the engines' spec and prefix counters, the request
records' spec and prefix fields and the allocators' snapshots at drain
must be equal. Sampled streams differ between the packages (threefry vs
`torch.Generator`), so they are compared within the port only.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import serve as jax_serve
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.serving import cache as JC
from shallowspeed_tpu.serving import engine as JE
from shallowspeed_tpu_torch import serve as port_serve
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.serving import cache as C
from shallowspeed_tpu_torch.serving.engine import ServingEngine
from shallowspeed_tpu_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent

CFG = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
           max_seq=128, rope=True)
COUNTERS = ("submitted", "finished", "preempted", "ticks", "prefill_chunks",
            "spec_drafted", "spec_accepted", "prefix_lookups", "prefix_hits",
            "prefix_skipped_tokens", "oom_events")
RECORD_FIELDS = ("id", "tokens_in", "tokens_out", "preempted",
                 "spec_drafted", "spec_accepted", "prefix_hit_blocks",
                 "prefill_skipped_tokens")


def toks(seed, t, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, t).astype(np.int32)


def motif(seed, t, period=5, vocab=64):
    """A prompt repeating a short random motif: the n-gram proposer
    drafts from it."""
    m = toks(seed, period, vocab)
    return np.concatenate([m] * (-(-t // period)))[:t]


def _engines(monkeypatch, seed=1, **kw):
    """The JAX engine and the port's on the CPU, same weights and flags."""
    monkeypatch.setattr(JE, "param_read_bytes", lambda params, cfg: 0)
    np_params = JT.init(JT.TransformerConfig(**CFG), seed=seed)
    jeng = JE.ServingEngine(jax.tree_util.tree_map(jnp.asarray, np_params),
                            JT.TransformerConfig(**CFG), attn_impl="flash",
                            **kw)
    eng = ServingEngine(params_from_numpy(np_params, "cpu"),
                        T.TransformerConfig(**CFG), attn_impl="flash",
                        device="cpu", **kw)
    return jeng, eng


def _records(eng):
    return {r["id"]: {k: r[k] for k in RECORD_FIELDS if k in r}
            for r in eng.request_records}


def _assert_same(jeng, eng, want, got):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert {k: eng.counters[k] for k in COUNTERS} == \
        {k: jeng.counters[k] for k in COUNTERS}
    assert _records(eng) == _records(jeng)
    assert eng.alloc.snapshot() == jeng.alloc.snapshot()
    assert eng.alloc.n_live == 0
    assert eng.alloc.n_free + eng.alloc.n_cold == eng.alloc.n_usable


def _spec_concurrent(eng):
    """Three motif requests, one joining after two steps."""
    eng.submit(motif(1, 20), 14, rid="a")
    eng.submit(motif(2, 27, period=7), 12, rid="b")
    for _ in range(2):
        eng.step()
    eng.submit(motif(3, 18, period=4), 16, rid="c")
    return eng.run()


def _prefix_hits(eng):
    """A donor, then a fully aligned hit (copy-on-write of the tail), a
    partial hit and a miss submitted together."""
    shared = toks(90, 24)                         # 3 aligned blocks of 8
    eng.submit(np.concatenate([shared, toks(91, 10)]), 6, rid="donor")
    eng.run()
    eng.submit(shared, 6, rid="full")
    eng.submit(np.concatenate([shared[:16], toks(92, 9)]), 6, rid="part")
    eng.submit(toks(93, 19), 6, rid="miss")
    return eng.run()


def _prefix_pressure(eng):
    """A donor parks 3 cold blocks; then three requests that need more
    blocks than are free force cold reclaims and evictions."""
    eng.submit(toks(94, 24), 4, rid="donor")
    eng.run()
    for i in range(3):
        eng.submit(np.concatenate([toks(94, 24)[:8], toks(100 + i, 12)]),
                   12, rid=f"p{i}")
    return eng.run()


def _spec_and_prefix(eng):
    """Motif prompts that share an aligned prefix, served with both."""
    shared = motif(5, 16)
    eng.submit(np.concatenate([shared, motif(6, 7, period=3)]), 10, rid="a")
    eng.run()
    eng.submit(shared, 12, rid="b")
    eng.submit(np.concatenate([shared, motif(7, 9, period=3)]), 10, rid="c")
    return eng.run()


SCENARIOS = {
    "spec2": (_spec_concurrent, dict(spec_k=2)),
    "spec4": (_spec_concurrent, dict(spec_k=4)),
    "spec4-evict": (_spec_concurrent, dict(spec_k=4, n_blocks=8)),
    "prefix-hits": (_prefix_hits, dict(prefix_cache=True)),
    "prefix-pressure": (_prefix_pressure, dict(prefix_cache=True,
                                               n_blocks=12)),
    "prefix-int8": (_prefix_hits, dict(prefix_cache=True,
                                       kv_quant="int8")),
    "spec-prefix-int8": (_spec_and_prefix, dict(spec_k=3, prefix_cache=True,
                                                kv_quant="int8")),
    "spec-prefix-w8": (_spec_and_prefix, dict(spec_k=2, prefix_cache=True,
                                              weight_quant="int8")),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_jax_engine(monkeypatch, name):
    """Greedy streams, counters, record fields and the allocator at drain
    equal the JAX engine's with the same flags (block 8, 6 slots, chunk
    8 unless the scenario shrinks the pool)."""
    drive, flags = SCENARIOS[name]
    kw = dict(block_size=8, max_slots=6, prefill_chunk=8, n_blocks=32)
    kw.update(flags)
    jeng, eng = _engines(monkeypatch, **kw)
    want = drive(jeng)
    got = drive(eng)
    _assert_same(jeng, eng, want, got)
    if kw.get("spec_k"):
        assert eng.counters["spec_drafted"] > 0
        assert eng.counters["spec_accepted"] > 0
    if kw.get("prefix_cache"):
        assert eng.counters["prefix_hits"] > 0
    if name == "prefix-hits":
        rec = _records(eng)
        assert rec["full"]["prefix_hit_blocks"] == 3
        assert rec["full"]["prefill_skipped_tokens"] == 23    # CoW: 1 left
        assert rec["part"]["prefix_hit_blocks"] == 2
        assert rec["part"]["prefill_skipped_tokens"] == 16
        assert rec["miss"]["prefix_hit_blocks"] == 0
    if name == "prefix-pressure":
        assert eng.alloc.cold_reclaims > 0
    if name == "spec4-evict":
        assert eng.counters["preempted"] > 0


@pytest.mark.parametrize("flags", [dict(spec_k=2), dict(spec_k=4),
                                   dict(prefix_cache=True)],
                         ids=["spec2", "spec4", "prefix"])
def test_sampled_streams_equal_the_feature_off(flags):
    """At temperature 0.8 (top-k 20, top-p 0.95), a stream with the
    feature on equals the same request's stream with it off: every token
    i draws from its request's (seed, i) generator, and an accepted
    draft or a cached prefix gives it the same logits."""
    cfg = T.TransformerConfig(**CFG)
    params = T.init(cfg, seed=4, device="cpu")

    def run(**kw):
        eng = ServingEngine(params, cfg, n_blocks=32, block_size=8,
                            max_slots=6, prefill_chunk=8, top_k=20,
                            top_p=0.95, device="cpu", **kw)
        shared = motif(8, 16)
        eng.submit(np.concatenate([shared, motif(9, 6, 3)]), 14,
                   temperature=0.8, seed=3, rid="a")
        eng.run()
        for i, p in enumerate((shared, np.concatenate([shared, toks(9, 5)]))):
            eng.submit(p, 14, temperature=0.8, seed=10 + i, rid=f"s{i}")
        return eng.run(), eng

    off, _ = run()
    on, eng = run(**flags)
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid], err_msg=rid)
    key = "spec_drafted" if "spec_k" in flags else "prefix_hits"
    assert eng.counters[key] > 0


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16-pools",
                                                        "int8-pools"])
def test_cow_leaves_the_shared_block_bit_unchanged(kv_quant):
    """A fully aligned hit copies the shared tail block (every leaf,
    int8 scale planes included) into a fresh block before its chunk
    writes, and re-prefills its last token there: every byte of the
    donor's indexed blocks is the same afterwards, and the copy holds
    the donor's tail."""
    cfg = T.TransformerConfig(**dict(CFG, compute_dtype=torch.bfloat16))
    eng = ServingEngine(T.init(cfg, seed=2, device="cpu"), cfg,
                        n_blocks=32, block_size=8, max_slots=4,
                        prefill_chunk=8, kv_quant=kv_quant,
                        prefix_cache=True, device="cpu")
    shared = toks(93, 16)                           # 2 aligned blocks
    eng.submit(shared, 4, rid="a")
    eng.run()
    matched = eng.prefix.match(shared)
    assert len(matched) == 2
    sel = torch.tensor(matched)
    before = [{n: leaf[sel].clone() for n, leaf in pool.items()}
              for pool in eng.pools]
    eng.submit(shared, 4, rid="b")
    eng.step()                                      # admit + the CoW chunk
    req = next(r for r in eng.slots if r is not None)
    copy = req.table[1]
    # b holds the shared head block; the tail's source reference went
    # with the copy, so the tail block is cold again
    assert req.table[0] == matched[0] and copy not in matched
    assert eng.alloc.refcount(matched[0]) == 1
    assert eng.alloc.refcount(matched[1]) == 0 and eng.alloc.n_cold == 1
    eng.run()
    assert np.array_equal(eng.results["a"], eng.results["b"])
    for pool, snap in zip(eng.pools, before):
        assert set(pool) == set(snap)
        for n, leaf in pool.items():
            assert torch.equal(leaf[sel], snap[n]), n
            # positions 0..6 of the copy are the donor's tail, copied
            assert torch.equal(leaf[copy][:, :7], snap[n][1][:, :7]), n


def test_chunk_hashes_are_byte_identical():
    for seed, t, bs in ((0, 37, 8), (1, 64, 16), (2, 5, 8), (3, 48, 1)):
        tokens = toks(seed, t, vocab=32768)
        assert C.chunk_hashes(tokens, bs) == JC.chunk_hashes(tokens, bs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_index_match_reference(seed):
    """The port's BlockAllocator + PrefixIndex against the reference's
    under one seeded random sequence of alloc, acquire, release, insert
    and match: the same ids, the same refusals, the same snapshots."""
    rng = np.random.default_rng(seed)
    pidx, jidx = C.PrefixIndex(4), JC.PrefixIndex(4)
    pal, jal = C.BlockAllocator(17, index=pidx), \
        JC.BlockAllocator(17, index=jidx)
    held: list[int] = []
    prompts = [toks(40 + i, 4 * int(rng.integers(1, 5)), vocab=8)
               for i in range(6)]
    for step in range(300):
        op = rng.choice(["alloc", "acquire", "release", "insert", "match"])
        if op == "alloc":
            n = int(rng.integers(0, 6))
            got = [None, None]
            for i, a in enumerate((pal, jal)):
                try:
                    got[i] = a.alloc(n)
                except (C.OutOfBlocks, JC.OutOfBlocks) as e:
                    got[i] = ("oob", e.requested, e.n_free, e.n_cold,
                              e.n_live)
            assert got[0] == got[1], step
            if isinstance(got[0], list):
                held += got[0]
        elif op == "acquire":
            pool = held + list(pal._cold)
            if pool:
                ids = [int(i) for i in rng.choice(pool, 2)]
                pal.acquire(ids)
                jal.acquire(ids)
                held += ids
        elif op == "release" and held:
            k = int(rng.integers(0, len(held)))
            ids = [held.pop(k)]
            pal.release(ids)
            jal.release(ids)
        elif op == "insert" and held:
            p = prompts[int(rng.integers(0, len(prompts)))]
            table = [int(i) for i in rng.choice(held, len(p) // 4)]
            assert pidx.insert(p, table) == jidx.insert(p, table)
        elif op == "match":
            p = prompts[int(rng.integers(0, len(prompts)))]
            assert pidx.match(p) == jidx.match(p)
        assert pal.snapshot() == jal.snapshot(), step
        assert pal.snapshot()["consistent"]
    with pytest.raises(ValueError):
        pal.release([0])
    with pytest.raises(ValueError):
        pal.acquire([10 ** 6])


def test_driver_matches_reference_engine_with_prefix_and_spec(tmp_path,
                                                              monkeypatch):
    """`serve --device cpu --prefix-cache on --spec-k 2` prints the
    reference engine's result tokens for the same requests and flags,
    and its summary carries the reference's spec counters and
    `blocks_free_at_drain` (n_free / n_usable, cold blocks not free)."""
    shared = motif(11, 32).tolist()
    lines = [{"id": "a", "prompt": shared + [1, 2, 3], "max_new": 10},
             {"id": "b", "prompt": motif(12, 21).tolist(), "max_new": 12},
             {"id": "c", "prompt_len": 30, "prompt_seed": 3, "max_new": 8},
             {"id": "d", "prompt": shared, "max_new": 9},
             {"id": "e", "prompt": shared[:16] + [7] * 9, "max_new": 11}]
    reqs = tmp_path / "reqs.jsonl"
    reqs.write_text("".join(json.dumps(r) + "\n" for r in lines))
    flags = ["--vocab", "64", "--d-model", "32", "--n-heads", "4",
             "--n-layers", "2", "--max-seq", "128", "--rope",
             "--n-blocks", "24", "--slots", "3", "--prefill-chunk", "16",
             "--init-seed", "3", "--prefix-cache", "on", "--spec-k", "2",
             "--requests", str(reqs)]
    r = subprocess.run([sys.executable, "-m", "shallowspeed_tpu_torch.serve",
                        "--device", "cpu", *flags], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = [json.loads(l) for l in r.stdout.splitlines() if l.strip()]
    got = {o["id"]: o["tokens"] for o in out if o["event"] == "result"}
    summary = out[-1]
    assert summary["event"] == "summary"

    args = jax_serve.parse_args(flags + ["--attn-impl", "flash"])
    jcfg = JT.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.max_seq, rope=args.rope)
    monkeypatch.setattr(JE, "param_read_bytes", lambda params, cfg: 0)
    jeng = JE.ServingEngine(
        jax.device_put(JT.init(jcfg, seed=args.init_seed)), jcfg,
        n_blocks=args.n_blocks, block_size=args.block_size,
        max_slots=args.slots, prefill_chunk=args.prefill_chunk,
        table_bucket=args.table_bucket, attn_impl="flash",
        spec_k=args.spec_k, spec_ngram=args.spec_ngram,
        prefix_cache=args.prefix_cache == "on")
    for q in jax_serve.load_requests(args.requests, jcfg.vocab):
        jeng.submit(q["prompt"], q["max_new"], rid=q["id"])
    want = {k: v.tolist() for k, v in jeng.run().items()}
    assert got == want
    assert jeng.counters["prefix_hits"] > 0
    assert jeng.counters["spec_drafted"] > 0
    for key in ("spec_drafted", "spec_accepted"):
        assert summary[key] == jeng.counters[key]
    assert summary["blocks_free_at_drain"] == \
        f"{jeng.alloc.n_free}/{jeng.alloc.n_usable}"


def test_driver_flags_default_as_the_root_driver():
    """The same command line runs the same engine in both drivers: the
    prefix cache defaults to on, speculation to off with 3-grams."""
    args, ref = port_serve.parse_args([]), jax_serve.parse_args([])
    for key in ("prefix_cache", "spec_k", "spec_ngram"):
        assert getattr(args, key) == getattr(ref, key), key
    assert args.prefix_cache == "on"
