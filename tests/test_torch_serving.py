"""The port's serving slice (`shallowspeed_tpu_torch.serving`, the
`serve` driver) against the JAX package's, on the CPU.

The JAX side runs as its own tests run it: on the CPU, with
`paged_flash_decode` in Pallas interpret mode. One shim is needed for
the installed jax: the reference engine's constructor prices its
parameter bytes through `analysis.walker`, whose import reads
`jax.core.ClosedJaxpr`, which jax 0.9 removed. The byte count feeds
only the engine's log lines, so the tests replace that one function
(`param_read_bytes`) for the JAX engine they build; nothing in the JAX
package changes. The root `serve.py` imports the same module chain in
`main`, so the driver test runs the reference engine in-process the
way `serve.main` builds it, from `serve.load_requests`.
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
from shallowspeed_tpu.models.generate import (decode_step, init_kv_cache,
                                              prefill)
from shallowspeed_tpu.serving import engine as JE
from shallowspeed_tpu_torch import NotPorted, resolve_device
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.serving.cache import init_block_pool
from shallowspeed_tpu_torch.serving.engine import (ServingEngine,
                                                   decode_logits,
                                                   prefill_chunk,
                                                   table_width)
from shallowspeed_tpu_torch.weights import (leaves, params_from_numpy,
                                            params_to_numpy)

ROOT = Path(__file__).resolve().parent.parent

SLICE_CFG = dict(vocab=128, d_model=64, n_heads=4, n_layers=2, max_seq=128,
                 rope=True, norm="rmsnorm", ffn="swiglu")
STREAM_CFG = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                  n_layers=2, max_seq=128, rope=True)


def _jax_engine(monkeypatch, params, cfg, **kw):
    monkeypatch.setattr(JE, "param_read_bytes", lambda params, cfg: 0)
    return JE.ServingEngine(params, cfg, attn_impl="flash", **kw)


def toks(seed, t, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, t).astype(np.int32)


def test_slice_logits_match_jax_prefill_and_decode():
    """Chunked paged prefill (3 chunks) + 8 paged decode steps through
    the port's engine functions, against the JAX contiguous `prefill` +
    `decode_step` on the same weights, feeding both the same tokens.
    Tolerance 1e-4 of max |logit|: the same f32 math, but the paged path
    sums over the block table and chunks where the reference sums over
    one contiguous cache, so the f32 sums run in another order through
    two layers."""
    jcfg = JT.TransformerConfig(**SLICE_CFG)
    cfg = T.TransformerConfig(**SLICE_CFG)
    np_params = JT.init(jcfg, seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    prompt = toks(5, 21, vocab=128)
    n_new, chunk, bs = 8, 8, 8

    ref, cache = prefill(jparams, jnp.asarray(prompt[None]), jcfg,
                         init_kv_cache(jcfg, 1, cache_len=64))
    refs = [np.asarray(ref[0])]
    feed = []
    for i in range(n_new):
        tok = int(np.argmax(refs[-1]))
        feed.append(tok)
        ref, cache = decode_step(jparams, jnp.asarray([tok], jnp.int32),
                                 len(prompt) + i, cache, jcfg)
        refs.append(np.asarray(ref[0]))

    n_blk = -(-(len(prompt) + n_new) // bs)
    pools = init_block_pool(cfg, n_blk + 1, bs, device="cpu")
    bt = np.zeros((1, table_width(n_blk, 4)), np.int32)
    bt[0, :n_blk] = np.arange(n_blk, 0, -1)        # out of order on purpose
    bt = torch.from_numpy(bt)
    for s in range(0, len(prompt), chunk):
        got = prefill_chunk(params, pools, torch.from_numpy(
            prompt[s:s + chunk]), s, bt, cfg=cfg)
    gots = [got.numpy()]
    for i, tok in enumerate(feed):
        got = decode_logits(params, pools, torch.tensor([tok], dtype=torch.int32),
                            torch.tensor([len(prompt) + i], dtype=torch.int32),
                            bt, cfg=cfg, attn="flash")
        gots.append(got[0].numpy())
    for step, (g, r) in enumerate(zip(gots, refs)):
        rel = np.abs(g - r).max() / np.abs(r).max()
        assert rel <= 1e-4, (step, rel)


def test_greedy_streams_match_jax_engine_with_eviction(monkeypatch):
    """More requests than slots, one joining between ticks, and a pool
    too small for every running request: the evict-newest policy must
    fire, and every greedy stream must equal the JAX engine's. The
    allocator is balanced at drain."""
    jcfg = JT.TransformerConfig(**STREAM_CFG)
    cfg = T.TransformerConfig(**STREAM_CFG)
    np_params = JT.init(jcfg, seed=1)
    reqs = {f"q{i}": (toks(50 + i, 20 + 3 * i), 14) for i in range(4)}
    late = ("late", toks(99, 17), 10)
    kw = dict(n_blocks=14, block_size=8, max_slots=3, prefill_chunk=16)

    def drive(eng):
        for rid, (p, mn) in reqs.items():
            eng.submit(p, mn, rid=rid)
        for _ in range(3):
            eng.step()
        eng.submit(late[1], late[2], rid=late[0])
        return eng.run()

    jeng = _jax_engine(monkeypatch, jax.tree_util.tree_map(
        jnp.asarray, np_params), jcfg, **kw)
    want = drive(jeng)
    eng = ServingEngine(params_from_numpy(np_params, "cpu"), cfg,
                        attn_impl="flash", device="cpu", **kw)
    got = drive(eng)
    assert eng.counters["preempted"] >= 1
    assert eng.counters["preempted"] == jeng.counters["preempted"]
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert eng.alloc.n_free == eng.alloc.n_usable and eng.alloc.n_live == 0
    assert [r["id"] for r in eng.request_records] == \
        [r["id"] for r in jeng.request_records]


def test_sampled_streams_survive_eviction():
    """Sampled token i of a request draws from a generator seeded by
    (seed, i) alone, so a stream is the same served alone, served
    concurrently, or evicted and re-admitted mid-stream."""
    cfg = T.TransformerConfig(**STREAM_CFG)
    params = T.init(cfg, seed=2, device="cpu")
    reqs = {f"s{i}": (toks(70 + i, 24), 16, 0.9, 11 + i) for i in range(3)}

    def run(n_blocks, only=None):
        eng = ServingEngine(params, cfg, n_blocks=n_blocks, block_size=8,
                            max_slots=4, prefill_chunk=16, top_k=20,
                            top_p=0.95, device="cpu")
        for rid, (p, mn, temp, seed) in reqs.items():
            if only is None or rid == only:
                eng.submit(p, mn, temperature=temp, seed=seed, rid=rid)
        return eng.run(), eng.counters["preempted"]

    roomy, n0 = run(64)
    tight, n1 = run(14)
    assert n0 == 0 and n1 >= 1
    for rid in reqs:
        solo, _ = run(64, only=rid)
        np.testing.assert_array_equal(tight[rid], roomy[rid], err_msg=rid)
        np.testing.assert_array_equal(solo[rid], roomy[rid], err_msg=rid)


def test_entry_points_raise_without_cuda(monkeypatch):
    """No silent CPU: with CUDA hidden, every entry point that is not
    told device='cpu' raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = T.TransformerConfig(**STREAM_CFG)
    params = T.init(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("kw", [{"kv_quant": "int4"},
                                {"weight_quant": "int4"}],
                         ids=["kv-int4", "weight-int4"])
def test_unknown_quant_modes_raise(kw):
    """An unknown quantization mode is a ValueError naming the modes, as
    in the reference (`init_block_pool`, `quantize_weights`)."""
    cfg = T.TransformerConfig(**STREAM_CFG)
    with pytest.raises(ValueError, match="int4"):
        ServingEngine(T.init(cfg, device="cpu"), cfg, device="cpu", **kw)


def test_params_on_another_device_are_refused():
    cfg = T.TransformerConfig(**STREAM_CFG)
    params = T.init(cfg, device="cpu")
    params["tok_emb"] = params["tok_emb"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(params, cfg, device="cpu")


def test_driver_results_match_reference_engine(tmp_path, monkeypatch):
    """`python -m shallowspeed_tpu_torch.serve --device cpu` prints the
    same result token lists as the reference serving path given the
    same flags (prefix cache off, the flash decode kernel), and ends
    with a summary line showing a balanced allocator. The prefix cache
    is on by default in both drivers; tests/test_torch_spec_prefix.py
    holds the serve driver with it on."""
    reqs = tmp_path / "reqs.jsonl"
    lines = [{"id": "a", "prompt_len": 20, "prompt_seed": 1, "max_new": 8},
             {"id": "b", "prompt_len": 45, "prompt_seed": 2, "max_new": 12},
             {"id": "c", "prompt": [3, 9, 27, 81, 5], "max_new": 10},
             {"id": "d", "prompt_len": 33, "prompt_seed": 4, "max_new": 9},
             {"id": "e", "prompt_len": 70, "prompt_seed": 5, "max_new": 6}]
    reqs.write_text("".join(json.dumps(r) + "\n" for r in lines))
    flags = ["--vocab", "128", "--d-model", "32", "--n-heads", "4",
             "--n-layers", "2", "--max-seq", "128", "--rope",
             "--n-blocks", "12", "--slots", "3", "--prefill-chunk", "16",
             "--init-seed", "3", "--prefix-cache", "off",
             "--requests", str(reqs)]
    r = subprocess.run([sys.executable, "-m", "shallowspeed_tpu_torch.serve",
                        "--device", "cpu", *flags], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    out = [json.loads(l) for l in r.stdout.splitlines() if l.strip()]
    got = {o["id"]: o["tokens"] for o in out if o["event"] == "result"}
    summary = out[-1]
    assert summary["event"] == "summary"
    assert summary["blocks_free_at_drain"] == "11/11"

    args = jax_serve.parse_args(flags + ["--attn-impl", "flash"])
    jcfg = JT.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.max_seq, rope=args.rope)
    jeng = _jax_engine(
        monkeypatch, jax.device_put(JT.init(jcfg, seed=args.init_seed)),
        jcfg, n_blocks=args.n_blocks, block_size=args.block_size,
        max_slots=args.slots, prefill_chunk=args.prefill_chunk,
        table_bucket=args.table_bucket)
    for q in jax_serve.load_requests(args.requests, jcfg.vocab):
        jeng.submit(q["prompt"], q["max_new"], rid=q["id"])
    want = {k: v.tolist() for k, v in jeng.run().items()}
    assert got == want


def test_driver_refuses_unported_flags(tmp_path):
    """--serve is not ported yet; --ckpt is: it loads a verified
    checkpoint whose parameters match the model flags, and refuses a
    missing, corrupt or mismatched one."""
    from shallowspeed_tpu_torch import checkpoint, serve

    empty = tmp_path / "none.jsonl"
    empty.write_text("")
    with pytest.raises(NotPorted):
        serve.main(["--device", "cpu", "--requests", str(empty), "--serve"])
    with pytest.raises(checkpoint.CheckpointError):
        serve.main(["--device", "cpu", "--requests", str(empty), "--ckpt",
                    str(tmp_path / "somewhere")])
    cfg = T.TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                              max_seq=512)
    params = T.init(cfg, seed=4, device="cpu")
    checkpoint._write_ckpt(tmp_path, 0, params_to_numpy(params), (),
                           {"epoch": 0}, {})
    got = serve.load_ckpt_params(tmp_path / "ckpt_0", cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(got),
                                                 leaves(params)))
    with pytest.raises(ValueError, match="model config"):
        serve.main(["--device", "cpu", "--requests", str(empty), "--ckpt",
                    str(tmp_path / "ckpt_0"), "--n-layers", "3"])
    (tmp_path / "ckpt_0" / "params.npz").write_bytes(b"rot")
    with pytest.raises(checkpoint.CheckpointError):
        serve.load_ckpt_params(tmp_path / "ckpt_0", cfg, "cpu")


def test_allocator_matches_reference_and_keeps_invariants():
    """The port's allocator hands out the same ids in the same order as
    the reference's (LIFO free list, scratch never issued), refuses
    over-allocation without leaking and double frees, and balances."""
    from shallowspeed_tpu.serving.cache import BlockAllocator as JAlloc
    from shallowspeed_tpu_torch.serving.cache import (BlockAllocator,
                                                      OutOfBlocks)

    a, ref = BlockAllocator(8), JAlloc(8)
    assert a.n_usable == 7 and a.n_free == 7
    got = a.alloc(3)
    assert got == ref.alloc(3) and 0 not in got
    assert a.n_free == 4 and a.n_live == 3
    with pytest.raises(OutOfBlocks):
        a.alloc(5)
    assert a.n_free == 4
    with pytest.raises(ValueError):
        a.release([99])
    with pytest.raises(ValueError):
        a.release([got[0], got[0]])
    a.release(got[1:])
    ref.release(got[1:])
    assert a.alloc(2) == ref.alloc(2)
    assert a.n_free + a.n_live == a.n_usable
    with pytest.raises(ValueError):
        BlockAllocator(1)


def test_write_rows_and_gather_table_match_reference():
    from shallowspeed_tpu.serving.cache import gather_table as j_gather
    from shallowspeed_tpu.serving.cache import init_block_pool as j_pool
    from shallowspeed_tpu.serving.cache import write_rows as j_write
    from shallowspeed_tpu_torch.serving.cache import (gather_table,
                                                      write_rows)

    jcfg = JT.TransformerConfig(**STREAM_CFG)
    cfg = T.TransformerConfig(**STREAM_CFG)
    rng = np.random.default_rng(3)
    jpool = j_pool(jcfg, 6, 4)[0]
    pool = init_block_pool(cfg, 6, 4, device="cpu")[0]
    for _ in range(3):
        k, v = (rng.normal(size=(3, cfg.kv_heads, cfg.head_dim))
                .astype(np.float32) for _ in range(2))
        blk = rng.integers(1, 6, 3).astype(np.int32)
        off = rng.permutation(4)[:3].astype(np.int32)
        jpool = j_write(jpool, jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(blk), jnp.asarray(off), False)
        write_rows(pool, torch.from_numpy(k), torch.from_numpy(v),
                   torch.from_numpy(blk), torch.from_numpy(off))
    bt = np.asarray([[3, 1, 0], [5, 2, 4]], np.int32)
    want = j_gather(jpool, jnp.asarray(bt))
    got = gather_table(pool, torch.from_numpy(bt))
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_byte_model_matches_reference():
    """Parameter bytes are read off the served (cast) tensors; the
    per-tick model equals the reference's given the same parameter
    bytes."""
    from shallowspeed_tpu.serving.cache import \
        paged_read_bytes_per_tick as j_bytes
    from shallowspeed_tpu_torch.serving.cache import (
        paged_read_bytes_per_tick, param_read_bytes)

    kw = dict(STREAM_CFG, compute_dtype=torch.bfloat16)
    cfg = T.TransformerConfig(**kw)
    np_params = JT.init(JT.TransformerConfig(**STREAM_CFG), seed=0)
    cast = T.cast_params(params_from_numpy(np_params, "cpu"),
                         cfg.compute_dtype)
    leaves = jax.tree_util.tree_leaves_with_path(np_params)
    want = sum(a.size * (4 if any(getattr(k, "key", None) in
                                  ("ln1", "ln2", "ln_f") for k in path)
                         else 2) for path, a in leaves)
    p_bytes = param_read_bytes(cast)
    assert p_bytes == want
    jcfg = JT.TransformerConfig(**dict(STREAM_CFG,
                                       compute_dtype=jnp.bfloat16))
    assert paged_read_bytes_per_tick(cfg, p_bytes, 9, 8, 4) == \
        j_bytes(np_params, jcfg, 9, 8, 4, p_bytes=p_bytes)
