"""Smoke check of the PyTorch port (`shallowspeed_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port builds, is right and
serves on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build every CUDA kernel of the serving path from `csrc/` with nvcc
   (sm_90a), one nvcc per source, all started together.
2. Hold each kernel against its plain torch version on the card, at
   small shapes and at the serving path's own shapes.
3. Serve the repo's 1.21B LM (vocab 32768, d_model 2048, 16 heads, 16
   layers, RoPE + RMSNorm + SwiGLU, f32 master weights, bf16 compute)
   at full width and depth through `ServingEngine(attn_impl="flash")`,
   with seeded random weights: 12 greedy requests, prompts of 128-1024
   tokens, 32 new tokens each, 8 slots. The kernel launch counts are
   zeroed just before the run and must equal n_layers x ticks after it;
   the block allocator must be balanced at drain.
4. Hold the engine's prefill-then-decode logits of two requests against
   the plain full forward over the same tokens (teacher-forced), in the
   bf16 compute path served above and again in f32 compute, and show
   that a bf16 rounding slipped into the f32 attention path fails the
   f32 bound.
5. Time each kernel at the serving shapes beside its plain version,
   one library call computing the same function, and its bound.

The last lines are the card's name and power limit, one JSON line with
the kernels' numbers, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks, dense (see PERF.md)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

SLICE = dict(slots=8, heads=16, kv_heads=16, head_dim=128, block_size=16)
N_REQUESTS = 12
MAX_NEW = 32
PREFILL_CHUNK = 256
N_BLOCKS = 1024
# Paged serving logits vs the plain full forward over the same tokens,
# as max |diff| / max |ref| over every compared position (PERF.md,
# "chip_smoke tolerances", has the measurements behind both bounds).
# bf16 compute: bf16 rounding through 16 layers differs between one
# token at a time and the whole sequence at once, so the two sit ~1.5e-2
# apart; the bound catches a wrong block, position or mask (errors of
# order 1), not a one-rounding slip, which hides in that noise.
LOGITS_TOL_BF16 = 3e-2
# f32 compute (the same weights, the kernel's f32 build): the paths
# differ only in summation order (~4e-6 on an H100), while a bf16 rounding
# of q and K before the scores lands near 3e-3; phase 4 checks that it
# does exceed this bound.
LOGITS_TOL_F32 = 1e-4


def _card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def _time_ms(fn, inputs, repeats=7):
    """Median ms per call of fn(*inputs[i]) cycling through `inputs`
    (enough distinct inputs that they do not stay in the 50 MB L2)."""
    import torch

    for args in inputs[:3]:
        fn(*args)
    torch.cuda.synchronize()
    per = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for args in inputs:
            fn(*args)
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / len(inputs))
    return float(np.median(per))


def _decode_inputs(rng, dev, dtype, slots, heads, kv_heads, head_dim,
                   block_size, width, window=0, pos=None):
    """Random q and pools, tables of distinct non-scratch blocks, and
    positions; the last row is a scratch row (pos 0, table all block 0)
    like an empty decode slot."""
    import torch

    n = slots * width + 1
    perm = rng.permutation(np.arange(1, n)).reshape(slots, width)
    bt = perm.astype(np.int32)
    if pos is None:
        pos = rng.integers(0, width * block_size, slots)
    pos = np.asarray(pos, np.int32).copy()
    bt[-1], pos[-1] = 0, 0
    shape = (n, kv_heads, block_size, head_dim)
    pool = {"k": torch.randn(shape, device=dev).to(dtype),
            "v": torch.randn(shape, device=dev).to(dtype)}
    q = torch.randn(slots, heads, head_dim, device=dev).to(dtype)
    return (q, pool, torch.from_numpy(bt).to(dev),
            torch.from_numpy(pos).to(dev), window)


def check_kernels(dev) -> dict:
    """Phase 2: the paged decode kernel against its plain version."""
    import torch

    from shallowspeed_tpu_torch.ops.flash_attention import (
        paged_flash_decode, paged_flash_decode_reference)

    rng = np.random.default_rng(0)
    small = dict(slots=4, head_dim=64, block_size=8, width=3)
    big = dict(SLICE, width=64)
    cases = [
        ("small-mha", dict(small, heads=4, kv_heads=4), 0),
        ("small-gqa", dict(small, heads=8, kv_heads=2), 0),
        ("small-window", dict(small, heads=4, kv_heads=4), 6),
        ("slice-mha", big, 0),
        ("slice-gqa", dict(big, kv_heads=4), 0),
        ("slice-window", big, 100),
    ]
    # f32: only the summation order differs. bf16: the output is rounded
    # to bf16 once, and the reference rounds P to bf16 before PV.
    tols = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    worst = 0.0
    for name, shape, window in cases:
        for dtype, tol in tols.items():
            q, pool, bt, pos, w = _decode_inputs(rng, dev, dtype,
                                                 window=window, **shape)
            got = paged_flash_decode(q, pool, bt, pos, window=w)
            torch.cuda.synchronize()
            ref = paged_flash_decode_reference(q, pool, bt, pos, window=w)
            err = float((got.float() - ref.float()).abs().max())
            rel = err / max(1e-6, float(ref.float().abs().max()))
            if not (rel <= tol and torch.isfinite(got).all()):
                raise AssertionError(f"paged_flash_decode {name} {dtype}: "
                                     f"rel err {rel:.3e} > {tol:g}")
            print(f"check paged_flash_decode {name} {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g})",
                  flush=True)
            if name == "slice-mha" and dtype == torch.bfloat16:
                worst = err
    return {"paged_flash_decode": worst}


def slice_config():
    import torch

    from shallowspeed_tpu_torch.models import transformer as T

    return T.TransformerConfig(
        vocab=32768, d_model=2048, n_heads=16, n_layers=16, max_seq=2048,
        dtype=np.float32, compute_dtype=torch.bfloat16, rope=True,
        norm="rmsnorm", ffn="swiglu")


def serve(dev, cfg) -> dict:
    """Phase 3: the 1.21B LM served through the port's engine."""
    import torch

    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.ops.flash_attention import paged_flash_decode
    from shallowspeed_tpu_torch.report import request_summary
    from shallowspeed_tpu_torch.serving.engine import ServingEngine
    from shallowspeed_tpu_torch.weights import leaves

    t0 = time.time()
    params = T.init(cfg, seed=0, device=dev)
    n_params = sum(t.numel() for t in leaves(params))
    print(f"init: {n_params / 1e9:.3f}B params in "
          f"{time.time() - t0:.1f} s", flush=True)
    eng = ServingEngine(params, cfg, n_blocks=N_BLOCKS,
                        block_size=SLICE["block_size"],
                        max_slots=SLICE["slots"],
                        prefill_chunk=PREFILL_CHUNK, attn_impl="flash",
                        device=dev)
    # one warmup request first: library handles and first-call setup for
    # each prefill shape are process start-up, not serving time
    eng.submit(np.arange(300, dtype=np.int32) % cfg.vocab, 4, rid="warmup")
    eng.run()
    del eng.results["warmup"], eng.request_records[:]
    base = dict(eng.counters)
    rng = np.random.default_rng(1)
    lens = rng.integers(128, 1025, N_REQUESTS)
    prompts = {f"r{i}": rng.integers(0, cfg.vocab, n).astype(np.int32)
               for i, n in enumerate(lens)}
    for rid, p in prompts.items():
        eng.submit(p, MAX_NEW, rid=rid)

    paged_flash_decode.launches = 0
    tick_s = []
    t0 = time.time()
    while eng.pending():
        chunks = eng.counters["prefill_chunks"]
        ticks = eng.counters["ticks"]
        s0 = time.perf_counter()
        if not eng.step():
            raise AssertionError("engine made no progress")
        if (eng.counters["prefill_chunks"] == chunks
                and eng.counters["ticks"] == ticks + 1):
            tick_s.append(time.perf_counter() - s0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = paged_flash_decode.launches

    ticks = eng.counters["ticks"] - base["ticks"]
    if launches != cfg.n_layers * ticks or ticks == 0:
        raise AssertionError(f"paged_flash_decode launched {launches} "
                             f"times over {ticks} ticks of "
                             f"{cfg.n_layers} layers")
    if eng.alloc.n_free != eng.alloc.n_usable or eng.alloc.n_live:
        raise AssertionError(f"allocator unbalanced at drain: "
                             f"{eng.alloc.n_free}/{eng.alloc.n_usable}")
    for rid in prompts:
        toks = eng.results[rid]
        if toks.shape != (MAX_NEW,) or toks.min() < 0 \
                or toks.max() >= cfg.vocab:
            raise AssertionError(f"bad result for {rid}: {toks}")
    summ = request_summary(eng.request_records)
    out = {"ticks": ticks, "launches": launches, "wall_s": wall,
           "decode_only_ticks": len(tick_s),
           "tick_ms_p50": 1e3 * float(np.median(tick_s)) if tick_s else None,
           "tok_per_s": summ["tokens_out"] / wall,
           "ttft_ms_p50": summ["ttft_ms_p50"],
           "ttft_ms_p95": summ["ttft_ms_p95"],
           "tpot_ms_p50": summ["tpot_ms_p50"],
           "prefill_chunks": (eng.counters["prefill_chunks"]
                              - base["prefill_chunks"]),
           "preempted": eng.counters["preempted"] - base["preempted"],
           "max_table_blocks": int(max(lens + MAX_NEW - 1)
                                   // SLICE["block_size"] + 1),
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print("serve: " + json.dumps(out), flush=True)
    return {"eng": eng, "params": params, "prompts": prompts, "stats": out}


def check_logits(dev, cfg, params, prompts, results, tol, attn="flash",
                 n_requests=2) -> float:
    """Phase 4: for the longest requests, the paged path's logits —
    chunked prefill, then one decode step per generated token through
    the engine's own functions (and the kernel, with attn="flash") —
    against the plain full forward over the same tokens (teacher-forced),
    in cfg's compute dtype. Returns the worst max |diff| / max |ref|;
    raises when it exceeds `tol` (None: no bound)."""
    import torch

    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.serving.cache import (blocks_for,
                                                      init_block_pool)
    from shallowspeed_tpu_torch.serving.engine import (decode_logits,
                                                       prefill_chunk,
                                                       table_width)

    params = T.cast_params(params, cfg.compute_dtype)
    bs = SLICE["block_size"]
    worst = 0.0
    for rid in sorted(prompts, key=lambda r: len(prompts[r]))[-n_requests:]:
        prompt, gen = prompts[rid], results[rid]
        seq = np.concatenate([prompt, gen[:-1]]).astype(np.int32)
        nb = blocks_for(len(seq), bs)
        pools = init_block_pool(cfg, nb + 1, bs, device=dev)
        bt = np.zeros((1, table_width(nb, 4)), np.int32)
        bt[0, :nb] = np.arange(1, nb + 1)
        bt = torch.from_numpy(bt).to(dev)
        for s in range(0, len(prompt), PREFILL_CHUNK):
            chunk = torch.from_numpy(prompt[s:s + PREFILL_CHUNK]).to(dev)
            last = prefill_chunk(params, pools, chunk, s, bt, cfg=cfg)
        rows = [last]
        for i in range(len(gen) - 1):
            rows.append(decode_logits(
                params, pools,
                torch.tensor([int(gen[i])], dtype=torch.int32, device=dev),
                torch.tensor([len(prompt) + i], dtype=torch.int32,
                             device=dev), bt, cfg=cfg, attn=attn)[0])
        got = torch.stack(rows)
        ref = T.forward(params, torch.from_numpy(seq).to(dev).long()[None],
                        cfg)[0, len(prompt) - 1:].float()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"logits {str(cfg.act_dtype)[6:]} {attn} {rid} "
              f"({len(prompt)} prompt + {len(gen) - 1} decoded): "
              f"max_abs_err {err:.4e} rel {rel:.4e} (tol {tol}), "
              f"argmax agreement {agree:.3f}", flush=True)
        if tol is not None and not rel <= tol:
            raise AssertionError(f"{rid}: paged logits off the plain "
                                 f"forward by {rel:.3e} > {tol:g}")
        worst = max(worst, rel)
    return worst


def check_f32_bound_catches_a_slip(dev, cfg32, run) -> None:
    """The f32 logits bound must catch a bf16 slip in the attention
    path: the gather path with q and the cached K rounded to bf16 before
    the scores (what a kernel that let bf16 into its f32 score path
    would compute) has to land above LOGITS_TOL_F32."""
    import torch

    from shallowspeed_tpu_torch.serving import engine as E

    exact = E.masked_attention

    def slipped(q, cache_blk, valid):
        def bf(t):
            return t.to(torch.bfloat16).to(t.dtype)

        return exact(bf(q), {"k": bf(cache_blk["k"]), "v": cache_blk["v"]},
                     valid)

    E.masked_attention = slipped
    try:
        rel = check_logits(dev, cfg32, run["params"], run["prompts"],
                           run["eng"].results, None, attn="gather",
                           n_requests=1)
    finally:
        E.masked_attention = exact
    if not rel > LOGITS_TOL_F32:
        raise AssertionError(f"a bf16 score slip moved the f32 logits by "
                             f"only {rel:.3e}: LOGITS_TOL_F32 cannot see it")


def time_kernels(dev, stats) -> dict:
    """Phase 5: times at the serving shapes — S=8 slots, 16 heads,
    hd 128, bs 16, bf16 pools, a table bucket of the longest request,
    positions like the traffic's (a prompt plus half the new tokens) —
    on 16 input sets, one per layer, as a tick reads them."""
    import torch
    import torch.nn.functional as F

    from shallowspeed_tpu_torch.ops.flash_attention import (
        paged_flash_decode, paged_flash_decode_reference)
    from shallowspeed_tpu_torch.serving.cache import gather_table
    from shallowspeed_tpu_torch.serving.engine import table_width

    bs, hkv, hd = SLICE["block_size"], SLICE["kv_heads"], SLICE["head_dim"]
    width = table_width(stats["max_table_blocks"], 4)
    rng = np.random.default_rng(2)
    pos = rng.integers(128, 1025, SLICE["slots"]) + MAX_NEW // 2
    sets = [_decode_inputs(rng, dev, torch.bfloat16, width=width, pos=pos,
                           **{k: SLICE[k] for k in SLICE})
            for _ in range(16)]
    before = paged_flash_decode.launches

    def kern(q, pool, bt, p, w):
        paged_flash_decode(q, pool, bt, p, window=w)

    def plain(q, pool, bt, p, w):
        paged_flash_decode_reference(q, pool, bt, p, window=w)

    lib_sets = []
    for q, pool, bt, p, _ in sets:
        view = gather_table(pool, bt)
        mask = (torch.arange(width * bs, device=dev)[None, :]
                <= p.long()[:, None])[:, None, None, :]
        lib_sets.append((q[:, :, None], view["k"], view["v"], mask))

    def library(q, k, v, mask):
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    ms = _time_ms(kern, sets)
    plain_ms = _time_ms(plain, sets)
    library_ms = _time_ms(library, lib_sets)
    paged_flash_decode.launches = before   # timing launches do not count

    # least time for one call: each input read once, the output written
    # once; K/V counted over the live blocks this call's positions need
    live = int(sum(p // bs + 1 for p in pos[:-1])) + 1   # + scratch row
    itemsize = 2
    s, h = SLICE["slots"], SLICE["heads"]
    nbytes = (live * 2 * hkv * bs * hd * itemsize        # live K/V
              + 2 * s * h * hd * itemsize                # q, out
              + s * width * 4 + s * 4)                   # bt, pos
    n_pos = int(sum(p + 1 for p in pos[:-1])) + 1        # + scratch row
    flops = 4 * h * hd * n_pos                           # QK and PV
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
        flops / F32_FLOPS_PER_S else "operations"
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "width": width,
           "live_kv_bytes": live * 2 * hkv * bs * hd * itemsize}
    print("time paged_flash_decode: " + json.dumps(out), flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from shallowspeed_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}",
          flush=True)

    t0 = time.time()
    _build.build(["paged_decode"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in _build.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    errs = check_kernels(dev)
    cfg = slice_config()
    run = serve(dev, cfg)
    check_logits(dev, cfg, run["eng"].params, run["prompts"],
                 run["eng"].results, LOGITS_TOL_BF16)
    cfg32 = dataclasses.replace(cfg, compute_dtype=None)
    check_logits(dev, cfg32, run["params"], run["prompts"],
                 run["eng"].results, LOGITS_TOL_F32)
    check_f32_bound_catches_a_slip(dev, cfg32, run)
    timing = time_kernels(dev, run["stats"])

    kernels = [{
        "name": "paged_flash_decode", "route": "cuda",
        "source": "shallowspeed_tpu_torch/csrc/paged_decode.cu",
        "replaces": "shallowspeed_tpu/ops/flash_attention.py:947",
        "launches": run["stats"]["launches"],
        "max_abs_err": errs["paged_flash_decode"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
