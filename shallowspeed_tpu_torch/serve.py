"""Decode-server driver for the PyTorch port: continuous batching over
the paged KV cache. Counterpart of the root `serve.py`.

    python -m shallowspeed_tpu_torch.serve --requests reqs.jsonl

Requests arrive as JSONL (`--requests FILE`, `-` = stdin), one object
per line, in the root driver's format:

    {"id": "r0", "prompt": [17, 3, 92], "max_new": 24}
    {"id": "r1", "prompt_len": 512, "prompt_seed": 7, "max_new": 16,
     "temperature": 1.0, "seed": 5, "at": 0.25}

`prompt` is explicit token ids; `prompt_len` (+ `prompt_seed`) draws a
random prompt; `at` is the submission offset in seconds from the start.
Each completion prints one `{"event": "result", ...}` line; the run ends
with a `{"event": "summary", ...}` line. Runs on the GPU unless
`--device cpu` is given. The weights are a seeded draw (`--init-seed`),
or a checkpoint's (`--ckpt DIR`, a `ckpt_N` directory either package
wrote: its manifest is verified and its parameters must match the
model the flags describe).

`--profile host [--profile-hz N]` runs the host sampling profiler
(`telemetry.profiler`) over the serving loop, its "profile" snapshots
(the last one at the end of the run) into `--log-file`.

`--monitor-port P --slo SPEC --flight-recorder N` run the live monitor
(`telemetry.monitor`): the engine's "request" and "generate" lines feed
its ttft/tpot, tok/s, queue-depth and free-block sketches; SLO
burn-rate alerts land as `"alert"` events and dump the flight
recorder's ring (`flightrec_*.json` next to `--log-file`); the endpoint
(its URL printed as a `{"event": "monitor_listening", ...}` line)
serves /status.json, /sketches.json, /profile.json and /metrics. The
final sketch snapshot lands in the log at the end of the run.

`--chaos PLAN --chaos-state DIR --chaos-seed N` (or the plan a
supervisor exports) runs a serving drill: the engine's tick-indexed
hooks (`ServingEngine(chaos_plan=)`) stall or kill at tick N, each fault
stamped into `--log-file` and arming the profiler's capture.

The root driver's other flags (the HTTP replica mode `--serve`, its
queue, heartbeat and replica label, `--fleet-register`, `--shed-load`,
`--platform`) are recognised and refused with `NotPorted`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from shallowspeed_tpu_torch import NotPorted, chaos, checkpoint, resolve_device
from shallowspeed_tpu_torch.elastic import FLEET
from shallowspeed_tpu_torch.metrics import MetricsLogger
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.serving.engine import ServingEngine
from shallowspeed_tpu_torch.telemetry import monitor, profiler
from shallowspeed_tpu_torch.telemetry.driver import (add_chaos_flags,
                                                     add_monitor_flags,
                                                     setup_chaos)
from shallowspeed_tpu_torch.telemetry.report import request_summary
from shallowspeed_tpu_torch.weights import map_tree, params_from_numpy

# the root driver's flags this driver does not have yet, and where each
# comes from
UNPORTED = {
    **dict.fromkeys(["--max-queue", "--heartbeat-file", "--replica",
                     "--fleet-register", "--shed-load"], FLEET),
    # JAX's backend choice; the port takes --device, and the virtual
    # multi-device meshes --platform cpu builds come with the engines
    "--platform": "Queue 1, multi-device LM engines",
}


class _Refuse(argparse.Action):
    """Any use of an unported flag raises `NotPorted`."""

    def __call__(self, parser, namespace, values, option_string=None):
        raise NotPorted(f"serve {option_string}", UNPORTED[option_string])


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    m = p.add_argument_group("model")
    m.add_argument("--vocab", type=int, default=256)
    m.add_argument("--d-model", type=int, default=64)
    m.add_argument("--n-heads", type=int, default=4)
    m.add_argument("--n-layers", type=int, default=2)
    m.add_argument("--max-seq", type=int, default=512)
    m.add_argument("--rope", action="store_true")
    m.add_argument("--init-seed", type=int, default=0,
                   help="weight-init seed for the demo model")
    m.add_argument("--ckpt", default=None,
                   help="checkpoint dir (a ckpt_N directory) to load the "
                        "params from; the model flags must match it")
    s = p.add_argument_group("serving")
    s.add_argument("--n-blocks", type=int, default=128)
    s.add_argument("--block-size", type=int, default=16)
    s.add_argument("--slots", type=int, default=4,
                   help="decode-slot capacity (the tick's fixed row count)")
    s.add_argument("--prefill-chunk", type=int, default=64)
    s.add_argument("--table-bucket", type=int, default=4)
    s.add_argument("--kv-quant", default="", choices=["", "int8"],
                   help="int8 KV pools with f32 per-position scales (the "
                        "decode tick then runs the paged decode kernel's "
                        "int8 branch)")
    s.add_argument("--weight-quant", default="", choices=["", "int8", "fp8"],
                   help="quantized weight storage: dense weights as int8 or "
                        "fp8-e4m3 values with per-out-channel f32 scales, "
                        "quantized once at start")
    s.add_argument("--attn-impl", default="flash",
                   choices=["gather", "flash"],
                   help="decode-tick attention: 'flash' = the paged "
                        "decode CUDA kernel (its plain torch version on "
                        "--device cpu), 'gather' = gather_table + "
                        "masked_attention")
    s.add_argument("--spec-k", type=int, default=0,
                   help="speculative decoding: up to K self-drafted "
                        "(n-gram prompt-lookup) tokens per decoding "
                        "request per tick, verified in the tick's free "
                        "rows; 0 = off. Streams equal spec-off streams")
    s.add_argument("--spec-ngram", type=int, default=3,
                   help="longest n-gram the draft proposer matches")
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--top-p", type=float, default=0.0)
    s.add_argument("--prefix-cache", default="on", choices=["off", "on"],
                   help="prefix caching: requests sharing block-aligned "
                        "prompt prefixes map the shared KV blocks into "
                        "their tables (refcounted, copy-on-write at the "
                        "tail) and skip that prefill")
    p.add_argument("--requests", default="-",
                   help="JSONL request file, or - for stdin")
    p.add_argument("--serve", action="store_true",
                   help="HTTP replica mode (not ported yet: raises)")
    p.add_argument("--log-file", default=None,
                   help="metrics JSONL (request/generate events)")
    p.add_argument("--log-every", type=int, default=16,
                   help="decode ticks between 'generate' stat lines")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "torch versions of the kernels)")
    p.add_argument("--profile", default="off",
                   choices=["off", "host", "host+device"],
                   help="continuous profiling plane (telemetry/"
                        "profiler): 'host' runs the host stack sampler "
                        "('profile' events in --log-file); 'host+device' "
                        "also wraps each triggered capture in a bounded "
                        "torch.profiler device trace")
    p.add_argument("--profile-hz", type=float, default=None,
                   help="host sampler rate (default 67 Hz)")
    add_monitor_flags(p.add_argument_group(
        "live monitoring (telemetry/monitor)"))
    add_chaos_flags(p.add_argument_group("chaos (shallowspeed_tpu_torch."
                                         "chaos)"), supervised=False)
    for flag in UNPORTED:
        p.add_argument(flag, nargs="?", action=_Refuse,
                       help=argparse.SUPPRESS)
    return p


def parse_args(argv=None):
    return parser().parse_args(argv)


def load_requests(path: str, vocab: int) -> list[dict]:
    raw = sys.stdin.read() if path == "-" else Path(path).read_text()
    reqs = []
    for i, line in enumerate(raw.splitlines()):
        if not line.strip():
            continue
        rec = json.loads(line)
        rec.setdefault("id", f"r{i}")
        if "prompt" in rec:
            # explicit ids are the caller's exact prompt: out of vocab is
            # an error, never a silent remap
            rec["prompt"] = np.asarray(rec["prompt"], np.int32)
            if rec["prompt"].size and (
                    int(rec["prompt"].min()) < 0
                    or int(rec["prompt"].max()) >= vocab):
                raise ValueError(
                    f"request {rec['id']!r}: prompt token ids must be in "
                    f"[0, {vocab}); got range [{int(rec['prompt'].min())}, "
                    f"{int(rec['prompt'].max())}]")
        else:
            rng = np.random.default_rng(rec.get("prompt_seed", i))
            rec["prompt"] = rng.integers(0, vocab,
                                         rec["prompt_len"]).astype(np.int32)
        rec.setdefault("at", 0.0)
        reqs.append(rec)
    reqs.sort(key=lambda r: r["at"])
    return reqs


def load_ckpt_params(ckpt_dir, cfg: T.TransformerConfig, device):
    """The parameters of checkpoint dir `ckpt_dir` (a `ckpt_N` either
    package wrote) as tensors on `device`: the manifest verified
    (`CheckpointError` otherwise), the tree's structure and shapes held
    against `cfg`'s (`ValueError` on a mismatch)."""
    shapes = T.param_shapes(cfg)
    params = checkpoint.load_params(ckpt_dir, shapes)
    # in the model's own key order (a checkpoint's dicts come back sorted)
    return params_from_numpy(map_tree(lambda _, x: x, shapes, params),
                             device)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.serve:
        raise NotPorted("--serve (HTTP replica mode)", FLEET)

    device = resolve_device(args.device)
    cfg = T.TransformerConfig(
        vocab=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, max_seq=args.max_seq, rope=args.rope)
    if args.ckpt:
        params = load_ckpt_params(args.ckpt, cfg, device)
    else:
        params = T.init(cfg, seed=args.init_seed, device=device)
    reqs = load_requests(args.requests, cfg.vocab)
    # serving drills: tick-indexed faults through the training hooks,
    # stamped into this run's log
    setup_chaos(args, log_file=args.log_file)
    metrics = MetricsLogger(
        args.log_file, kind="serve", vocab=cfg.vocab, d_model=cfg.d_model,
        n_layers=cfg.n_layers, n_blocks=args.n_blocks,
        block_size=args.block_size, slots=args.slots,
        prefill_chunk=args.prefill_chunk, attn_impl=args.attn_impl,
        kv_quant=args.kv_quant, weight_quant=args.weight_quant,
        spec_k=args.spec_k, prefix_cache=args.prefix_cache,
        device=str(device))
    try:
        eng = ServingEngine(
            params, cfg, n_blocks=args.n_blocks, block_size=args.block_size,
            max_slots=args.slots, prefill_chunk=args.prefill_chunk,
            table_bucket=args.table_bucket, kv_quant=args.kv_quant,
            weight_quant=args.weight_quant, attn_impl=args.attn_impl,
            spec_k=args.spec_k, spec_ngram=args.spec_ngram,
            top_k=args.top_k, top_p=args.top_p,
            metrics=metrics, log_every=args.log_every,
            prefix_cache=(args.prefix_cache == "on"), device=device)
    except BaseException:
        metrics.close()
        raise

    t0 = time.time()
    i = 0
    reported = 0
    plane = profiler.from_args(args, metrics)
    if plane is not None:
        chaos.add_observer(plane.on_fault)
    try:
        mon, server = monitor.from_args(args, metrics)
    except BaseException:
        if plane is not None:
            plane.close()
        metrics.close()
        raise
    if server is not None:
        print(json.dumps({"event": "monitor_listening",
                          "url": server.url("/status.json")}), flush=True)
    if mon is not None and plane is not None:
        mon.profiler = plane
        mon.alert_listeners.append(plane.on_alert)
    try:
        while True:
            now = time.time() - t0
            while i < len(reqs) and reqs[i]["at"] <= now:
                r = reqs[i]
                i += 1
                try:
                    eng.submit(r["prompt"], r["max_new"],
                               temperature=r.get("temperature", 0.0),
                               seed=r.get("seed", 0), rid=r["id"])
                except (KeyError, TypeError, ValueError) as e:
                    # one bad request must not kill the server
                    print(json.dumps({"event": "error", "id": r["id"],
                                      "error": f"{type(e).__name__}: {e}"}))
            if eng.pending():
                eng.step()
            elif i < len(reqs):
                time.sleep(min(0.05, max(0.0, reqs[i]["at"] - now)))
            for rec in eng.request_records[reported:]:
                print(json.dumps({
                    "event": "result", "id": rec["id"],
                    "tokens": [int(t) for t in eng.results[rec["id"]]],
                    "ttft_ms": rec["ttft_ms"],
                    "tpot_ms": rec.get("tpot_ms")}), flush=True)
            reported = len(eng.request_records)
            if i >= len(reqs) and not eng.pending():
                break
    finally:
        wall = time.time() - t0
        summary = request_summary(eng.request_records) or {}
        summary.update({
            "wall_s": round(wall, 3),
            "tok_per_sec": round(
                sum(r["tokens_out"] for r in eng.request_records)
                / max(wall, 1e-9), 2),
            "ticks": eng.counters["ticks"],
            "prefill_chunks": eng.counters["prefill_chunks"],
            "preemptions": eng.counters["preempted"],
            "spec_drafted": eng.counters["spec_drafted"],
            "spec_accepted": eng.counters["spec_accepted"],
            "pending_at_exit": eng.pending(),
            "blocks_free_at_drain":
                f"{eng.alloc.n_free}/{eng.alloc.n_usable}",
            "device": str(device),
        })
        print(json.dumps({"event": "summary", **summary}), flush=True)
        try:
            if plane is not None:
                chaos.remove_observer(plane.on_fault)
                plane.close()    # its last snapshot into --log-file
            # the monitor's final sketch snapshot, then the endpoint down
            monitor.close_monitor(mon, server)
        finally:
            metrics.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
