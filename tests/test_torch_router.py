"""The port's serving fleet (`shallowspeed_tpu_torch/serving/router.py`
and the engine's fleet hooks) against the JAX package's, on the CPU.

- `CircuitBreaker`: the same transitions, times and cooldowns as the
  reference's for the same seed and event sequence (exactly: both draw
  from `random.Random(seed)`).
- `RequestGateway`: the same replies and published snapshots.
- `Router`: over `InProcessReplica`s of each package's `ServingEngine`
  (the JAX engine under `test_torch_serving`'s `param_read_bytes` shim),
  the same route choices, scores, sticky affinity bonuses, headroom
  penalties and `FleetOverloaded` rejections (with their retry-after),
  under one fixed clock.
- The engine's hooks: a greedy `submit(generated=)` continuation equals
  the JAX `generate()` stream; the lifecycle phase sequence, `headroom()`
  and the `on_alert` toggles equal the JAX engine's for one script.
- The failover drill: a replica killed mid-stream; the greedy streams
  equal the JAX `generate()` streams and the sampled streams the port's
  own solo streams (token for token: the port samples token i of seed s
  from a generator seeded from (s, i), not from JAX's threefry keys).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shallowspeed_tpu.metrics import MetricsLogger as JMetrics
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.models.generate import generate as jgenerate
from shallowspeed_tpu.serving import engine as JE
from shallowspeed_tpu.serving import router as JR
from shallowspeed_tpu_torch.metrics import MetricsLogger
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.serving import router as PR
from shallowspeed_tpu_torch.serving.engine import ServingEngine
from shallowspeed_tpu_torch.telemetry.schema import validate_file
from shallowspeed_tpu_torch.weights import params_from_numpy

CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, max_seq=128)
ENGINE = dict(n_blocks=32, block_size=8, max_slots=4, prefill_chunk=16)
# fields of a route / failover event that are ids or real-clock stamps
# (minted per run), not decisions
UNSTABLE = {"trace", "span", "parent", "dispatch_wall", "dispatch_mono",
            "wait_ms"}


def toks(seed, t, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, t).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    return JT.init(JT.TransformerConfig(**CFG), seed=1)


def _jax_factory(np_params, monkeypatch, **kw):
    monkeypatch.setattr(JE, "param_read_bytes", lambda params, cfg: 0)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    cfg = JT.TransformerConfig(**CFG)
    return lambda name: JE.ServingEngine(params, cfg, attn_impl="flash",
                                         **{**ENGINE, **kw})


def _port_factory(np_params, made=None, **kw):
    params = params_from_numpy(np_params, "cpu")
    cfg = T.TransformerConfig(**CFG)

    def factory(name):
        eng = ServingEngine(params, cfg, attn_impl="flash", device="cpu",
                            **{**ENGINE, **kw})
        if made is not None:
            made.append(eng)
        return eng
    return factory


def _routers(weights, monkeypatch, engine_kw=None, **router_kw):
    """(reference router, port router) over two in-process replicas of
    their own package's engine, one fixed clock each."""
    engine_kw = engine_kw or {}
    out = []
    for mod, factory in ((JR, _jax_factory(weights, monkeypatch,
                                           **engine_kw)),
                         (PR, _port_factory(weights, **engine_kw))):
        clock = [100.0]
        r = mod.Router(lambda name, f=factory, m=mod: m.InProcessReplica(
            name, f), n_replicas=2, clock=lambda c=clock: c[0],
            request_timeout=None, **router_kw)
        r._test_clock = clock
        out.append(r)
    return out


def _decisions(router):
    return [{k: v for k, v in e.items() if k not in UNSTABLE}
            for e in router.events]


# ------------------------------------------------------ circuit breaker

BREAKER_SCRIPTS = {
    # (seed, kwargs, events): "f" failure, "s" success, "a" allow,
    # "o" force open, "+x" advance the clock x seconds
    "trip-probe-recover": (7, dict(threshold=3, cooldown=2.0,
                                   cooldown_max=10.0, jitter=0.5),
                           "f f s f f f f a +3.1 a a f a +6.1 a s "
                           "f f f a"),
    "force-open": (0, dict(threshold=5, cooldown=1.0, jitter=0.0),
                   "o a +0.5 a +0.51 a a s a f f"),
    "doubling-to-cap": (11, dict(threshold=1, cooldown=0.5,
                                 cooldown_max=2.0, jitter=0.25),
                        "f +1 a f +2 a f +3 a f +4 a f +5 a s"),
    "many-seeds": (12345, dict(), "f f f +2 a f +3 a f +9 a s a f o "
                                  "+40 a s"),
}


@pytest.mark.parametrize("name", sorted(BREAKER_SCRIPTS))
def test_breaker_equals_reference(name):
    """Every call's return, state, trips, retry_after and transition
    stamp, for one seed and one event sequence."""
    seed, kw, script = BREAKER_SCRIPTS[name]

    def run(mod):
        now = [50.0]
        seen = []
        br = mod.CircuitBreaker(seed=seed, on_transition=lambda s, t:
                                seen.append((s, t)), **kw)
        out = []
        for ev in script.split():
            if ev.startswith("+"):
                now[0] += float(ev[1:])
                continue
            ret = {"f": br.note_failure, "s": br.note_success,
                   "a": br.allow, "o": br.force_open}[ev](now[0])
            out.append((ev, ret, br.state, br.trips, br.failures,
                        round(br.retry_after(now[0]), 12)))
        return out, seen

    got, want = run(PR), run(JR)
    assert got == want
    assert any(s == "open" for s, _ in got[1])


# ------------------------------------------------------ request gateway


def test_gateway_equals_reference(weights, monkeypatch):
    """Typed rejections (duplicate, overloaded, draining), the pump into
    each package's engine, the published snapshots and a malformed
    request published as rejected."""
    def run(mod, factory):
        eng = factory("r0")
        gw = mod.RequestGateway(max_queue=2)
        out = [gw.submit_request({"id": "a", "prompt": toks(0, 8).tolist(),
                                  "max_new": 4}),
               gw.submit_request({"id": "a", "prompt": [1], "max_new": 2}),
               gw.submit_request({"id": "b", "prompt": [1, 2],
                                  "max_new": 3}),
               gw.submit_request({"id": "c", "prompt": [1], "max_new": 2}),
               gw.pump(eng)]
        while eng.pending():
            eng.step()
            gw.publish(eng)
            out.append(gw.poll_requests())
        out += [gw.drain_request(), gw.submit_request(
            {"id": "d", "prompt": [1], "max_new": 2}), gw.idle()]
        gw2 = mod.RequestGateway()
        gw2.submit_request({"id": "bad", "prompt": [999999], "max_new": -1})
        gw2.pump(eng)
        out.append(gw2.poll_requests())
        return out

    got = run(PR, _port_factory(weights))
    want = run(JR, _jax_factory(weights, monkeypatch))
    assert got == want
    assert got[3]["error"] == "EngineOverloaded"
    assert got[-1]["requests"]["bad"]["status"] == "rejected"


# --------------------------------------------------------------- router


def _spread(router):
    for i in range(4):
        router.submit(toks(i, 8), 4, rid=f"pre{i}")
    router.step()
    placed = sorted((r.rid, r.replica) for r in router.inflight.values())
    router.run(max_wall=120)
    return [placed]


def _sticky(router):
    fam = toks(50, 32)
    router.submit(fam, 4, rid="cold")
    router.run(max_wall=120)
    router.submit(toks(51, 32), 4, rid="decoy")
    router.submit(fam, 4, rid="warm", temperature=0.8, seed=7)
    router.run(max_wall=120)
    for i in range(3):
        router.submit(fam, 4, rid=f"burst{i}")
    router.step()
    placed = sorted((r.rid, r.replica) for r in router.inflight.values())
    router.run(max_wall=120)
    aff = {n: len(v) for n, v in router._affinity.items()}
    return [placed, aff]


def _headroom(router):
    base = {"queue_depth": 0, "active_slots": 0, "free_blocks": 10}
    h0 = router._replicas["r0"]["handle"]
    h1 = router._replicas["r1"]["handle"]
    now = router.clock()
    scores = []
    for hb0, hb1 in ((12, -6), (12, -10_000), (900, 2)):
        h0.telemetry = lambda v=hb0: dict(base, headroom_blocks=v)
        h1.telemetry = lambda v=hb1: dict(base, headroom_blocks=v)
        scores.append((router._score("r0", now), router._score("r1", now)))
    h0.telemetry = lambda: dict(base, headroom_blocks=12)
    h1.telemetry = lambda: dict(base, headroom_blocks=-6)
    router.submit(toks(53, 8), 4, rid="x")
    router.step()
    placed = router.inflight["x"].replica
    router.run(max_wall=120)
    return [scores, placed]


def _overload(router):
    out = []
    for rid in "abc":
        try:
            router.submit(toks(ord(rid), 8), 4, rid=rid)
            out.append((rid, "queued"))
        except PR.FleetOverloaded as e:        # the port's type
            out.append((rid, "overloaded", round(e.retry_after, 9)))
        except JR.FleetOverloaded as e:        # the reference's type
            out.append((rid, "overloaded", round(e.retry_after, 9)))
    router.run(max_wall=120)
    for name in ("r0", "r1"):
        router._replicas[name]["handle"].kill()
    router._test_clock[0] += 0.5
    router.step()
    try:
        router.submit(toks(9, 8), 4, rid="d")
    except (PR.FleetOverloaded, JR.FleetOverloaded) as e:
        out.append(("d", str(e), round(e.retry_after, 9)))
    out.append(dict(router.counters))
    return out


SCENARIOS = {"spread": (_spread, {}, {}),
             "sticky": (_sticky, {"prefix_cache": True, "prefill_chunk": 8},
                        {"sticky": True, "sticky_block": 8}),
             "headroom": (_headroom, {}, {"sticky": False}),
             "overload": (_overload, {}, {"queue_budget": 2})}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_decisions_equal_reference(name, weights, monkeypatch):
    """Route events (replica, score, queue depth, affinity), breaker and
    restart ledger lines, placements, scores and rejections, step for
    step; and the streams, greedy and sampled, equal each other's
    greedy ones (the sampled ones are each package's own draw)."""
    drive, engine_kw, router_kw = SCENARIOS[name]
    jr, pr = _routers(weights, monkeypatch, engine_kw, **router_kw)
    want, got = drive(jr), drive(pr)
    assert got == want
    assert _decisions(pr) == _decisions(jr)
    assert [e["event"] for e in pr.events].count("route") >= 1
    greedy = [rid for rid in pr.results if rid != "warm"]
    for rid in greedy:
        np.testing.assert_array_equal(pr.results[rid], jr.results[rid],
                                      err_msg=rid)


# ----------------------------------------------------- engine hooks


def _hook_script(eng, metrics_path):
    """Four requests past the pool (an eviction), a continuation, a
    shared prefix, alerts; headroom after every step."""
    heads = [eng.headroom()]
    fam = toks(70, 24)
    eng.submit(fam, 10, rid="fam0")
    for i in range(3):
        eng.submit(toks(60 + i, 18 + 5 * i), 14, rid=f"q{i}")
    eng.submit(fam, 6, rid="cont", generated=[3, 9], trace="t" * 32,
               parent="p" * 16, attempt=2)
    alerts = [{"slo": "ttft_p95_ms<1", "state": "firing",
               "severity": "critical"},
              {"slo": "avail>0.9", "state": "firing",
               "severity": "critical"},
              {"slo": "ttft_p95_ms<1", "state": "resolved"},
              {"slo": "avail>0.9", "state": "firing", "severity": "warn"}]
    toggles = []
    steps = 0
    for late in ("fam1", None):
        while eng.pending():
            if steps in (1, 3, 5, 7):
                eng.on_alert(alerts[steps // 2])
                toggles.append((eng.admission_paused,
                                eng.counters["shed_toggles"]))
            assert eng.step()
            steps += 1
            heads.append(eng.headroom())
        if late:      # fam0's sealed blocks are indexed now: a prefix hit
            eng.submit(fam, 4, rid=late)
    lines = [json.loads(x) for x in open(metrics_path)]
    keep = ("id", "phase", "seq", "tick", "slot", "prev", "attempt",
            "parent", "resumed", "tokens", "chunk", "blocks")
    life = [{k: r[k] for k in keep if k in r} for r in lines
            if r.get("event") == "lifecycle"]
    shed = [{k: r[k] for k in ("kind", "count", "slo")} for r in lines
            if r.get("kind") == "load_shed"]
    timelines = {rid: [e["phase"] for e in tl]
                 for rid, tl in eng.timelines.items()}
    return {"results": {k: v.tolist() for k, v in eng.results.items()},
            "heads": heads, "toggles": toggles, "life": life,
            "shed": shed, "timelines": timelines,
            "preempted": eng.counters["preempted"],
            "trace": [r["trace"] for r in lines
                      if r.get("event") == "request"
                      and r["id"] == "cont"]}


def test_engine_hooks_equal_reference(weights, monkeypatch, tmp_path):
    """The lifecycle lines (phase, seq, tick, slot, prev, attempt,
    parent, tokens, chunk, prefix blocks), the timelines, `headroom()`
    after every step, the `on_alert` toggles and their `load_shed`
    lines, with an eviction, a prefix hit and a continuation in the
    script; the greedy streams equal."""
    kw = dict(n_blocks=12, prefix_cache=True)
    jlog, plog = tmp_path / "j.jsonl", tmp_path / "p.jsonl"
    jm, pm = JMetrics(jlog, kind="serve"), MetricsLogger(plog, kind="serve")
    jeng = _jax_factory(weights, monkeypatch, metrics=jm, **kw)("r")
    peng = _port_factory(weights, metrics=pm, **kw)("r")
    want = _hook_script(jeng, jlog)
    got = _hook_script(peng, plog)
    jm.close()
    pm.close()
    assert got == want
    assert got["preempted"] >= 1
    assert {"preempted", "requeued", "prefill_cached", "finished"} <= {
        r["phase"] for r in got["life"]}
    assert got["trace"] == ["t" * 32]
    assert any(p for p, _ in got["toggles"])
    assert got["shed"] and validate_file(plog) == []


@pytest.mark.parametrize("split", [1, 5, 11])
def test_continuation_equals_generate(weights, split):
    """A greedy stream continued from its first `split` tokens on a
    fresh engine (`submit(generated=)`, `max_new` the total) equals the
    JAX `generate()` stream; a sampled continuation equals the port's
    own uninterrupted stream."""
    jcfg = JT.TransformerConfig(**CFG)
    prompt = toks(80, 13)
    ref = np.asarray(jgenerate(jax.tree_util.tree_map(jnp.asarray, weights),
                               prompt[None], jcfg, 12, temperature=0.0))[0]
    eng = _port_factory(weights)("r")
    eng.submit(prompt, 12, rid="g", generated=ref[:split].tolist())
    eng.submit(prompt, 12, rid="s", temperature=0.9, seed=5)
    done = eng.run()
    np.testing.assert_array_equal(done["g"], ref)
    eng2 = _port_factory(weights)("r")
    eng2.submit(prompt, 12, rid="s", temperature=0.9, seed=5,
                generated=done["s"][:split].tolist())
    np.testing.assert_array_equal(eng2.run()["s"], done["s"])
    with pytest.raises(ValueError, match="nothing left"):
        eng2.submit(prompt, 3, rid="x", generated=[1, 2, 3])


# ------------------------------------------------------ failover drill


def test_failover_drill(weights, tmp_path):
    """Kill r0 while a request is mid-stream on it: every stream still
    completes — the greedy ones equal to JAX's `generate()` streams,
    the sampled ones to the port's solo engine's — with failover events,
    the breaker through open / half_open / closed, a restart_downtime
    stamp for r0 of class crash, a router log that validates, allocators
    balanced, and K4's plain version called n_layers x ticks times over
    every engine the drill built."""
    import time

    from shallowspeed_tpu_torch.ops import flash_attention as FA

    made = []
    log = tmp_path / "router.jsonl"
    router = PR.Router(lambda n: PR.InProcessReplica(
        n, _port_factory(weights, made)), n_replicas=2,
        metrics=MetricsLogger(log, kind="router"), request_timeout=None,
        breaker_kw=dict(cooldown=0.05, jitter=0.0),
        policy_kw=dict(backoff=0.01, jitter=0.0))
    reqs = {"g": (toks(20, 10), 8, 0.0, 0), "s": (toks(21, 13), 8, 1.0, 7),
            "t": (toks(22, 9), 8, 0.7, 3), "h": (toks(23, 17), 8, 0.0, 0)}
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    jcfg = JT.TransformerConfig(**CFG)
    solo = _port_factory(weights)("solo")
    for k, (p, mn, tmp, s) in reqs.items():
        solo.submit(p, mn, temperature=tmp, seed=s, rid=k)
    oracle = solo.run()
    calls = []
    real = FA.paged_flash_decode

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    import shallowspeed_tpu_torch.serving.engine as PE

    PE.paged_flash_decode = counted
    try:
        for k, (p, mn, tmp, s) in reqs.items():
            router.submit(p, mn, temperature=tmp, seed=s, rid=k)
        for _ in range(500):
            router.step()
            if any(r.replica == "r0" and 1 <= len(r.tokens) < r.max_new
                   for r in router.inflight.values()):
                break
        dead = router._replicas["r0"]["handle"].engine
        router._replicas["r0"]["handle"].kill()
        res = router.run(max_wall=120)
        t0 = time.monotonic()
        while time.monotonic() - t0 < 10.0:
            router.step()
            if router.counters["respawns"] >= 1 \
                    and router._breakers["r0"].state == "closed":
                break
            time.sleep(0.01)
    finally:
        PE.paged_flash_decode = real
    for k, (p, mn, tmp, s) in reqs.items():
        np.testing.assert_array_equal(res[k], oracle[k], err_msg=k)
        if tmp == 0.0:
            want = np.asarray(jgenerate(jp, p[None], jcfg, mn,
                                        temperature=0.0))[0]
            np.testing.assert_array_equal(res[k], want, err_msg=k)
    assert router.counters["failovers"] >= 1
    led = [e for e in router.events if e["event"] == "ledger"]
    assert [e["state"] for e in led if e.get("kind") == "breaker"] == [
        "open", "half_open", "closed"]
    rd = [e for e in led if e.get("kind") == "restart_downtime"]
    assert rd and rd[0]["replica"] == "r0" and rd[0]["fail_class"] == "crash"
    router.metrics.close()
    assert validate_file(log) == []
    live = [h["handle"].engine for h in router._replicas.values()]
    for eng in live:
        a = eng.alloc
        assert a.n_live == 0 and a.n_free + a.n_cold == a.n_usable
    assert dead in made and len(made) == 3
    ticks = sum(e.counters["ticks"] for e in made)
    assert len(calls) == CFG["n_layers"] * ticks
