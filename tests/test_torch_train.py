"""The port's training path (`shallowspeed_tpu_torch`: `optim`, the
training half of `models.transformer`, `parallel.context`, `weights`,
`flops`, `metrics` and the `train_lm` driver) against the JAX package on
the same numpy inputs, on the CPU. The JAX flash kernels run in Pallas
interpret mode; the port's take their plain versions on CPU tensors.

Tolerances (max |diff| / max |ref| unless stated):
- optimizers: 1e-6 on parameters and moments (the same f32 formulas,
  term for term);
- loss and gradients, f32 compute: 1e-5 on the loss, 1e-4 per gradient
  leaf (the same arithmetic summed in another order: measured ~2e-7 and
  ~1.5e-6);
- bf16 compute: 1e-3 on the loss and 5e-2 per gradient leaf — the two
  frameworks round activations and cotangents to bf16 at different
  points (XLA fuses elementwise chains, torch rounds each op's output),
  a few bf16 ulps (2^-8) of a leaf's max: measured 6e-5 and 2.7e-2;
- the 3-step engine trajectory (f32, flash attention, AdamW + clipping
  + cosine warm-up): losses 1e-5; parameters 1e-5 absolute (lr 1e-2
  moves an element by up to 3e-2 over the run; measured 3.6e-6);
  Adam moments 1e-4 per leaf (measured 2.3e-5).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import train_lm as jdriver
from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JaxEngine)
from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch import flops, metrics
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch import train_lm as tdriver
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh
from shallowspeed_tpu_torch.weights import (leaves, opt_state_to_numpy,
                                            params_from_numpy,
                                            params_to_numpy, placed_copy,
                                            unflatten)


def _flat(tree, prefix=""):
    """{path: numpy array} of a tree of dicts and lists (either
    package's; paths do not depend on leaf order)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float()
    return {prefix: np.asarray(tree, np.float64)}


def _worst(got, ref, absolute=False):
    """Worst leaf error of `got` against `ref` (same paths)."""
    g, r = _flat(got), _flat(ref)
    assert g.keys() == r.keys()
    worst = 0.0
    for k in r:
        err = float(np.abs(g[k] - r[k]).max()) if r[k].size else 0.0
        scale = 1.0 if absolute else max(float(np.abs(r[k]).max()), 1e-30)
        worst = max(worst, err / scale if (err or not absolute) else 0.0)
    return worst


# ---------------------------------------------------------- optimizers

OPTS = {
    "sgd": (lambda M, lr: M.SGD(lr, grad_clip=0.5), 0.1),
    "momentum": (lambda M, lr: M.MomentumSGD(lr, momentum=0.8), 0.1),
    "adam": (lambda M, lr: M.Adam(lr, grad_clip=0.5), 1e-2),
    "adamw": (lambda M, lr: M.AdamW(lr, weight_decay=0.1, grad_clip=1.0),
              1e-2),
}


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_matches_jax(name, schedule):
    """Five steps of each optimizer on the same numpy params and grads,
    with global-norm clipping where the optimizer has it; parameters
    and state leaf by leaf."""
    make, peak = OPTS[name]
    rng = np.random.default_rng(7)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "blocks": [{"b": rng.normal(size=(5,)).astype(np.float32)}]}
    grads = [{"w": rng.normal(size=(6, 5)).astype(np.float32),
              "blocks": [{"b": 3 * rng.normal(size=(5,)).astype(
                  np.float32)}]} for _ in range(5)]

    def lr(M):
        if schedule == "constant":
            return peak
        return M.SCHEDULES[schedule](peak, warmup=2, total=5, end=peak / 10)

    jopt, topt = make(JO, lr(JO)), make(O, lr(O))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.step(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = topt.step(tp, params_from_numpy(g, "cpu"), ts)
    assert _worst(params_to_numpy(tp), jax.device_get(jp)) <= 1e-6
    jstate = jax.device_get(js)
    tstate = opt_state_to_numpy(ts)
    if isinstance(jstate, dict) and "t" in jstate:
        assert int(tstate["t"]) == int(jstate["t"]) == 5
        jstate = {k: v for k, v in jstate.items() if k != "t"}
        tstate = {k: v for k, v in tstate.items() if k != "t"}
    if jstate != ():
        assert _worst(tstate, jstate) <= 1e-6


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_schedules_match_jax(schedule):
    jfn = JO.SCHEDULES[schedule](3e-4, warmup=4, total=20, end=3e-5)
    tfn = O.SCHEDULES[schedule](3e-4, warmup=4, total=20, end=3e-5)
    for t in range(25):
        assert tfn(t) == pytest.approx(float(jfn(t)), rel=1e-6, abs=1e-12)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "b": [rng.normal(size=(7,)).astype(np.float32)]}
    jn = float(JO.global_norm(jax.tree_util.tree_map(jnp.asarray, g)))
    assert float(O.global_norm(params_from_numpy(g, "cpu"))) == \
        pytest.approx(jn, rel=1e-6)
    ref = jax.device_get(JO.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 1.0))
    got = O.clip_by_global_norm(params_from_numpy(g, "cpu"), 1.0)
    assert _worst(got, ref) <= 1e-6


# ---------------------------------------------------- loss and gradients

CONFIGS = {
    "gqa-rope-rms-swiglu": dict(vocab=96, d_model=64, n_heads=4,
                                n_kv_heads=2, n_layers=2, max_seq=32,
                                rope=True, norm="rmsnorm", ffn="swiglu"),
    "tied-window-smooth-softcap": dict(vocab=96, d_model=64, n_heads=4,
                                       n_layers=2, max_seq=32,
                                       tie_embeddings=True, attn_window=6,
                                       label_smoothing=0.1,
                                       logit_softcap=5.0),
}


def _batch(vocab, seed, b=2, t=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (b, t)).astype(np.int32),
            rng.integers(0, vocab, (b, t)).astype(np.int32))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(name, bf16):
    """`T.loss` and every gradient leaf (torch autograd through the
    compute-dtype cast back to the f32 masters) against
    `jax.value_and_grad(T.loss)`, plain attention on both sides."""
    kw = CONFIGS[name]
    jcfg = JT.TransformerConfig(**kw,
                                compute_dtype=jnp.bfloat16 if bf16 else None)
    tcfg = T.TransformerConfig(**kw,
                               compute_dtype=torch.bfloat16 if bf16 else None)
    params = JT.init(jcfg, seed=1)
    tok, tgt = _batch(kw["vocab"], 2)
    jl, jg = jax.jit(jax.value_and_grad(JT.loss), static_argnums=3)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tok),
        jnp.asarray(tgt), jcfg)
    tp = params_from_numpy(params, "cpu")
    flat = list(leaves(tp))
    for p in flat:
        p.requires_grad_(True)
    tl = T.loss(tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg)
    tg = torch.autograd.grad(tl, flat, allow_unused=True,
                             materialize_grads=True)
    tl = tl.detach()
    loss_tol, grad_tol = (1e-3, 5e-2) if bf16 else (1e-5, 1e-4)
    assert abs(float(tl) - float(jl)) / abs(float(jl)) <= loss_tol
    for g in tg:
        assert g.dtype == torch.float32       # back on the f32 masters
    assert _worst(unflatten(tp, tg), jax.device_get(jg)) <= grad_tol


def test_eval_loss_drops_label_smoothing():
    kw = CONFIGS["tied-window-smooth-softcap"]
    params = JT.init(JT.TransformerConfig(**kw), seed=1)
    tok, tgt = _batch(kw["vocab"], 3)
    tcfg = T.TransformerConfig(**kw)
    tp = params_from_numpy(params, "cpu")
    args = (tp, torch.from_numpy(tok), torch.from_numpy(tgt), tcfg)
    ref = JT.loss(jax.tree_util.tree_map(jnp.asarray, params),
                  jnp.asarray(tok), jnp.asarray(tgt),
                  JT.TransformerConfig(**kw), train=False)
    got = T.loss(*args, train=False)
    assert float(got) == pytest.approx(float(ref), rel=1e-5)
    assert float(got) != pytest.approx(float(T.loss(*args)), rel=1e-5)


@pytest.mark.parametrize("kwargs", [dict(zero1=True, overlap=True),
                                    dict(zero2=True, overlap=True),
                                    dict(overlap=True),
                                    dict(attn="ring-flash", experts=2)],
                         ids=["zero1", "zero2", "overlap", "ring-flash"])
def test_unported_engine_options_raise(kwargs):
    """The options the engine once refused now train. The overlapped
    reduction (`parallel.overlap`), with ZeRO-1, ZeRO-2 or without, at
    dp 2: its loss and gradient equal overlap off's bit for bit (more
    in `tests/test_torch_overlap_engines.py`). An MoE config at sp > 1
    (ring-flash on a (1, 2) grid), refused until each sp tile routed its
    own tokens: its loss and gradient are the ring substrate's (held
    against the JAX engine in `tests/test_torch_context_mesh.py`)."""
    from shallowspeed_tpu_torch.parallel.overlap import OverlapConfig

    kwargs = dict(kwargs)
    experts = kwargs.pop("experts", 0)
    cfg = T.TransformerConfig(**CONFIGS["gqa-rope-rms-swiglu"],
                              n_experts=experts)
    mesh = make_context_mesh(2 if not experts else 1, 2 if experts else 1,
                             "cpu")
    if not experts:
        tok, tgt = _batch(cfg.vocab, 12, b=4)
        kwargs.pop("overlap")
        on = ContextParallelEngine(
            cfg, O.SGD(0.1), mesh=mesh,
            overlap=OverlapConfig(bucket_mb=0.01), **kwargs)
        off = ContextParallelEngine(cfg, O.SGD(0.1), mesh=mesh, **kwargs)
        (l_on, g_on), (l_off, g_off) = (e.loss_and_grads(tok, tgt)
                                        for e in (on, off))
        assert torch.equal(l_on, l_off)
        assert all(torch.equal(a, b) for a, b in zip(leaves(g_on),
                                                     leaves(g_off)))
        return
    tok, tgt = _batch(cfg.vocab, 12, b=2)
    got = ContextParallelEngine(cfg, O.SGD(0.1), mesh=mesh,
                                **kwargs).loss_and_grads(tok, tgt)
    want = ContextParallelEngine(cfg, O.SGD(0.1), mesh=mesh,
                                 attn="ring").loss_and_grads(tok, tgt)
    assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-5)
    assert _worst(got[1], want[1]) <= 1e-4


# ---------------------------------------------------------- the engine


def test_engine_trajectory_matches_jax_engine():
    """Three steps of `ContextParallelEngine(attn="flash")` (dp = sp = 1)
    against the JAX engine on the same weights and batches: AdamW with
    clipping and a cosine warm-up. Losses, final parameters and Adam
    moments; then the JAX engine's optimizer state crosses into the port
    and back unchanged."""
    kw = dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              max_seq=32, rope=True, norm="rmsnorm", ffn="swiglu")

    def opt(M):
        return M.AdamW(M.warmup_cosine(1e-2, 1, 3), weight_decay=0.01,
                       grad_clip=1.0)

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    je = JaxEngine(JT.TransformerConfig(**kw), opt(JO), mesh, seed=5,
                   attn="flash")
    te = ContextParallelEngine(T.TransformerConfig(**kw), opt(O), seed=5,
                               attn="flash", device="cpu")
    assert _worst(te.get_canonical_params(),
                  jax.device_get(je.params)) == 0.0    # the same draw
    for step in range(3):
        tok, tgt = _batch(64, 10 + step)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-5
    assert _worst(te.params, jax.device_get(je.params),
                  absolute=True) <= 1e-5
    jstate = jax.device_get(je.opt_state)
    assert te.opt_state["t"] == int(jstate["t"]) == 3
    for key in ("m", "v"):
        assert _worst(te.opt_state[key], jstate[key]) <= 1e-4

    crossed = placed_copy(jstate, "cpu")
    assert crossed["t"] == 3 and isinstance(crossed["t"], int)
    back = opt_state_to_numpy(crossed)
    assert back["t"].dtype == np.int32 and int(back["t"]) == 3
    for key in ("m", "v"):
        assert _worst(back[key], jstate[key]) == 0.0


def test_engine_set_params_eval_and_logits():
    cfg = T.TransformerConfig(**CONFIGS["tied-window-smooth-softcap"])
    jcfg = JT.TransformerConfig(**CONFIGS["tied-window-smooth-softcap"])
    params = JT.init(jcfg, seed=9)
    eng = ContextParallelEngine(cfg, O.SGD(0.1), attn="ring", device="cpu")
    eng.set_canonical_params(params)
    tok, tgt = _batch(cfg.vocab, 6)
    ref = JT.loss(jax.tree_util.tree_map(jnp.asarray, params),
                  jnp.asarray(tok), jnp.asarray(tgt), jcfg, train=False)
    assert eng.eval_loss(tok, tgt) == pytest.approx(float(ref), rel=1e-5)
    logits = eng.logits(tok)
    assert logits.shape == (2, 32, cfg.vocab)
    assert all(p.requires_grad for p in leaves(eng.params))


def test_engine_needs_a_card_unless_the_cpu_is_named():
    cfg = T.TransformerConfig(**CONFIGS["gqa-rope-rms-swiglu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContextParallelEngine(cfg, O.SGD(0.1))


# ------------------------------------------------- flops and metrics


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flops_per_token_matches_jax(name):
    from shallowspeed_tpu.flops import (
        transformer_flops_per_token as j_flops)

    kw = CONFIGS[name]
    assert flops.transformer_flops_per_token(T.TransformerConfig(**kw), 32) \
        == j_flops(JT.TransformerConfig(**kw), 32, include_backward=True)


def test_mfu_is_none_on_the_cpu():
    cfg = T.TransformerConfig(**CONFIGS["gqa-rope-rms-swiglu"])
    out = flops.mfu(1000.0, cfg, 32, device="cpu")
    assert out["mfu"] is None and out["peak_tflops"] is None
    assert out["tflops"] == pytest.approx(
        1000.0 * flops.transformer_flops_per_token(cfg, 32) / 1e12)


def test_step_rates_and_event_fields():
    clock = iter([0.0, 2.0, 3.0]).__next__
    rates = metrics.StepRates(100, clock=clock)
    first = rates.log_point(4)                 # 4 steps in 2 s
    second = rates.log_point(1)                # 1 step in 1 s
    assert first["tokens_per_sec"] == pytest.approx(200.0)
    assert second["tokens_per_sec"] == pytest.approx(100.0)
    assert second["tokens_per_sec_cum"] == pytest.approx(500 / 3.0)
    ev = metrics.step_event(3, 1.5, second, {"tflops": 1.0, "mfu": None},
                            {"tflops": 2.0, "mfu": 0.25})
    assert set(ev) == {"event", "step", "loss", "tokens_per_sec", "tflops",
                       "mfu", "tokens_per_sec_cum", "tflops_cum",
                       "mfu_cum"}
    assert ev["event"] == "step" and ev["mfu"] is None


# ---------------------------------------------------------- the driver


def test_make_batch_matches_the_root_driver():
    args = tdriver.parse_args(["--batch-size", "3", "--seq-len", "40",
                               "--seed", "11"])
    for step in (0, 5):
        got = tdriver.make_batch(args, 97, step)
        ref = jdriver.make_batch(args, 97, step)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_driver_trains_on_the_cpu(tmp_path, capsys):
    log = tmp_path / "m.jsonl"
    loss = tdriver.train(tdriver.parse_args([
        "--device", "cpu", "--steps", "4", "--log-every", "2",
        "--seq-len", "32", "--batch-size", "4", "--d-model", "32",
        "--n-heads", "4", "--kv-heads", "2", "--rope", "--norm", "rmsnorm",
        "--ffn", "swiglu", "--optimizer", "adamw", "--grad-clip", "1.0",
        "--lr-schedule", "cosine", "--warmup-steps", "1", "--lr", "1e-2",
        "--log-file", str(log)]))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 3                     # steps 0, 2 and the last
    for ln in lines:
        assert re.fullmatch(r"step +\d+  loss \d+\.\d{4}  tok/s [\d,]+", ln)
    assert np.isfinite(loss)
    import json

    events = [json.loads(x) for x in log.read_text().splitlines()]
    steps = [e for e in events if e["event"] == "step"]
    assert [e["step"] for e in steps] == [0, 2, 3]
    assert steps[-1]["mfu"] is None            # no peak known on the CPU


@pytest.mark.parametrize("flag", sorted(tdriver.UNPORTED))
def test_driver_refuses_unported_flags(flag):
    with pytest.raises(NotPorted, match=re.escape(flag)):
        tdriver.parse_args(["--device", "cpu", flag, "1"])


def _chaos_run(tmp_path, *extra) -> list:
    """Two steps of a tiny CPU `train_lm` with `extra` flags, no fault
    plan before or after it in this process; the log's records."""
    import json

    from shallowspeed_tpu_torch import chaos

    log = tmp_path / "m.jsonl"
    chaos.configure(None)
    try:
        tdriver.main(["--device", "cpu", "--steps", "2", "--seq-len", "16",
                      "--d-model", "16", "--n-heads", "2", "--n-layers",
                      "1", "--batch-size", "2", "--log-every", "1",
                      "--prefetch", "0", "--log-file", str(log), *extra])
    finally:
        chaos.configure(None)
    return [json.loads(x) for x in log.read_text().splitlines()]


def _faults(recs) -> list:
    return [(r["kind"], r.get("step"), r.get("save")) for r in recs
            if r["event"] == "fault"]


def _act_chaos(tmp_path):
    assert _faults(_chaos_run(tmp_path, "--chaos", "stall@1:0.01")) == [
        ("stall", 1, None)]


def _act_chaos_state(tmp_path):
    """The markers live in --chaos-state: a second run with the same
    state fires nothing."""
    cs = tmp_path / "cs"
    assert _faults(_chaos_run(tmp_path, "--chaos", "freeze@0",
                              "--chaos-state", str(cs))) == [
        ("freeze", 0, None)]
    assert (cs / "fired_freeze_at_0").exists()
    (tmp_path / "m.jsonl").unlink()
    assert _faults(_chaos_run(tmp_path, "--chaos", "freeze@0",
                              "--chaos-state", str(cs))) == []


def _act_chaos_seed(tmp_path):
    """The seed draws the corrupted member of the first save as the
    reference's plan draws it."""
    from shallowspeed_tpu import chaos as JCH

    ck = tmp_path / "ck"
    recs = _chaos_run(tmp_path, "--save-dir", str(ck), "--save-every", "1",
                      "--chaos", "corrupt@1", "--chaos-seed", "5")
    fault, = (r for r in recs if r["event"] == "fault")
    ref = JCH.FaultPlan.parse("corrupt@1", seed=5)
    names = ["opt.npz", "params.npz"]
    assert fault["path"] == str(ck / "ckpt_0" / names[int(
        ref._rng(ref.faults[0]).integers(0, len(names)))])
    assert fault["save"] == 1 and fault["mode"] == "bitflip"


def _act_heartbeat(tmp_path):
    hb = tmp_path / "hb"
    _chaos_run(tmp_path, "--heartbeat-file", str(hb))
    assert hb.read_text() == "ok"


def _act_replica(tmp_path):
    start, = (r for r in _chaos_run(tmp_path, "--replica", "r7")
              if r["event"] == "run_start")
    assert start["replica"] == "r7"


CHAOS_ACTS = {"--chaos": _act_chaos, "--chaos-state": _act_chaos_state,
              "--chaos-seed": _act_chaos_seed,
              "--heartbeat-file": _act_heartbeat, "--replica": _act_replica}


@pytest.mark.parametrize("flag", sorted(CHAOS_ACTS))
def test_chaos_flag_acts(tmp_path, flag):
    """Each flag the driver refused with `NotPorted` until the fault
    plane came does what the root driver's does."""
    assert flag not in tdriver.UNPORTED
    CHAOS_ACTS[flag](tmp_path)


def test_driver_needs_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.main(["--steps", "1"])


@pytest.mark.parametrize("attn", ["ring-flash", "ulysses"])
def test_driver_refuses_sequence_parallel_substrates(attn):
    """The sequence-parallel substrates run (tests/test_torch_context_
    mesh.py), with the overlapped reduction too; what stays refused
    around them is the overlapped reduction on the composite engine
    (--sp with --tp), with the root driver's message."""
    with pytest.raises(SystemExit, match="--overlap on supports"):
        tdriver.main(["--device", "cpu", "--steps", "1", "--attn", attn,
                      "--sp", "2", "--tp", "2", "--overlap", "on"])
