"""The port's health pack, monitors and guard against the JAX package's,
on the CPU:

- `telemetry.health`'s `grad_health` / `update_health` / `merge_packs`
  on the same trees (norms within 1e-6 relative, counts and groups
  equal), and the verdict sequences of `AnomalyDetector`,
  `HealthMonitor` and `NumericsMonitor` on the same series — EQUAL
  (pure host arithmetic in both packages);
- `optim._Optimizer.guarded_step`: a skip leaves every parameter and
  state leaf bit-identical, a pass equals `step`, for SGD, momentum,
  AdamW and Adafactor (with and without a schedule);
- each engine's monitor pack after two steps against its JAX engine's
  (fused dp 1 and 2, the VM at pp 2, SPMD at pp 2, the LM and MoE
  engines): norms within 1e-4 relative (the trajectories agree to the
  cross-engine bound, tests/test_torch_mlp_engines.py), counts equal;
- the guard on every engine: a poisoned step is skipped bit for bit,
  the VM's stages in lockstep, the counters count it;
- the drivers: `train --health guard` per MLP engine against the root
  driver's health records, and `train_lm --health monitor|guard`.
"""

import json
import math
import signal
import sys
import types
from copy import deepcopy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.data.dataset import Dataset as JDataset
from shallowspeed_tpu.engine import FusedDPEngine as JFused
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.models.mlp import MLPStage as JStage
from shallowspeed_tpu.parallel import schedules as JS
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JContext)
from shallowspeed_tpu.parallel.expert import ExpertParallelEngine as JExpert
from shallowspeed_tpu.parallel.mesh import make_mesh as j_mesh
from shallowspeed_tpu.parallel.spmd_pipeline import (
    SPMDPipelineEngine as JSpmd)
from shallowspeed_tpu.parallel.worker import PipelineExecutor as JVM
from shallowspeed_tpu.telemetry import anomaly as JA
from shallowspeed_tpu.telemetry import health as JH
from shallowspeed_tpu.telemetry import numerics as JN
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch import train as driver
from shallowspeed_tpu_torch import train_lm as lm_driver
from shallowspeed_tpu_torch.data.dataset import Dataset
from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.mlp import MLPStage
from shallowspeed_tpu_torch.parallel import schedules as S
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.expert import ExpertParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_mesh
from shallowspeed_tpu_torch.parallel.spmd_pipeline import SPMDPipelineEngine
from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor
from shallowspeed_tpu_torch.telemetry import anomaly as A
from shallowspeed_tpu_torch.telemetry import health as H
from shallowspeed_tpu_torch.telemetry import numerics as N
from shallowspeed_tpu_torch.weights import leaves, params_from_numpy

from torch_parity import batch

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------------------ pack arithmetic


def _trees(kind, seed, nan=False):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if kind == "list":
        mk = lambda: [{"W": a(6, 5), "b": a(5)}, {"W": a(5, 3), "b": a(3)}]
    else:
        mk = lambda: {"tok_emb": a(7, 4), "blocks": [{"W": a(4, 4)}],
                      "head": {"W": a(4, 7), "b": a(7)}}
    params, grads, new = mk(), mk(), mk()
    if nan:
        first = grads[0]["W"] if kind == "list" else grads["head"]["b"]
        first.reshape(-1)[:3] = [np.nan, np.inf, -np.inf]
    return params, grads, new


def _close(got, ref, rel=1e-6):
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, dict):
            _close(got[k], v, rel)
        elif isinstance(v, list):
            np.testing.assert_allclose(got[k], v, rtol=rel)
        elif isinstance(v, float) and math.isnan(v):
            assert math.isnan(got[k])
        else:
            assert got[k] == pytest.approx(v, rel=rel), k


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("kind", ["list", "dict"])
def test_pack_matches_the_reference(kind, nan):
    params, grads, new = _trees(kind, 1, nan)
    jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    ref = JH.update_health(JH.grad_health(jt(params), jt(grads)),
                           jt(params), jt(new), skipped=jnp.int32(nan))
    tp = params_from_numpy(params, "cpu")
    pack = H.grad_health(tp, params_from_numpy(grads, "cpu"))
    got = H.update_health(pack, H.snapshot(tp),
                          params_from_numpy(new, "cpu"),
                          skipped=torch.tensor(int(nan)))
    _close(H.fetch_pack(got), JH.fetch_pack(ref))
    assert H.fetch_pack(got)["nonfinite"] == (3 if nan else 0)


def test_merge_packs_matches_the_reference():
    packs = []
    for seed in range(3):
        p, g, n = _trees("list", seed, nan=seed == 1)
        jt = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
        packs.append(JH.fetch_pack(JH.update_health(
            JH.grad_health(jt(p), jt(g)), jt(p), jt(n),
            skipped=jnp.int32(1))))
    # the same host arithmetic (NaN included: compared as JSON text)
    assert json.dumps(H.merge_packs(packs), sort_keys=True) == \
        json.dumps(JH.merge_packs(packs), sort_keys=True)
    assert H.merge_packs([None, {}]) is None
    np.testing.assert_allclose(H.param_l2(params_from_numpy(p, "cpu")),
                               float(JH.param_l2(jt(p))), rtol=1e-6)


# --------------------------------------------------------- monitors


def _series(seed, n=60):
    """A loss / grad-norm / group series with spikes, a dead group, a
    non-finite step and a late divergence."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        loss = 2.0 * math.exp(-s / 30) + 0.01 * rng.standard_normal()
        gn = 1.0 + 0.05 * rng.standard_normal()
        if s in (20, 33):
            loss *= 5
        if s == 26:
            gn *= 40
        if s > 48:
            loss = 3.0 + 0.1 * s
        groups = {"layer0": gn * 0.7, "layer1": 0.0 if 10 <= s < 16 else 0.3}
        pack = {"grad_norm": gn, "param_norm": 10.0, "nonfinite":
                4 if s == 40 else 0, "groups": groups,
                "update_ratio": 1e-3, "nonfinite_steps_total": int(s >= 40),
                "skipped_total": int(s >= 40)}
        out.append((s, float("nan") if s == 44 else loss, pack))
    return out


def _verdicts(vs):
    return [(v.kind, v.step, v.severity, v.action, v.detail) for v in vs]


@pytest.mark.parametrize("mode", ["monitor", "guard"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_monitor_verdicts_equal_the_reference(seed, mode):
    ref = JH.HealthMonitor(policy=JA.GuardPolicy.for_mode(mode))
    got = H.HealthMonitor(policy=A.GuardPolicy.for_mode(mode))
    for step, loss, pack in _series(seed):
        assert _verdicts(got.observe(step, loss, dict(pack))) == \
            _verdicts(ref.observe(step, loss, dict(pack)))
        if step % 7 == 0:
            assert got.step_fields() == ref.step_fields()
        assert got.heartbeat_status() == ref.heartbeat_status()
        assert got.unhealthy() == ref.unhealthy()


@pytest.mark.parametrize("seed", [3, 4])
def test_anomaly_detector_verdicts_equal_the_reference(seed):
    kw = dict(spike_z=4.0, patience=2, warmup=4)
    ref, got = JA.AnomalyDetector(**kw), A.AnomalyDetector(**kw)
    for step, loss, pack in _series(seed):
        assert _verdicts(got.observe(step, loss, pack)) == \
            _verdicts(ref.observe(step, loss, pack))


@pytest.mark.parametrize("mode", ["monitor", "guard"])
@pytest.mark.parametrize("seed", [5, 6])
def test_numerics_monitor_verdicts_equal_the_reference(seed, mode):
    rng = np.random.default_rng(seed)
    pol = "guard" if mode == "guard" else "monitor"
    ref = JN.NumericsMonitor(policy=JA.GuardPolicy.for_mode(pol))
    got = N.NumericsMonitor(policy=A.GuardPolicy.for_mode(pol))
    for step in range(50):
        scales = list(np.exp2(rng.normal(-7, 0.3 if step < 30 else 2, 3)))
        if step in (12, 13, 31):
            scales[1] = 1e-12
        pack = {"fp8_scale": scales, "fp8_amax": list(rng.random(3) * 9),
                "fp8_overflow": list(rng.random(3) * 0.01),
                "fp8_underflow": list(rng.random(3) * 0.01)}
        assert _verdicts(got.observe(step, pack)) == \
            _verdicts(ref.observe(step, pack))
        if step % 4 == 0:
            par = {"parity_loss_rel": float(abs(rng.normal(0.01, 0.03))),
                   "parity_grad_relmax": float(rng.random() * 2.2)}
            assert _verdicts(got.note_parity(step, par)) == \
                _verdicts(ref.note_parity(step, par))
        if step == 20:
            got.note_fallback()
            ref.note_fallback()
        if step % 5 == 0:
            assert got.step_fields() == ref.step_fields()


# ------------------------------------------------------ guarded_step

OPTS = {
    "sgd": lambda: O.SGD(0.1),
    "sgd-sched": lambda: O.SGD(O.warmup_linear(0.1, 2, 10)),
    "momentum": lambda: O.MomentumSGD(0.1),
    "momentum-sched": lambda: O.MomentumSGD(O.warmup_cosine(0.1, 2, 10)),
    "adamw": lambda: O.AdamW(1e-2, grad_clip=1.0),
    "adafactor": lambda: O.Adafactor(1e-2, beta1=0.9),
}


def _state_copy(tree):
    return [t.clone() if isinstance(t, torch.Tensor) else t
            for t in leaves(tree)]


def _same(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(OPTS))
def test_guarded_step_skips_bit_for_bit(name):
    opt = OPTS[name]()
    rng = np.random.default_rng(0)
    mk = lambda: {"W": torch.from_numpy(  # noqa: E731
        rng.standard_normal((6, 4)).astype(np.float32)),
        "b": [torch.from_numpy(rng.standard_normal(4).astype(np.float32))]}
    params = mk()
    state = opt.init(params)
    params, state = opt.step(params, mk(), state)        # a real history
    before = _state_copy((params, state))
    bad = mk()
    bad["W"][1, 2] = float("nan")
    params, state = opt.guarded_step(params, bad, state, torch.tensor(False))
    assert _same(_state_copy((params, state)), before)
    # a pass is the plain step, bit for bit
    twin_p = {"W": params["W"].clone(), "b": [params["b"][0].clone()]}
    twin_s = deepcopy(state)
    g = mk()
    gc = {"W": g["W"].clone(), "b": [g["b"][0].clone()]}
    params, state = opt.guarded_step(params, g, state, torch.tensor(True))
    twin_p, twin_s = opt.step(twin_p, gc, twin_s)
    assert _same(_state_copy((params, state)), _state_copy((twin_p, twin_s)))
    # a host bool (the VM's decision) skips outright
    before = _state_copy((params, state))
    params, state = opt.guarded_step(params, bad, state, False)
    assert _same(_state_copy((params, state)), before)


@pytest.mark.parametrize("name", list(OPTS))
def test_step_replicas_with_health_guard_skips_bit_for_bit(name):
    """`step_replicas_with_health` under guard on two replicas: a NaN
    gradient leaves both replicas' parameters and state bit for bit
    (replica 0 restored from the pack's own parameter snapshot), the
    pack counts the skip with a zero update ratio; a finite gradient is
    the plain step on both."""
    opt = OPTS[name]()
    rng = np.random.default_rng(1)
    mk = lambda: {"W": torch.from_numpy(  # noqa: E731
        rng.standard_normal((6, 4)).astype(np.float32)),
        "b": [torch.from_numpy(rng.standard_normal(4).astype(np.float32))]}
    p0 = mk()
    reps = [p0, deepcopy(p0)]
    states = [opt.init(p) for p in reps]
    g = mk()
    pack = H.step_replicas_with_health(opt, reps, [g, deepcopy(g)], states,
                                       "guard")
    assert int(pack["skipped"]) == 0
    before = [_state_copy((p, st)) for p, st in zip(reps, states)]
    bad = mk()
    bad["W"][2, 1] = float("inf")
    pack = H.step_replicas_with_health(opt, reps, [bad, deepcopy(bad)],
                                       states, "guard")
    assert int(pack["skipped"]) == 1 and float(pack["update_ratio"]) == 0.0
    for r in range(2):
        assert _same(_state_copy((reps[r], states[r])), before[r])
    twin_p, twin_s = deepcopy(reps[0]), deepcopy(states[0])
    g = mk()
    gs = [deepcopy(g) for _ in range(3)]    # a step may clip in place
    H.step_replicas_with_health(opt, reps, gs[:2], states, "guard")
    twin_p, twin_s = opt.step(twin_p, gs[2], twin_s)
    for r in range(2):
        assert _same(_state_copy((reps[r], states[r])),
                     _state_copy((twin_p, twin_s)))


# ------------------------------------------------------- the engines

SIZES = [784, 32, 31, 30, 29, 28, 27, 10]
GBS = 64
N_MU = 4
LR = 0.5


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_health")
    prepare_mnist(d, synthetic=True, n_samples=1024)
    return d


def _datasets(data_dir, dp, port=True):
    cls = Dataset if port else JDataset
    mubs = GBS // dp // N_MU
    return [cls(data_dir, GBS, mubs).load(r, dp) for r in range(dp)]


def _mlp(kind, dp, pp, health, port=True, opt=None):
    if port:
        mesh, opt = make_mesh(dp, pp, "cpu"), opt or O.SGD(LR)
        fused, vm, spmd, stage = (FusedDPEngine, PipelineExecutor,
                                  SPMDPipelineEngine, MLPStage)
    else:
        mesh, opt = j_mesh(dp, pp), JO.SGD(LR)
        fused, vm, spmd, stage = JFused, JVM, JSpmd, JStage
    if kind == "fused":
        return fused(stage(SIZES, 0, 1, batch_size=GBS), opt, mesh,
                     health=health)
    if kind == "spmd":
        return spmd(SIZES, opt, mesh, N_MU, GBS // dp // N_MU, GBS,
                    health=health)
    return vm(mesh, [stage(SIZES, s, pp, batch_size=GBS) for s in range(pp)],
              opt, health=health)


def _mlp_step(eng, kind, b, ds, port=True):
    if kind == "vm":
        eng.train_batch((S if port else JS).GPipeSchedule, N_MU, b, ds)
    else:
        eng.train_batch(b, ds)


MLP_LAYOUTS = {"fused_dp1": ("fused", 1, 1), "fused_dp2": ("fused", 2, 1),
               "vm_pp2": ("vm", 1, 2), "vm_dp2_pp2": ("vm", 2, 2),
               "spmd_pp2": ("spmd", 1, 2)}


def _pack_close(got, ref, rel=1e-4):
    assert got.keys() == ref.keys()
    for k in ("grad_norm", "param_norm", "update_ratio"):
        assert got[k] == pytest.approx(ref[k], rel=rel), k
    for k in ("nonfinite", "skipped", "skipped_total",
              "nonfinite_steps_total"):
        assert got.get(k) == ref.get(k), k
    assert got["groups"].keys() == ref["groups"].keys()
    for k, v in ref["groups"].items():
        assert got["groups"][k] == pytest.approx(v, rel=rel, abs=1e-9), k


@pytest.mark.parametrize("mode", ["monitor", "guard"])
@pytest.mark.parametrize("layout", list(MLP_LAYOUTS))
def test_mlp_engine_pack_matches_jax(data_dir, layout, mode):
    kind, dp, pp = MLP_LAYOUTS[layout]
    je = _mlp(kind, dp, pp, mode, port=False)
    pe = _mlp(kind, dp, pp, mode)
    jds, pds = _datasets(data_dir, dp, False), _datasets(data_dir, dp)
    assert pe.health_snapshot() is None
    for b in range(2):
        _mlp_step(je, kind, b, jds, port=False)
        _mlp_step(pe, kind, b, pds)
    _pack_close(pe.health_snapshot(), je.health_snapshot())


class _Poisoned:
    """A Dataset whose inputs of batch `bad` are NaN."""

    def __init__(self, ds, bad):
        self._ds, self._bad = ds, bad

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def load_micro_batch_input(self, batch_id, mu):
        x = self._ds.load_micro_batch_input(batch_id, mu)
        return x * np.nan if batch_id == self._bad else x

    def load_mubatch_stack(self, batch_id):
        x, y = self._ds.load_mubatch_stack(batch_id)
        return (x * np.nan if batch_id == self._bad else x), y


def _snap(eng):
    return _state_copy((eng.replicas(), eng.opt_state))


@pytest.mark.parametrize("layout", list(MLP_LAYOUTS))
def test_mlp_guard_skips_a_poisoned_batch(data_dir, layout):
    """Batch 1's inputs are NaN: under guard the step leaves every
    replica's parameters and optimizer state bit for bit (momentum, so
    the state is real), the counters count one skip, and the next
    batch trains again."""
    kind, dp, pp = MLP_LAYOUTS[layout]
    eng = _mlp(kind, dp, pp, "guard", opt=O.MomentumSGD(LR))
    ds = [_Poisoned(d, 1) for d in _datasets(data_dir, dp)]
    _mlp_step(eng, kind, 0, ds)
    before = _snap(eng)
    _mlp_step(eng, kind, 1, ds)
    assert _same(_snap(eng), before)
    snap = eng.health_snapshot()
    assert snap["skipped"] == 1 and snap["skipped_total"] == 1
    assert snap["nonfinite"] > 0 and snap["nonfinite_steps_total"] == 1
    _mlp_step(eng, kind, 2, ds)
    assert not _same(_snap(eng), before)
    snap = eng.health_snapshot()
    assert snap["skipped"] == 0 and snap["skipped_total"] == 1


def test_vm_stages_skip_in_lockstep(data_dir):
    """Only the last stage's gradients are poisoned: the first stage's
    are finite, yet both stages skip the update."""
    eng = _mlp("vm", 1, 2, "guard")
    last = eng.runtimes[-1]
    orig = last.backward

    def poisoned(douts, mubatch_id, allreduce):
        out = orig(douts, mubatch_id, allreduce)
        if allreduce:
            last.reduced_grads[0][0]["W"][0, 0] = float("nan")
            last.last_pack = H.grad_health(last.replicas[0],
                                           last.reduced_grads[0])
        return out

    last.backward = poisoned
    ds = _datasets(data_dir, 1)
    before = _snap(eng)
    _mlp_step(eng, "vm", 0, ds)
    assert _same(_snap(eng), before)
    assert int(eng.runtimes[0].last_pack["nonfinite"]) == 0
    snap = eng.health_snapshot()
    assert snap["skipped"] == 1 and snap["nonfinite"] == 1


# LM engines
LM = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          max_seq=16, rope=True, norm="rmsnorm", ffn="swiglu")
MOE = dict(LM, n_experts=4, moe_top_k=2)


def _lm(kind, mode, port=True):
    cfg = MOE if kind == "moe" else LM
    if port:
        cls = ExpertParallelEngine if kind == "moe" else ContextParallelEngine
        kw = {} if kind == "moe" else dict(attn="flash")
        return cls(T.TransformerConfig(**cfg), O.MomentumSGD(0.05), seed=2,
                   device="cpu", health=mode, **kw)
    axes = ("dp", "ep") if kind == "moe" else ("dp", "sp")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), axes)
    if kind == "moe":
        return JExpert(JT.TransformerConfig(**cfg), JO.MomentumSGD(0.05),
                       mesh, seed=2, health=mode)
    return JContext(JT.TransformerConfig(**cfg), JO.MomentumSGD(0.05), mesh,
                    seed=2, attn="flash", health=mode)


@pytest.mark.parametrize("mode", ["monitor", "guard"])
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_lm_engine_pack_matches_jax(kind, mode):
    je, pe = _lm(kind, mode, port=False), _lm(kind, mode)
    for step in range(2):
        tok, tgt = batch(64, 30 + step, b=2, t=16)
        je.train_batch(tok, tgt)
        pe.train_batch(tok, tgt)
    _pack_close(pe.health_snapshot(), je.health_snapshot())


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_lm_guard_skips_a_poisoned_step(kind):
    eng = _lm(kind, "guard")
    tok, tgt = batch(64, 1, b=2, t=16)
    eng.train_batch(tok, tgt)
    before = _state_copy((eng.params, eng.opt_state))
    # the MoE engine (the GSPMD family) reduces its gradient as blocks
    hook = "_reduced" if kind == "moe" else "loss_and_grads"
    orig = getattr(eng, hook)

    def poisoned(tok, tgt):
        loss, grads = orig(tok, tgt)
        first = (next(iter(grads[0].values())) if kind == "moe"
                 else next(iter(leaves(grads))))
        first.view(-1)[0] = float("nan")
        return loss, grads

    setattr(eng, hook, poisoned)
    eng.train_batch(tok, tgt)
    assert _same(_state_copy((eng.params, eng.opt_state)), before)
    snap = eng.health_snapshot()
    assert snap["skipped_total"] == 1 and snap["nonfinite"] == 1
    setattr(eng, hook, orig)
    eng.train_batch(tok, tgt)
    assert not _same(_state_copy((eng.params, eng.opt_state)), before)
    assert eng.health_snapshot()["skipped"] == 0


def test_engines_refuse_unknown_modes():
    with pytest.raises(ValueError, match="health"):
        _mlp("fused", 1, 1, "loud")
    with pytest.raises(ValueError, match="health"):
        _lm("dense", "loud")


# ------------------------------------------------------- the drivers


@pytest.fixture
def root_train(monkeypatch):
    """The root driver's `train`, its walker-importing overlap module
    stood in for (`tests/test_torch_mlp_driver.py`)."""
    monkeypatch.setitem(sys.modules, "shallowspeed_tpu.parallel.overlap",
                        types.SimpleNamespace(from_flags=lambda m, b: None))
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("train", None)
    import train as root

    handler = signal.getsignal(signal.SIGTERM)
    try:
        yield lambda argv: root.train(root.parse_args(argv))
    finally:
        signal.signal(signal.SIGTERM, handler)
        sys.modules.pop("train", None)


def _events(path, kind):
    return [e for e in map(json.loads, Path(path).read_text().splitlines())
            if e["event"] == kind]


@pytest.mark.parametrize("argv", [[], ["--pp", "2", "--schedule", "gpipe"],
                                  ["--pp", "2", "--engine", "vm"]],
                         ids=["fused", "spmd", "vm"])
def test_mlp_driver_health_matches_the_root_driver(data_dir, tmp_path,
                                                   root_train, argv):
    """`train --health guard` over 2 epochs of 3 batches: the `health`
    records (norms within 1e-4, counts equal, no verdicts) and the
    accuracies as the root driver's."""
    base = ["--batch-size", str(GBS), "--max-batches", "3", "--epochs",
            "2", "--health", "guard", "--data-dir", str(data_dir), *argv]
    rlog, plog = tmp_path / "r.jsonl", tmp_path / "p.jsonl"
    ref = root_train(base + ["--log-file", str(rlog)])
    got, _ = driver.train(driver.parse_args(
        base + ["--log-file", str(plog), "--device", "cpu"]))
    assert got == pytest.approx(ref, abs=1e-9)
    rh, ph = _events(rlog, "health"), _events(plog, "health")
    assert len(ph) == len(rh) == 2
    for r, p in zip(rh, ph):
        for k in ("t", "wall", "mono"):
            r.pop(k), p.pop(k)
        assert p.keys() == r.keys()
        for k, v in r.items():
            assert p[k] == pytest.approx(v, rel=1e-4), k


@pytest.mark.parametrize("mode", ["monitor", "guard"])
def test_lm_driver_health(tmp_path, mode, capsys):
    log = tmp_path / "m.jsonl"
    lm_driver.main(["--device", "cpu", "--steps", "4", "--seq-len", "16",
                    "--d-model", "32", "--n-layers", "2", "--n-heads", "2",
                    "--log-every", "2", "--health", mode,
                    "--log-file", str(log)])
    steps = _events(log, "step")
    assert [e["step"] for e in steps] == [0, 2, 3]
    for e in steps:
        assert e["health_nonfinite"] == 0 and e["health_skipped_total"] == 0
        assert e["health_grad_norm"] > 0 and e["health_update_ratio"] > 0
    assert "[health]" not in capsys.readouterr().out


def test_lm_driver_aborts_on_a_policy_abort(tmp_path, monkeypatch):
    """A verdict whose policy action is `abort` ends the run with the
    root driver's message."""
    monkeypatch.setattr(A.GuardPolicy, "for_mode", classmethod(
        lambda cls, mode: cls(nonfinite="abort", loss_spike="abort",
                              grad_spike="abort", divergence="abort",
                              dead_layer="abort")))
    monkeypatch.setattr(H.HealthMonitor, "observe",
                        lambda self, step, loss, pack: [
                            A.Verdict("divergence", step, "forced",
                                      action="abort")])
    with pytest.raises(SystemExit, match="health policy abort at step 0"):
        lm_driver.main(["--device", "cpu", "--steps", "3", "--seq-len",
                        "16", "--d-model", "32", "--n-layers", "1",
                        "--n-heads", "2", "--health", "guard"])
