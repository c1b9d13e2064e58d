"""The port's fault plane (`shallowspeed_tpu_torch/chaos.py`) against
the JAX package's (`shallowspeed_tpu/chaos.py`) and in the port's
checkpoint writer, on the CPU:

- plans: `parse` (DSL, inline JSON, a JSON file), `to_spec`,
  `export_env`, the environment hand-over of `setup`, once-only firing
  across a restart (the state dir), the refusals — equal to the
  reference's for specs of every kind;
- the seeded draws: the point `kill_in_save` fires at among a save's
  points, and what `corrupt` does to a checkpoint (member, bit, cut,
  deletion: the directories' bytes after it) equal the reference's for
  seeds 0-7 and every mode;
- the fault lines validate under both packages' `schema.validate_file`;
- `nan@N` poisons the leaf of the same path as in the JAX engine, on
  every replica of a dp 2 context engine (leaf order: the JAX package's
  flattening order over the whole tree), and the next gradient is
  non-finite; the pipeline draws over its stacked layout and poisons
  every block's copy; `scale_poison` zeroes the same fp8 layer; the
  instruction VM refuses a poison as the reference's does;
- save faults on `checkpoint.save` and `AsyncSaver`: ENOSPC leaves
  `latest()` untouched; `corrupt` in each mode is caught at restore and
  quarantined.

The kill inside a save (a subprocess) is `test_torch_chaos_save.py`;
the supervised drills `test_torch_chaos_drill.py` and
`test_torch_elastic_gang.py`.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from shallowspeed_tpu import chaos as JCH
from shallowspeed_tpu.telemetry import schema as JS
from shallowspeed_tpu_torch import chaos
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch.chaos import Fault, FaultPlan, leaf_paths
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.models.mlp import MLPStage
from shallowspeed_tpu_torch.optim import SGD
from shallowspeed_tpu_torch.parallel.mesh import make_mesh
from shallowspeed_tpu_torch.telemetry import schema as S
from torch_parity import OPTS, batch, engines, pipeline_engines

SPECS = ["kill@9", "kill_in_save@2", "nan@3", "inf@4", "stall@5:0.5",
         "freeze@6", "enospc@1", "corrupt@2", "corrupt@3:truncate",
         "corrupt@1:delete", "scale_poison@7",
         "kill@9,corrupt@2,stall@5:0.3",
         "stall@4:0.4,kill_in_save@3,corrupt@4,nan@13,freeze@17,"
         "stall@19:45"]


@pytest.fixture(autouse=True)
def _no_ambient_plan(monkeypatch):
    """No plan leaks between tests, or in from the environment."""
    for var in (chaos.ENV_SPEC, chaos.ENV_STATE, chaos.ENV_SEED):
        monkeypatch.delenv(var, raising=False)
    chaos.configure(None)
    JCH.configure(None)
    yield
    chaos.configure(None)
    JCH.configure(None)


def _faults(plan):
    return [(f.kind, f.at, f.arg, f.id) for f in plan.faults]


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("spec", SPECS)
def test_plan_matches_reference(spec, tmp_path):
    ours, ref = (M.FaultPlan.parse(spec, seed=3, state_dir=tmp_path / n)
                 for M, n in ((chaos, "p"), (JCH, "j")))
    assert _faults(ours) == _faults(ref)
    assert ours.to_spec() == ref.to_spec()
    assert FaultPlan.parse(ours.to_spec()).to_spec() == ours.to_spec()
    env = {k: v for k, v in ours.export_env({}).items()}
    assert env == {**ref.export_env({}),
                   chaos.ENV_STATE: str(tmp_path / "p")}
    obj = {"seed": 7, "faults": [{"kind": f.kind, "at": f.at, "arg": f.arg}
                                 for f in ref.faults]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(obj))
    for form in (json.dumps(obj), str(path)):
        a, b = FaultPlan.parse(form), JCH.FaultPlan.parse(form)
        assert (_faults(a), a.seed) == (_faults(b), b.seed) and a.seed == 7


@pytest.mark.parametrize("spec,match", [
    ("explode@3", "unknown fault kind"), ("kill@soon", "not an integer"),
    ("enospc@0", "1-based save"), ("  ,  ", "empty"), ("kill", "bad fault")])
def test_plan_refusals_match_reference(spec, match):
    for M in (chaos, JCH):
        with pytest.raises(ValueError, match=match):
            M.FaultPlan.parse(spec)
    with pytest.raises(ValueError, match="corrupt mode"):
        Fault("corrupt", 1, "scramble")


def test_setup_adopts_the_supervisor_env(tmp_path, monkeypatch):
    p = FaultPlan.parse("kill@4", seed=3, state_dir=tmp_path / "cs")
    for k, v in p.export_env({}).items():
        if k.startswith("SHALLOWSPEED_CHAOS"):
            monkeypatch.setenv(k, v)
    got = chaos.setup(state_dir=tmp_path / "driver_default")
    assert got.to_spec() == "kill@4" and got.seed == 3
    assert got.state_dir == tmp_path / "cs"       # the operator's dir wins
    assert chaos.setup("stall@1:0.1").to_spec() == "stall@1:0.1"
    chaos.configure(None)
    chaos._ENV_CHECKED = False                    # a fresh process
    assert chaos.active().to_spec() == "kill@4"


def test_faults_fire_once_across_restarts(tmp_path):
    state = tmp_path / "cs"
    log = tmp_path / "m.jsonl"
    p1 = FaultPlan.parse("stall@2:0.05,freeze@1", state_dir=state,
                         log_file=log)
    p1.on_step(1)
    p1.on_data_load(2)
    assert p1.heartbeat_frozen() and p1.unfired() == []
    p2 = FaultPlan.parse("stall@2:0.05,freeze@1", state_dir=state)
    assert all(p2.fired(f) for f in p2.faults)
    p2.on_step(1)
    p2.on_data_load(2)
    assert not p2.heartbeat_frozen()
    assert sorted(os.listdir(state)) == sorted(os.listdir(
        _ref_state(tmp_path)))
    assert [json.loads(x)["kind"] for x in log.read_text().splitlines()] \
        == ["freeze", "stall"]


def _ref_state(tmp_path):
    """The reference plan's markers for the same firings."""
    state = tmp_path / "ref_cs"
    p = JCH.FaultPlan.parse("stall@2:0.05,freeze@1", state_dir=state)
    p.on_step(1)
    p.on_data_load(2)
    return state


def test_fault_lines_validate(tmp_path):
    """Every kind's line (stall, freeze, nan, scale_poison, enospc,
    corrupt) validates under both packages' schema."""
    log = tmp_path / "m.jsonl"
    p = FaultPlan.parse("stall@1:0.01,freeze@2,nan@3,scale_poison@3,"
                        "enospc@1,corrupt@2", log_file=log)
    p.on_data_load(1)
    p.on_step(2)

    class Eng:
        params = {"a": torch.ones(3), "b": torch.ones(4)}
        amax_hist = torch.ones(2, 4)

    p.on_step(3, Eng())
    with pytest.raises(OSError):
        p.on_save("start")
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "params.npz").write_bytes(b"x" * 64)
    p.on_save("start")
    p.after_save(ck)
    kinds = [json.loads(x)["kind"] for x in log.read_text().splitlines()]
    assert kinds == ["stall", "freeze", "nan", "scale_poison", "enospc",
                     "corrupt"]
    assert S.validate_file(log) == [] and JS.validate_file(log) == []


# ------------------------------------------------------- seeded draws


class _Killed(Exception):
    pass


def _fire_point(M, seed, monkeypatch):
    """The point at which `kill_in_save@1` of seed `seed` fires in `M`'s
    plan over a save's points (the kill raised instead)."""

    def fake_kill(pid, sig):
        raise _Killed

    monkeypatch.setattr(os, "kill", fake_kill)
    plan = M.FaultPlan.parse("kill_in_save@1", seed=seed)
    plan.on_save("start")
    for point in ("file:params.npz", "file:opt.npz", "file:ema.npz",
                  "pre_rename", "renamed"):
        try:
            plan.on_save(point)
        except _Killed:
            return point
    return None


@pytest.mark.parametrize("seed", range(8))
def test_kill_in_save_point_matches_reference(seed, monkeypatch):
    ours = _fire_point(chaos, seed, monkeypatch)
    assert ours is not None
    assert ours == _fire_point(JCH, seed, monkeypatch)


@pytest.mark.parametrize("mode", [None, "truncate", "delete"])
def test_corrupt_draws_match_reference(mode, tmp_path):
    """The same member, bit and cut as the reference's plan, on the same
    bytes, for seeds 0-7: the two directories end equal."""
    rng = np.random.default_rng(0)
    names = ("ema.npz", "opt.npz", "params.npz")
    spec = "corrupt@1" + (f":{mode}" if mode else "")
    for seed in range(8):
        dirs = []
        for M, tag in ((chaos, "p"), (JCH, "j")):
            d = tmp_path / f"{tag}{seed}"
            d.mkdir()
            for i, n in enumerate(names):
                (d / n).write_bytes(rng.bytes(100 + 37 * i) if tag == "p"
                                    else (tmp_path / f"orig{seed}" / n)
                                    .read_bytes())
            log = tmp_path / f"{tag}{seed}.jsonl"
            if tag == "p":
                shutil.copytree(d, tmp_path / f"orig{seed}")
            plan = M.FaultPlan.parse(spec, seed=seed, log_file=log)
            plan.on_save("start")
            plan.after_save(d)
            dirs.append(d)
        got = {p.name: p.read_bytes() for p in dirs[0].iterdir()}
        ref = {p.name: p.read_bytes() for p in dirs[1].iterdir()}
        assert got == ref
        orig = {p.name: p.read_bytes()
                for p in (tmp_path / f"orig{seed}").iterdir()}
        assert got != orig
        a, b = (json.loads((tmp_path / f"{t}{seed}.jsonl").read_text())
                for t in ("p", "j"))
        assert (os.path.basename(a["path"]), a["mode"], a["save"]) == \
            (os.path.basename(b["path"]), b["mode"], b["save"])


# ------------------------------------------------------------- poison


def _jax_paths(tree):
    return [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in kp)
            for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _nonfinite(pairs):
    return [p for p, x in pairs if not np.all(np.isfinite(np.asarray(x)))]


def test_nan_poison_matches_the_jax_engine():
    """The leaf order is the JAX package's over the whole tree, so the
    same plan and seed poison the same path; the port poisons it on
    each of its two replicas; the next gradient is non-finite in both
    packages."""
    from shallowspeed_tpu_torch import optim as O
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.parallel.context import (
        ContextParallelEngine)
    from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh
    from torch_parity import MODEL, jax_loss_and_grads

    opt = OPTS["momentum"][0]
    je, _ = engines(1, 1, "ring", opt)
    te = ContextParallelEngine(T.TransformerConfig(**MODEL), opt(O), seed=5,
                               attn="ring",
                               mesh=make_context_mesh(2, 1, "cpu"))
    paths = list(leaf_paths(te.params))
    assert paths == _jax_paths(je.params)
    for seed in range(6):       # the draws agree (poisons nothing)
        ref = JCH.FaultPlan.parse("nan@1", seed=seed)
        ours = FaultPlan.parse("nan@1", seed=seed)
        assert (ours._rng(ours.faults[0]).integers(0, len(paths))
                == ref._rng(ref.faults[0]).integers(0, len(paths)))
    ref_plan = JCH.FaultPlan.parse("inf@1", seed=4)
    ref_plan.on_step(1, je)
    FaultPlan.parse("inf@1", seed=4).on_step(1, te)
    want = _nonfinite(zip(_jax_paths(je.params),
                          jax.tree_util.tree_leaves(
                              jax.device_get(je.params))))
    assert len(want) == 1
    for rep in te.param_copies():
        assert _nonfinite((p, chaos._at(rep, p).detach())
                          for p in leaf_paths(rep)) == want
    tok, tgt = batch(MODEL["vocab"], 11, b=4)
    _, jg = jax_loss_and_grads(je, tok, tgt)
    assert _nonfinite(zip(_jax_paths(jg), jax.tree_util.tree_leaves(jg)))
    _, tg = te.loss_and_grads(tok, tgt)
    assert _nonfinite((p, chaos._at(tg, p).detach())
                      for p in leaf_paths(tg))


def test_pipeline_poison_draws_over_the_stacked_layout():
    """The pipeline's draw is over the reference engine's layout (the
    blocks stacked); the leaf goes non-finite in every block, as the
    JAX engine's stacked leaf does."""
    je, te = pipeline_engines(1, 2)
    assert list(leaf_paths(te.layout_params)) == _jax_paths(je.params)
    JCH.FaultPlan.parse("nan@0", seed=2).on_step(0, je)
    FaultPlan.parse("nan@0", seed=2).on_step(0, te)
    want = _nonfinite(zip(_jax_paths(je.params), jax.tree_util.tree_leaves(
        jax.device_get(je.params))))
    got = te.layout_params
    assert len(want) == 1
    assert _nonfinite((p, chaos._at(got, p).detach())
                      for p in leaf_paths(got)) == want
    canon = te.get_canonical_params()
    bad = _nonfinite((p, chaos._at(canon, p).detach())
                     for p in leaf_paths(canon))
    if want[0][0] == "blocks":
        assert bad == [("blocks", i) + want[0][1:]
                       for i in range(te.cfg.n_layers)]
    else:
        assert bad == want


def test_scale_poison_matches_reference():
    from shallowspeed_tpu.fp8 import Fp8TrainEngine as JFp8
    from shallowspeed_tpu.optim import SGD as JSGD
    from shallowspeed_tpu_torch.fp8 import Fp8TrainEngine

    sizes = [16, 12, 10, 8]
    for seed in range(4):
        je, te = JFp8(sizes, JSGD(0.1)), Fp8TrainEngine(sizes, SGD(0.1),
                                                        device="cpu")
        JCH.FaultPlan.parse("scale_poison@0", seed=seed).on_step(0, je)
        FaultPlan.parse("scale_poison@0", seed=seed).on_step(0, te)
        np.testing.assert_array_equal(te.amax_hist.numpy(),
                                      np.asarray(je.amax_hist))
        assert (te.amax_hist == 0).all(dim=1).sum() == 1


def test_poison_refusals_match_reference():
    """The instruction VM's `params` is a read-only view (the
    reference's too); nan needs an engine; scale_poison an fp8 one."""
    from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor

    sizes = [784, 16, 15, 10]
    vm = PipelineExecutor(make_mesh(1, 2, "cpu"),
                          [MLPStage(sizes, s, 2, batch_size=8)
                           for s in range(2)], SGD(0.1))
    with pytest.raises(RuntimeError, match="read-only view"):
        FaultPlan.parse("nan@0").on_step(0, vm)
    for spec, match in (("nan@0", "needs an engine"),
                        ("scale_poison@0", "needs an engine")):
        with pytest.raises(RuntimeError, match=match):
            FaultPlan.parse(spec).on_step(0)
    with pytest.raises(RuntimeError, match="amax_hist"):
        FaultPlan.parse("scale_poison@0").on_step(0, vm)


# ---------------------------------------------------------- save faults


SIZES = [784, 16, 15, 10]


def _engine():
    return FusedDPEngine(MLPStage(SIZES, 0, 1, batch_size=8), SGD(0.5),
                         make_mesh(1, 1, "cpu"))


def _save(ck, eng, epoch, use_async):
    if not use_async:
        return C.save(ck, eng, epoch)
    saver = C.AsyncSaver()
    try:
        saver.save(ck, eng, epoch)
        saver.wait()
    finally:
        saver.close()


@pytest.mark.parametrize("use_async", [False, True])
def test_enospc_leaves_latest_untouched(tmp_path, use_async):
    eng = _engine()
    ck = tmp_path / "ck"
    chaos.configure(FaultPlan.parse("enospc@2"))
    _save(ck, eng, 0, use_async)
    err = OSError if not use_async else RuntimeError
    with pytest.raises(err) as e:
        _save(ck, eng, 1, use_async)
    cause = e.value if not use_async else e.value.__cause__
    assert "ENOSPC" in str(cause) or "space" in str(cause)
    assert C.latest(ck).name == "ckpt_0"
    assert not (ck / "ckpt_1.tmp").exists()
    _save(ck, eng, 2, use_async)             # fired once only
    assert C.latest(ck).name == "ckpt_2"


@pytest.mark.parametrize("use_async", [False, True])
@pytest.mark.parametrize("mode", ["bitflip", "truncate", "delete"])
def test_corrupt_is_caught_at_restore(tmp_path, mode, use_async):
    eng = _engine()
    log = tmp_path / "m.jsonl"
    chaos.configure(FaultPlan.parse(f"corrupt@2:{mode}", seed=1,
                                    log_file=log))
    _save(tmp_path, eng, 0, use_async)
    _save(tmp_path, eng, 1, use_async)       # save 2: corrupted post-hoc
    fault = json.loads(log.read_text())
    assert fault["kind"] == "corrupt" and fault["mode"] == mode
    assert os.path.dirname(fault["path"]) == str(tmp_path / "ckpt_1")
    with pytest.warns(UserWarning, match="quarantined"):
        nxt, path, quarantined = C.restore_latest(_engine(), tmp_path)
    assert (nxt, path.name) == (1, "ckpt_0")
    assert quarantined == [tmp_path / "ckpt_1.corrupt"]
