"""The port's MLP driver (`shallowspeed_tpu_torch.train`) against the
root `train.py` (the JAX driver), and checkpoints across the packages,
on the CPU with 1,024 synthetic samples, global batch 64:

- `train.main` against the root `train.train` with `--epochs 1
  --max-batches 4` on the same files: the same per-epoch and final
  accuracy, and final parameters (their `--save-dir` checkpoints)
  within the JAX package's cross-engine bound (rtol 2e-4, atol 2e-6);
- every root flag the port lacks raises `NotPorted`, and a scan of the
  root source finds no flag that neither side names;
- checkpoints cross both ways, also across layouts through the
  canonical optimizer record (momentum and Adam, so the state is not
  empty): the restored parameters and moments equal the writer's bit
  for bit, and a restored run continues on the writer's trajectory;
- a save at epoch 1 and a `--resume` to epoch 2 equals a straight
  2-epoch run bit for bit; `--auto-resume`; exit 65 when every
  checkpoint is corrupt; no card and no `--device cpu` raises.

The root driver imports `shallowspeed_tpu.parallel.overlap`, whose
`analysis.walker` reads `jax.core.ClosedJaxpr`, gone in jax 0.9
(ROADMAP, reference-side state); the tests stand a module in for it
whose `from_flags` returns the "off" plan (None), which is what the
root driver gets from it without `--overlap on`.
"""

import json
import re
import signal
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu.engine import FusedDPEngine as JFused
from shallowspeed_tpu.models.mlp import MLPStage as JStage
from shallowspeed_tpu.optim import Adam as JAdam
from shallowspeed_tpu.optim import MomentumSGD as JMomentum
from shallowspeed_tpu.parallel import schedules as JS
from shallowspeed_tpu.parallel.mesh import make_mesh as j_mesh
from shallowspeed_tpu.parallel.spmd_pipeline import (
    SPMDPipelineEngine as JSpmd)
from shallowspeed_tpu.parallel.worker import PipelineExecutor as JVM
from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import train as driver
from shallowspeed_tpu_torch.data.dataset import Dataset
from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.models.mlp import MLPStage
from shallowspeed_tpu_torch.optim import Adam, MomentumSGD
from shallowspeed_tpu_torch.parallel import schedules as S
from shallowspeed_tpu_torch.parallel.mesh import make_mesh
from shallowspeed_tpu_torch.parallel.spmd_pipeline import SPMDPipelineEngine
from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor

ROOT = Path(__file__).resolve().parent.parent
SIZES = driver.LAYER_SIZES
GBS = 64
N_MU = 4
TOL = dict(rtol=2e-4, atol=2e-6)
BASE = ["--batch-size", str(GBS), "--max-batches", "4"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_driver")
    prepare_mnist(d, synthetic=True, n_samples=1024)
    return d


@pytest.fixture
def root_train(monkeypatch):
    """The root driver's `train`, with the walker-importing overlap
    module stood in for (see the module docstring) and the SIGTERM
    handler it installs put back afterwards."""
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


def _events(path) -> list:
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _accuracies(path) -> list:
    ev = _events(path)
    return ([e["accuracy_start"] for e in ev if e["event"] == "epoch"]
            + [e["accuracy"] for e in ev if e["event"] == "final"])


def _params(ckpt) -> list:
    return C.load_pytree(Path(ckpt) / "params.npz")


def _canon_record(ckpt):
    """(params, canonical optimizer state) of a checkpoint of either
    package: `opt_canon.npz` where the writer's layout is not
    canonical, else `opt.npz`."""
    ckpt = Path(ckpt)
    canon = ckpt / "opt_canon.npz"
    opt = C.load_pytree(canon if canon.exists() else ckpt / "opt.npz")
    return _params(ckpt), opt


def _assert_trees_equal(a, b):
    la, lb = [], []
    assert C._encode(a, la) == C._encode(b, lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)


# --------------------------------------------- against the root driver


@pytest.mark.parametrize("layout", [[], ["--pp", "2", "--schedule", "gpipe"],
                                    ["--pp", "4", "--schedule", "pipedream"],
                                    ["--dp", "2", "--pp", "2"]],
                         ids=["fused", "spmd_pp2", "vm_pp4_pipedream",
                              "vm_dp2_pp2_naive"])
def test_driver_matches_root_driver(data_dir, tmp_path, root_train, layout):
    argv = BASE + ["--epochs", "1", "--data-dir", str(data_dir)] + layout
    acc, eng = driver.train(driver.parse_args(
        argv + ["--device", "cpu", "--log-file", str(tmp_path / "p.jsonl"),
                "--save-dir", str(tmp_path / "p")]))
    ref = root_train(argv + ["--log-file", str(tmp_path / "j.jsonl"),
                             "--save-dir", str(tmp_path / "j")])
    assert acc == ref
    assert _accuracies(tmp_path / "p.jsonl") == _accuracies(tmp_path / "j.jsonl")
    ours, theirs = _params(tmp_path / "p/ckpt_0"), _params(tmp_path / "j/ckpt_0")
    assert len(ours) == len(theirs) == len(SIZES) - 1
    for a, b in zip(ours, theirs):
        for k in ("W", "b"):
            np.testing.assert_allclose(a[k], b[k], **TOL)
    expected = {"": "FusedDPEngine", "gpipe": "SPMDPipelineEngine"}
    kind = expected.get(layout[3] if len(layout) > 3 else "",
                        "PipelineExecutor")
    assert type(eng).__name__ == kind
    assert C.load_pytree(tmp_path / "p/ckpt_0/opt.npz", with_meta=True)[1][
        "engine"] == kind


# ----------------------------------------------------------------- flags


@pytest.mark.parametrize("flag", sorted(driver.UNPORTED))
def test_driver_refuses_root_flags_it_lacks(flag):
    for argv in ([flag, "1"], [flag]):
        with pytest.raises(NotPorted, match=re.escape(flag)) as err:
            driver.parse_args(["--device", "cpu", *argv])
        assert err.value.later == driver.UNPORTED[flag]


@pytest.mark.parametrize("argv,what", [(["--pp", "2", "--schedule",
                                          "pipedream", "--overlap", "on"],
                                         "overlap")])
def test_driver_refuses_unported_values(data_dir, argv, what):
    """What the driver refuses of a flag's values: `--overlap on` on the
    instruction VM, with the root driver's message (the fused and SPMD
    engines take it)."""
    with pytest.raises(SystemExit, match=what):
        driver.main(["--device", "cpu", "--data-dir", str(data_dir), *argv])


def test_driver_covers_every_root_flag():
    root = re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                      (ROOT / "train.py").read_text())
    assert len(root) >= 30
    own = {o for a in driver.parser()._actions for o in a.option_strings
           if not isinstance(a, driver._Refuse)}
    missing = [f for f in root if f not in own and f not in driver.UNPORTED]
    assert not missing, missing
    assert set(driver.UNPORTED) <= set(root)
    assert not set(driver.UNPORTED) & own


def test_driver_needs_a_card_or_cpu(data_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(["--data-dir", str(data_dir), "--epochs", "1"])


# ----------------------------------------------------------- checkpoints


def _ds(data_dir, dp):
    mubs = GBS // dp // N_MU
    return [Dataset(data_dir, GBS, mubs).load(r, dp) for r in range(dp)]


def _engine(kind, dp, pp, opt, port=True):
    if port:
        mesh = make_mesh(dp, pp, "cpu")
        fused, vm, spmd, stage = (FusedDPEngine, PipelineExecutor,
                                  SPMDPipelineEngine, MLPStage)
    else:
        mesh = j_mesh(dp, pp)
        fused, vm, spmd, stage = JFused, JVM, JSpmd, JStage
    if kind == "fused":
        return fused(stage(SIZES, 0, 1, batch_size=GBS), opt, mesh)
    if kind == "spmd":
        return spmd(SIZES, opt, mesh, N_MU, GBS // dp // N_MU, GBS)
    return vm(mesh, [stage(SIZES, s, pp, batch_size=GBS) for s in range(pp)],
              opt)


def _step(eng, kind, dp, data_dir, batches, port=True):
    ds = _ds(data_dir, dp)
    for b in batches:
        if kind == "vm":
            eng.train_batch((S if port else JS).GPipeSchedule, N_MU, b, ds)
        else:
            eng.train_batch(b, ds)


OPTS = {"momentum": (lambda: MomentumSGD(0.05), lambda: JMomentum(0.05)),
        "adam": (lambda: Adam(1e-3), lambda: JAdam(1e-3))}

# (writer package, writer (engine, dp, pp), reader (engine, dp, pp), opt)
CROSSINGS = [
    ("jax", ("fused", 1, 1), ("fused", 1, 1), "momentum"),
    ("jax", ("fused", 1, 1), ("vm", 1, 2), "momentum"),
    ("jax", ("fused", 2, 1), ("spmd", 1, 2), "adam"),
    ("jax", ("vm", 1, 2), ("vm", 1, 2), "adam"),
    ("jax", ("vm", 1, 2), ("spmd", 2, 2), "adam"),
    ("jax", ("spmd", 1, 4), ("fused", 2, 1), "momentum"),
    ("port", ("vm", 1, 2), ("fused", 1, 1), "momentum"),
    ("port", ("vm", 2, 2), ("spmd", 1, 2), "adam"),
    ("port", ("spmd", 1, 2), ("vm", 1, 4), "adam"),
    ("port", ("fused", 1, 1), ("spmd", 1, 2), "momentum"),
]


@pytest.mark.parametrize("writer,src,dst,opt", CROSSINGS,
                         ids=[f"{w}-{'x'.join(map(str, s))}-to-"
                              f"{'x'.join(map(str, d))}-{o}"
                              for w, s, d, o in CROSSINGS])
def test_checkpoints_cross(data_dir, tmp_path, writer, src, dst, opt):
    """The writer trains 2 batches and saves; the other package's
    engine restores it; saved again, the reader's checkpoint holds the
    same params and canonical optimizer state bit for bit."""
    w_port = writer == "port"
    mk_w, mk_r = (OPTS[opt][0], OPTS[opt][1]) if w_port else \
        (OPTS[opt][1], OPTS[opt][0])
    w = _engine(*src, mk_w(), port=w_port)
    _step(w, src[0], src[1], data_dir, [0, 1], port=w_port)
    (C if w_port else JC).save(tmp_path / "w", w, 1)
    r = _engine(*dst, mk_r(), port=not w_port)
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no re-initialized state
        assert (JC if w_port else C).restore(r, tmp_path / "w/ckpt_1") == 2
    (JC if w_port else C).save(tmp_path / "r", r, 1)
    a_params, a_opt = _canon_record(tmp_path / "w/ckpt_1")
    b_params, b_opt = _canon_record(tmp_path / "r/ckpt_1")
    _assert_trees_equal(a_params, b_params)
    _assert_trees_equal(a_opt, b_opt)


def test_restored_run_continues_on_the_writers_trajectory(data_dir, tmp_path):
    """A JAX fused momentum run saved after 2 batches, restored into the
    port's VM at pp 2 and the port's SPMD engine, then one more batch
    each: within the cross-engine bound of the JAX run's third batch."""
    j = _engine("fused", 1, 1, JMomentum(0.05), port=False)
    _step(j, "fused", 1, data_dir, [0, 1], port=False)
    JC.save(tmp_path, j, 1)
    _step(j, "fused", 1, data_dir, [2], port=False)
    ref = [np.asarray(x) for layer in j.get_canonical_params()
           for x in (layer["W"], layer["b"])]
    for kind, pp in (("vm", 2), ("spmd", 2), ("fused", 1)):
        eng = _engine(kind, 1, pp, MomentumSGD(0.05))
        C.restore(eng, tmp_path / "ckpt_1")
        _step(eng, kind, 1, data_dir, [2])
        got = [np.asarray(x) for layer in eng.get_canonical_params()
               for x in (layer["W"], layer["b"])]
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **TOL)


# -------------------------------------------------------- driver resume


@pytest.mark.parametrize("layout", [
    [], ["--pp", "4", "--schedule", "pipedream", "--optimizer", "momentum"],
    ["--dp", "2", "--pp", "2", "--schedule", "gpipe", "--optimizer", "adam",
     "--lr", "1e-3"]], ids=["fused_sgd", "vm_momentum", "spmd_adam"])
def test_resume_equals_straight_run(data_dir, tmp_path, layout, capsys):
    common = BASE + ["--device", "cpu", "--data-dir", str(data_dir)] + layout
    driver.main(common + ["--epochs", "2", "--save-dir", str(tmp_path / "a")])
    straight = capsys.readouterr().out
    driver.main(common + ["--epochs", "1", "--save-dir", str(tmp_path / "b")])
    driver.main(common + ["--epochs", "2", "--save-dir", str(tmp_path / "b"),
                          "--resume"])
    resumed = capsys.readouterr().out
    assert "resumed from" in resumed and "at epoch 1" in resumed
    hashes = [re.findall(r"model hash: (\w+)", o)[-1]
              for o in (straight, resumed)]
    assert hashes[0] == hashes[1]
    _assert_trees_equal(*(_canon_record(tmp_path / d / "ckpt_1")
                          for d in ("a", "b")))


def test_auto_resume_and_corrupt_exit(data_dir, tmp_path, capsys):
    common = BASE + ["--device", "cpu", "--data-dir", str(data_dir),
                     "--save-dir", str(tmp_path)]
    driver.main(common + ["--epochs", "1", "--auto-resume"])
    assert "resumed from" not in capsys.readouterr().out
    driver.main(common + ["--epochs", "2", "--auto-resume"])
    assert "resumed from" in capsys.readouterr().out
    for ck in tmp_path.glob("ckpt_*"):
        p = ck / "params.npz"
        p.write_bytes(p.read_bytes()[:-8] + b"\0" * 8)
    with pytest.warns(UserWarning, match="quarantin"):
        with pytest.raises(SystemExit) as err:
            driver.main(common + ["--epochs", "3", "--resume"])
    assert err.value.code == C.EXIT_CORRUPT_CKPT
