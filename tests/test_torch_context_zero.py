"""ZeRO-1 and ZeRO-2 in the port's `ContextParallelEngine` against the
JAX package's engine on the same (dp, sp) host mesh, with gradient
clipping and the health pack (monitor, and the guard's skip bit for
bit); the ZeRO pieces (`parallel/zero.py`) on their own; ZeRO
checkpoints across layouts and packages; the driver's newly ported
`--dp`, `--sp`, `--zero1`, `--zero2` against the root driver.

Tolerances (f32): trajectories as `tests/test_torch_context_mesh.py`
(1e-4); health packs 1e-4 relative (`tests/test_torch_health.py`);
checkpoints restore bit for bit and continue within 1e-4; the drivers'
step lines equal to their 4 digits (2e-4).
"""

import json
import re
import signal
import sys
import types
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch_parity import MODEL, OPTS, batch, engines, trajectory, worst

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JaxEngine)
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch import train_lm as tdriver
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel import zero as Z
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.mesh import make_context_mesh
from shallowspeed_tpu_torch.weights import leaves

ROOT = Path(__file__).resolve().parent.parent


# ------------------------------------------------------------- the pieces

def test_placement_rule_and_state_round_trip():
    """The first dimension dp divides, else whole; a state cut into
    cells gathers back bit for bit and a canonical state installs into
    the cells' slices."""
    assert Z.zero2_grad_dim((6, 4), 2) == 0
    assert Z.zero2_grad_dim((3, 4), 2) == 1
    assert Z.zero2_grad_dim((3, 5), 2) is None
    assert Z.zero2_grad_dim((0, 4), 2) == 1
    g = torch.Generator().manual_seed(0)
    state = {"m": {"W": torch.randn(6, 4, generator=g),
                   "b": torch.randn(3, generator=g)},
             "v": [torch.randn(3, 4, generator=g)], "t": 7}
    cells = [torch.device("cpu")] * 2
    shards = Z.shard_state_zero1(state, cells)
    assert shards[1]["m"]["W"].shape == (3, 4)
    assert shards[1]["v"][0].shape == (3, 2) and shards[1]["t"] == 7
    assert torch.equal(shards[0]["m"]["b"], state["m"]["b"])
    dims = Z.state_dims(state, 2)
    back = Z.gather_state(shards, dims, cells[0])
    for a, b in zip(leaves(back), leaves(state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    other = {"m": {"W": np.ones((6, 4), np.float32),
                   "b": np.zeros(3, np.float32)},
             "v": [np.full((3, 4), 2.0, np.float32)], "t": np.int32(9)}
    Z.replace_opt_state(shards, other)
    assert shards[0]["t"] == shards[1]["t"] == 9
    assert float(Z.gather_state(shards, dims, cells[0])["v"][0].sum()) == 24


def test_reduce_scatter_equals_the_dense_sum_bit_for_bit():
    """Rank-order partial sums: each cell's slice equals the dense
    all-reduce's slice exactly; undivisible leaves are whole on every
    cell."""
    g = torch.Generator().manual_seed(1)
    parts = [[torch.randn(4, 6, generator=g), torch.randn(5, generator=g)]
             for _ in range(3)]
    dims = [Z.zero2_grad_dim(x.shape, 2) for x in parts[0]]
    cells = [torch.device("cpu")] * 2
    acc = None
    for p in parts:
        acc = Z.reduce_scatter(acc, p, dims, cells)
    dense = [a.clone() for a in parts[0]]
    for p in parts[1:]:
        for a, x in zip(dense, p):
            a.add_(x)
    assert torch.equal(torch.cat([acc[0][0], acc[1][0]]), dense[0])
    assert torch.equal(acc[0][1], dense[1]) and torch.equal(acc[1][1],
                                                             dense[1])


# ---------------------------------------------------- engine trajectories

@pytest.mark.parametrize("optname", list(OPTS))
@pytest.mark.parametrize("zero", ["zero1", "zero2"])
@pytest.mark.parametrize("layout", [(2, 1), (2, 2)],
                         ids=lambda x: f"dp{x[0]}sp{x[1]}")
def test_zero_trajectory_matches_jax_engine(layout, zero, optname):
    """ZeRO-1/2 with clipping, momentum (sliced update) and factored
    Adafactor (gathered update): the JAX engine's trajectory, and the
    canonical state its `opt_state` gathers."""
    opt, slots = OPTS[optname]
    attn = "ring-flash" if layout[1] > 1 else "flash"
    je, te = engines(*layout, attn, opt, **{zero: True})
    trajectory(je, te, slots)


@pytest.mark.parametrize("optname", ["adamw", "momentum-clip"])
def test_zero_equals_dense_port(optname):
    """ZeRO changes where state lives, not the update: ZeRO-1, ZeRO-2
    and the dense engine at (2, 2) land on the same parameters and
    state, bit for bit without clipping (every slice takes the dense
    sum's bits and the elementwise update); with clipping the norm sums
    each leaf's slices apart and the leaves in another order, f32 sums
    over ~30 leaves and a few thousand elements: 1e-5."""
    opt = {"adamw": lambda: O.AdamW(1e-2),
           "momentum-clip": lambda: O.MomentumSGD(
               0.05, momentum=0.9, grad_clip=0.5)}[optname]
    runs = []
    for kw in ({}, {"zero1": True}, {"zero2": True}):
        te = ContextParallelEngine(T.TransformerConfig(**MODEL), opt(),
                                   seed=3, attn="ring",
                                   mesh=make_context_mesh(2, 2, "cpu"), **kw)
        for step in range(2):
            te.train_batch(*batch(MODEL["vocab"], 40 + step, b=4))
        runs.append((te.params, te.opt_state))
    for params, state in runs[1:]:
        if optname == "adamw":
            _bits(params, runs[0][0])
            _bits(state, runs[0][1])
        else:
            assert worst(params, runs[0][0], absolute=True) <= 1e-5
            assert worst(state, runs[0][1]) <= 1e-5


def _zero2_slices_are_half(te):
    """Under ZeRO-2 each cell holds half of every divisible moment."""
    shards = te._zero.shards
    full = te.opt_state
    for a, b in zip(leaves(shards[0]["v"]), leaves(full["v"])):
        d = Z.zero2_grad_dim(b.shape, 2)
        want = list(b.shape)
        if d is not None:
            want[d] //= 2
        assert list(a.shape) == want


@pytest.mark.parametrize("mode", ["monitor", "guard"])
@pytest.mark.parametrize("zero", ["zero1", "zero2"])
def test_zero_health_pack_matches_jax(zero, mode):
    """The pack of a ZeRO step (each sliced leaf's statistics over its
    slices) against the JAX engine's, after 2 steps at (2, 2)."""
    je, te = engines(2, 2, "ring", OPTS["momentum"][0], health=mode,
                     **{zero: True})
    for step in range(2):
        tok, tgt = batch(MODEL["vocab"], 30 + step, b=4)
        je.train_batch(tok, tgt)
        te.train_batch(tok, tgt)
    got, ref = te.health_snapshot(), je.health_snapshot()
    assert got.keys() == ref.keys()
    for k in ("grad_norm", "param_norm", "update_ratio"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    for k in ("nonfinite", "skipped", "skipped_total",
              "nonfinite_steps_total"):
        assert got.get(k) == ref.get(k), k
    for k, v in ref["groups"].items():
        assert got["groups"][k] == pytest.approx(v, rel=1e-4, abs=1e-9)


def _copy(te):
    return [t.clone() if isinstance(t, torch.Tensor) else t
            for t in [*leaves(te._replicas), *leaves(
                te._zero.shards if te._zero else te._states)]]


def _same(a, b):
    return len(a) == len(b) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(a, b))


@pytest.mark.parametrize("optname", list(OPTS))
@pytest.mark.parametrize("zero", ["dense", "zero1", "zero2"])
def test_guard_skips_a_poisoned_step_bit_for_bit(zero, optname):
    """One NaN in replica 1's gradient partial: every replica's
    parameters and every cell's optimizer state keep their bits, the
    skip is counted, and the next clean step moves them."""
    kw = {} if zero == "dense" else {zero: True}
    te = ContextParallelEngine(T.TransformerConfig(**MODEL),
                               OPTS[optname][0](O), seed=2, attn="ring",
                               mesh=make_context_mesh(2, 2, "cpu"),
                               health="guard", **kw)
    tok, tgt = batch(MODEL["vocab"], 1, b=4)
    te.train_batch(tok, tgt)
    if zero == "zero2":
        _zero2_slices_are_half(te) if optname == "momentum" else None
    before = _copy(te)
    orig = te._replica_grads

    def poisoned(r, tok, tgt):
        loss, part = orig(r, tok, tgt)
        if r == 1:
            part[0].view(-1)[0] = float("nan")
        return loss, part

    te._replica_grads = poisoned
    te.train_batch(tok, tgt)
    assert _same(_copy(te), before)
    snap = te.health_snapshot()
    assert snap["skipped_total"] == 1 and snap["nonfinite"] == 1
    te._replica_grads = orig
    te.train_batch(tok, tgt)
    assert not _same(_copy(te), before)
    assert te.health_snapshot()["skipped"] == 0


# ------------------------------------------------------------ checkpoints

CKPT_OPT = lambda M: M.MomentumSGD(0.05, momentum=0.9, grad_clip=1.0)  # noqa


def _jax(dp, sp, seed=5, **kw):
    mesh = Mesh(np.array(jax.devices()[:dp * sp]).reshape(dp, sp),
                ("dp", "sp"))
    return JaxEngine(JT.TransformerConfig(**MODEL), CKPT_OPT(JO), mesh,
                     seed=seed, attn="ring", **kw)


def _port(dp, sp, seed=5, **kw):
    return ContextParallelEngine(T.TransformerConfig(**MODEL), CKPT_OPT(O),
                                 seed=seed, attn="ring",
                                 mesh=make_context_mesh(dp, sp, "cpu"), **kw)


def _bits(a, b):
    fa = {k: np.asarray(v) for k, v in _flat(a).items()}
    fb = {k: np.asarray(v) for k, v in _flat(b).items()}
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items()
                for k2, v in _flat(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, sub in enumerate(tree)
                for k2, v in _flat(sub, f"{prefix}/{i}").items()}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: tree}


@pytest.mark.parametrize("target", ["2x2-zero2", "1x1"])
def test_jax_zero2_checkpoint_restores_into_the_port(tmp_path, target):
    """A JAX (2, 2) ZeRO-2 engine's checkpoint restores into the port's
    (2, 2) ZeRO-2 engine and its (1, 1) engine bit for bit (every
    replica, every cell), and both continue with the JAX engine."""
    je = _jax(2, 2, zero2=True)
    for s in range(2):
        je.train_batch(*batch(MODEL["vocab"], 50 + s, b=4))
    JC.save(tmp_path, je, 1)
    te = (_port(2, 2, seed=9, zero2=True) if target == "2x2-zero2"
          else _port(1, 1, seed=9))
    assert C.restore(te, tmp_path / "ckpt_1") == 2
    jp, js = jax.device_get(je.params), jax.device_get(je.opt_state)
    for rep in te._replicas:
        _bits(rep, jp)
    _bits(te.opt_state, js)
    for s in (2, 3):
        tok, tgt = batch(MODEL["vocab"], 50 + s, b=4)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-4


@pytest.mark.parametrize("target", ["2x2-zero2", "1x1"])
def test_port_zero2_checkpoint_restores_into_jax(tmp_path, target):
    """The reverse: the port's (2, 2) ZeRO-2 checkpoint (the canonical,
    unsharded state) restores into the JAX (2, 2) ZeRO-2 engine and
    its (1, 1) engine, bit for bit, with no re-initialization."""
    te = _port(2, 2, zero2=True)
    for s in range(2):
        te.train_batch(*batch(MODEL["vocab"], 60 + s, b=4))
    C.save(tmp_path, te, 1)
    je = (_jax(2, 2, seed=9, zero2=True) if target == "2x2-zero2"
          else _jax(1, 1, seed=9))
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert JC.restore(je, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    _bits(jax.device_get(je.params), te.params)
    _bits(jax.device_get(je.opt_state), te.opt_state)
    for s in (2, 3):
        tok, tgt = batch(MODEL["vocab"], 60 + s, b=4)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-4


def test_port_checkpoints_cross_its_own_layouts(tmp_path):
    """(2, 2) ZeRO-1 saves, (1, 2) ZeRO-2 and (2, 1) dense restore it bit
    for bit."""
    src = _port(2, 2, zero1=True)
    src.train_batch(*batch(MODEL["vocab"], 70, b=4))
    C.save(tmp_path, src, 0)
    for dst in (_port(1, 2, seed=1, zero2=True), _port(2, 1, seed=1)):
        assert C.restore(dst, tmp_path / "ckpt_0") == 1
        _bits(dst.opt_state, src.opt_state)
        for rep in dst._replicas:
            _bits(rep, src.params)


# ------------------------------------------------------------------ driver

DBASE = ["--seq-len", "32", "--d-model", "32", "--n-heads", "4",
         "--n-layers", "2", "--batch-size", "4", "--steps", "3",
         "--log-every", "1", "--lr", "1e-2"]
STEP = re.compile(r"step +(\d+)  loss (\S+)  tok/s")


@pytest.fixture
def root_train(monkeypatch):
    """The root driver's `train`, with its walker-importing overlap
    module stood in for (its `from_flags` returns the "off" plan, what
    the root driver gets without --overlap on; jax 0.9 cannot import
    the module, ROADMAP Queue 3) and its SIGTERM handler put back."""
    monkeypatch.setitem(sys.modules, "shallowspeed_tpu.parallel.overlap",
                        types.SimpleNamespace(from_flags=lambda m, b: None))
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("train_lm", None)
    import train_lm as root

    handler = signal.getsignal(signal.SIGTERM)
    try:
        yield lambda argv: root.train(root.parse_args(argv))
    finally:
        signal.signal(signal.SIGTERM, handler)
        sys.modules.pop("train_lm", None)


def _losses(capsys, run, argv):
    run(argv)
    out = capsys.readouterr().out.splitlines()
    return [float(m.group(2)) for m in map(STEP.match, out) if m]


FLAGS = {
    "--dp": ["--dp", "2", "--attn", "flash"],
    "--sp": ["--sp", "2", "--attn", "ring-flash"],
    "--zero1": ["--dp", "2", "--sp", "2", "--attn", "ulysses-flash",
                "--zero1", "--optimizer", "adafactor"],
    "--zero2": ["--dp", "2", "--sp", "2", "--attn", "ring", "--zero2",
                "--accum", "2", "--grad-clip", "0.5"],
    # the GSPMD engine family
    "--tp": ["--dp", "2", "--tp", "2", "--zero1", "--grad-clip", "0.5"],
    "--fsdp": ["--dp", "2", "--fsdp", "--optimizer", "adafactor"],
    "--sp --tp --fsdp": ["--dp", "2", "--sp", "2", "--tp", "2", "--fsdp"],
    "--ep": ["--dp", "2", "--ep", "2", "--experts", "4"],
    "--experts": ["--dp", "2", "--sp", "2", "--experts", "4",
                  "--moe-z-weight", "0.01"],
}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_ported_mesh_flag_matches_the_root_driver(capsys, root_train, flag):
    """Each newly ported flag: the port's step lines equal the root
    driver's on the same arguments (the root runs a host-device mesh,
    the port a grid of the CPU) to the lines' 4 digits (2e-4: the f32
    losses, ~1e-7 apart, may round to neighbouring last digits), and
    the flag is out of UNPORTED."""
    assert not set(flag.split()) & set(tdriver.UNPORTED)
    argv = [*DBASE, *FLAGS[flag]]
    want = _losses(capsys, root_train, argv)
    got = _losses(capsys, lambda a: tdriver.main(["--device", "cpu", *a]),
                  argv)
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=2e-4)


def test_unported_shrinks_by_the_ported_flags():
    """What stays refused names the ROADMAP item that ports it; the
    GSPMD family's flags (--tp, --fsdp, --ep, --experts at dp/sp > 1)
    and the pipeline's (--pp, --pp-schedule, --virtual-pp,
    --n-mubatches) parse."""
    assert not {"--dp", "--sp", "--zero1", "--zero2", "--tp", "--fsdp",
                "--ep", "--pp", "--pp-schedule", "--virtual-pp",
                "--n-mubatches", "--overlap", "--bucket-mb"} & set(
                    tdriver.UNPORTED)
    assert tdriver.parse_args(["--device", "cpu", "--overlap", "on",
                               "--bucket-mb", "2"]).bucket_mb == 2.0
    for flag in ("--platform", "--host-devices"):
        assert "--device" in tdriver.UNPORTED[flag]
    assert tdriver.parse_args(["--device", "cpu", "--ep", "2", "--experts",
                               "2"]).ep == 2
    assert tdriver.parse_args(["--device", "cpu", "--dp", "2", "--experts",
                               "2"]).dp == 2


REFUSED = {
    "zero1-zero2": (["--dp", "2", "--zero1", "--zero2"], "same"),
    "ep-tp": (["--ep", "2", "--tp", "2", "--experts", "4"], "same"),
    "fsdp-zero1": (["--dp", "2", "--fsdp", "--zero1"], "same"),
    "fsdp-experts": (["--dp", "2", "--fsdp", "--experts", "4"], "same"),
    "tp-flash": (["--tp", "2", "--attn", "flash"], "same"),
    "fsdp-ring-flash": (["--dp", "2", "--sp", "2", "--fsdp", "--attn",
                         "ring-flash"], "same"),
    "ep-no-experts": (["--ep", "2"], "same"),
    "experts-tp": (["--dp", "2", "--tp", "2", "--experts", "4"], "same"),
    "accum-tp": (["--tp", "2", "--accum", "2"], "same"),
    "attn-dropout-sp2": (["--sp", "2", "--attn", "ring", "--attn-dropout",
                          "0.1"], "--attn-dropout needs"),
    "flash-sp2": (["--sp", "2", "--attn", "flash"], "same"),
    "batch-dp": (["--dp", "3"], "--dp 3"),
    "seq-sp": (["--sp", "3"], "--sp 3"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_driver_mirrors_the_root_mesh_refusals(root_train, name):
    """The root driver's refusals of the (dp, sp) flags: the same
    message where it gives one (its asserts of batch % dp and seq_len %
    sp carry none; the port names the flags)."""
    extra, want = REFUSED[name]
    argv = [*DBASE, *extra]
    with pytest.raises((SystemExit, AssertionError)) as root:
        root_train(argv)
    with pytest.raises(SystemExit) as port:
        tdriver.main(["--device", "cpu", *argv])
    msg = str(port.value.code)
    if want == "same":
        root_msg = (root.value.code if isinstance(root.value, SystemExit)
                    else str(root.value))
        assert msg == root_msg
    else:
        assert want in msg


def test_driver_checkpoint_crosses_layouts(tmp_path, capsys):
    """--dp 2 --sp 2 --zero2 saves at step 1; --resume at --dp 1 --sp 1
    restores the canonical state and continues the straight run's
    losses (an unbroken (1, 1) run's step lines, to their 4 digits)."""
    base = ["--device", "cpu", *DBASE, "--attn", "ring",
            "--save-dir", str(tmp_path / "ck"), "--save-every", "2",
            "--log-file", str(tmp_path / "m.jsonl")]
    tdriver.main([*base, "--steps", "2", "--dp", "2", "--sp", "2",
                  "--zero2"])
    capsys.readouterr()
    tdriver.main([*base, "--steps", "4", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 2" in out
    resumed = [float(m.group(2)) for m in map(STEP.match, out.splitlines())
               if m]
    straight = _losses(capsys, lambda a: tdriver.main(a), [
        "--device", "cpu", *DBASE, "--attn", "ring", "--steps", "4"])
    assert len(resumed) == 2
    assert resumed == pytest.approx(straight[2:], abs=2e-4)
    events = [json.loads(x) for x in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    assert any(e["event"] == "restore" for e in events)
