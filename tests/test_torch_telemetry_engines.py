"""The port's engines under the tracer and the traffic counters, against
the JAX package's engines on the CPU:

- span parity: one step of each engine in both packages with each
  package's tracer at `steps`; the sequences of (name, depth, args) of
  their spans are equal (the MLP's fused engine, SPMD pipeline and
  instruction VM under naive / gpipe / pipedream, their epoch paths;
  the context engine at dp 2 x sp 2, dense and ZeRO-1; the GSPMD
  family at tp 2, dense and ZeRO-1; the LM pipeline at pp 2 under
  gpipe and 1f1b, and under ZeRO-1 at dp 2);
- fences: no `Span` at `off`, no fence at `steps`, one per fenced span
  at `spans`;
- counted traffic: `telemetry_traffic()` of a step equals the analytic
  bytes at dp 2, pp 2, tp 2 and the sp 2 ring (and Ulysses), and the
  VM's measured `comm_bytes` equal the reference VM's
  `telemetry_traffic()` after the same batches;
- memory owners: the engines' resident trees' bytes.
"""

import pytest

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.data.dataset import Dataset as JDataset
from shallowspeed_tpu.engine import FusedDPEngine as JFused
from shallowspeed_tpu.models.mlp import MLPStage as JStage
from shallowspeed_tpu.parallel import schedules as JS
from shallowspeed_tpu.parallel.mesh import make_mesh as j_mesh
from shallowspeed_tpu.parallel.spmd_pipeline import (
    SPMDPipelineEngine as JSpmd)
from shallowspeed_tpu.parallel.worker import PipelineExecutor as JVM
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.data.dataset import Dataset
from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.models.mlp import MLPStage
from shallowspeed_tpu_torch.parallel import schedules as S
from shallowspeed_tpu_torch.parallel.mesh import make_mesh
from shallowspeed_tpu_torch.parallel.spmd_pipeline import SPMDPipelineEngine
from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor
from shallowspeed_tpu_torch.telemetry import collectives as C
from shallowspeed_tpu_torch.telemetry import memory as M
from shallowspeed_tpu_torch.telemetry import trace as TR
from shallowspeed_tpu_torch.weights import leaves
from tests.torch_parity import (MODEL, PIPE_MODEL, batch, engines,
                                gspmd_engines, pipeline_engines,
                                ref_telemetry)  # noqa: F401

SIZES = [784, 16, 15, 14, 13, 10]
GBS, N_MU = 32, 4


@pytest.fixture(autouse=True)
def _off():
    TR.configure()
    yield
    TR.configure()
    M.clear_owners()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_telemetry")
    prepare_mnist(d, synthetic=True, n_samples=256)
    return d


def _spans(events) -> list:
    return [(e["name"], e["depth"], e["args"]) for e in events
            if e["ph"] == "X"]


def _both(ref_tele, run_ref, run_port):
    """Each package's spans of `run_*()` with its tracer at `steps`."""
    jt = ref_tele.configure(level="steps")
    run_ref()
    pt = TR.configure(level="steps")
    run_port()
    return _spans(jt.events), _spans(pt.events)


# ------------------------------------------------------------ the MLP

def _mlp(kind, dp, pp, port):
    if port:
        mesh, opt, stage = make_mesh(dp, pp, "cpu"), O.SGD(0.5), MLPStage
        fused, vm, spmd = FusedDPEngine, PipelineExecutor, SPMDPipelineEngine
    else:
        mesh, opt, stage = j_mesh(dp, pp), JO.SGD(0.5), JStage
        fused, vm, spmd = JFused, JVM, JSpmd
    if kind == "fused":
        return fused(stage(SIZES, 0, 1, batch_size=GBS), opt, mesh)
    if kind == "spmd":
        return spmd(SIZES, opt, mesh, N_MU, GBS // dp // N_MU, GBS)
    return vm(mesh, [stage(SIZES, s, pp, batch_size=GBS) for s in range(pp)],
              opt)


def _mlp_data(data_dir, dp, port):
    cls = Dataset if port else JDataset
    return [cls(data_dir, GBS, GBS // dp // N_MU).load(r, dp)
            for r in range(dp)]


MLP_CASES = {
    "fused_dp2": ("fused", 2, 1, None),
    "spmd_dp2_pp2": ("spmd", 2, 2, None),
    "vm_naive_pp2": ("vm", 1, 2, "NaiveParallelSchedule"),
    "vm_gpipe_dp2_pp2": ("vm", 2, 2, "GPipeSchedule"),
    "vm_pipedream_pp2": ("vm", 1, 2, "PipeDreamSchedule"),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_engine_spans_equal_the_references(data_dir, ref_telemetry,
                                               case):
    kind, dp, pp, sched = MLP_CASES[case]

    def run(port):
        eng = _mlp(kind, dp, pp, port)
        ds = _mlp_data(data_dir, dp, port)
        for b in range(2):
            if kind == "vm":
                eng.train_batch(getattr(S if port else JS, sched), N_MU, b,
                                ds)
            else:
                eng.train_batch(b, ds)
        if kind != "vm":        # the epoch path: "run" / "epoch"
            eng.train_epoch(eng.stage_epoch(ds, 2))
        return eng

    ref, mine = _both(ref_telemetry, lambda: run(False), lambda: run(True))
    assert mine == ref and mine
    assert mine[-1][0] == {"fused": "run", "spmd": "epoch",
                           "vm": "batch"}[kind]


def test_vm_measured_bytes_equal_the_references(data_dir):
    """The VM's `comm_bytes` ("dp_psum", "pp_p2p") after two batches equal
    the reference VM's `telemetry_traffic()`, and its per-axis traffic
    of the last batch is one batch's share of them."""
    engines_ = [_mlp("vm", 2, 2, port) for port in (False, True)]
    for port, eng in zip((False, True), engines_):
        ds = _mlp_data(data_dir, 2, port)
        for b in range(2):
            eng.train_batch((S if port else JS).GPipeSchedule, N_MU, b, ds)
    ref = engines_[0].telemetry_traffic()
    assert engines_[1].comm_bytes == ref
    last = engines_[1].telemetry_traffic()["per_axis"]
    assert {ax: v["bytes"] * 2 for ax, v in last.items()} == {
        "dp": ref["dp_psum"], "pp": ref["pp_p2p"]}


# ----------------------------------------------------------- the LM family

def _lm_case(name):
    sgd = (lambda M_: M_.SGD(1e-2))
    if name.startswith("context"):
        zero = name.endswith("zero1")
        return engines(2, 2, "ring", sgd, kw=dict(MODEL, n_kv_heads=0),
                       zero1=zero)
    if name.startswith("tpz"):
        return gspmd_engines("tp", (2, 2), sgd, zero1=True)
    if name.startswith("tp"):
        return gspmd_engines("tp", (1, 2), sgd)
    sched, kw = name.split("_")[1], dict(PIPE_MODEL, n_layers=2)
    if name.endswith("zero1"):
        return pipeline_engines(2, 2, opt=sgd, kw=kw, schedule=sched,
                                zero1=True)
    return pipeline_engines(1, 2, opt=sgd, kw=kw, schedule=sched)


LM_CASES = ["context_dp2_sp2", "context_dp2_sp2_zero1", "tp2",
            "tpz_dp2_tp2_zero1", "pp_gpipe", "pp_1f1b", "pp_gpipe_zero1"]


@pytest.mark.parametrize("case", LM_CASES)
def test_lm_engine_spans_equal_the_references(ref_telemetry, case):
    je, te = _lm_case(case)
    tok, tgt = batch(te.cfg.vocab, 3, b=4)
    ref, mine = _both(ref_telemetry, lambda: je.train_batch(tok, tgt),
                      lambda: te.train_batch(tok, tgt))
    assert mine == ref
    split = case.endswith("zero1")
    assert [n for n, _, _ in mine] == (["grads", "update", "step"] if split
                                       else ["step"])


# ----------------------------------------------------------------- fences


def test_fences_by_level(monkeypatch):
    """`off`: the engine's spans are the shared null span and nothing is
    recorded; `steps`: spans but no fence; `spans`: one fence per fenced
    span ("grads", "update", "step" under ZeRO)."""
    calls = []
    monkeypatch.setattr(TR, "_block", lambda arrs: calls.append(len(arrs)))
    made = []
    real_span = TR.Span

    class Counting(real_span):
        __slots__ = ()

        def __init__(self, *a, **k):
            made.append(1)
            super().__init__(*a, **k)

    monkeypatch.setattr(TR, "Span", Counting)
    _, te = engines(2, 1, "ring", lambda M_: M_.SGD(1e-2),
                    kw=dict(MODEL, n_kv_heads=0), zero1=True)
    tok, tgt = batch(te.cfg.vocab, 3, b=4)
    tr = TR.configure(level="off")
    te.train_batch(tok, tgt)
    assert made == [] and calls == [] and tr.events == []
    tr = TR.configure(level="steps")
    te.train_batch(tok, tgt)
    assert len(made) == 3 and calls == [] and len(tr.events) == 3
    tr = TR.configure(level="spans")
    te.train_batch(tok, tgt)
    assert len(made) == 6 and len(calls) == 3 and len(tr.events) == 3


def test_vm_fences_every_instruction_span(data_dir, monkeypatch):
    calls = []
    monkeypatch.setattr(TR, "_block", lambda arrs: calls.append(1))
    eng = _mlp("vm", 1, 2, True)
    tr = TR.configure(level="spans")
    eng.train_batch(S.GPipeSchedule, N_MU, 0, _mlp_data(data_dir, 1, True))
    assert len(calls) == len(tr.events) == 2 * (2 * N_MU + 1) + 1


# ------------------------------------------------------- counted traffic

def _f32_bytes(tree) -> int:
    return sum(x.numel() * 4 for x in leaves(tree))


def test_dp2_traffic_is_replica_ones_gradient_partial():
    _, te = engines(2, 1, "ring", lambda M_: M_.SGD(1e-2),
                    kw=dict(MODEL, n_kv_heads=0))
    tok, tgt = batch(te.cfg.vocab, 3, b=4)
    assert te.telemetry_traffic() == C.empty()
    te.train_batch(tok, tgt)
    assert te.telemetry_traffic() == {
        "per_axis": {"dp": {"bytes": _f32_bytes(te.params), "calls": 1}},
        "total_bytes": _f32_bytes(te.params), "approximate": False}


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_sp2_traffic_is_the_substrates_hops(attn):
    """sp 2 at dp 1: the ring's one hop per layer moves one cell's K and V
    blocks forward and their gradients back; Ulysses' all-to-alls move
    one cell's q, k, v tiles and its output tile, and their gradients."""
    cfg = dict(MODEL, n_kv_heads=0)
    _, te = engines(1, 2, attn, lambda M_: M_.SGD(1e-2), kw=cfg)
    b, t = 4, 32
    tok, tgt = batch(te.cfg.vocab, 3, b=b, t=t)
    te.train_batch(tok, tgt)
    tile = b * (t // 2) * cfg["d_model"] * 4   # one cell's (B, T/2, H, D)
    per_layer = {"ring": 2 * 2 * tile, "ulysses": 2 * 4 * tile}[attn]
    calls = {"ring": 4, "ulysses": 8}[attn]
    n = cfg["n_layers"]
    assert te.telemetry_traffic()["per_axis"] == {
        "sp": {"bytes": n * per_layer, "calls": n * calls}}


def test_pp2_traffic_is_the_hops():
    """pp 2, gpipe, 2 microbatches: each moves its (B/2, T, d) f32
    activation forward and its cotangent back."""
    _, te = pipeline_engines(1, 2, opt=lambda M_: M_.SGD(1e-2),
                             schedule="gpipe")
    b, t, d = 4, 32, PIPE_MODEL["d_model"]
    tok, tgt = batch(te.cfg.vocab, 3, b=b, t=t)
    te.train_batch(tok, tgt)
    hop = (b // 2) * t * d * 4
    assert te.telemetry_traffic()["per_axis"] == {
        "pp": {"bytes": 2 * 2 * hop, "calls": 4}}


def test_tp2_traffic_is_megatrons_reductions():
    """tp 2 at dp 1: per block two g all-reduces (forward) and two f
    all-reduces (backward) of a (B, T, d) f32 activation; the
    vocabulary-parallel loss's f (backward, (B T, d)) and its max, sum
    of exponentials and target logit over the vocabulary shards
    ((B T,) each, the latter two with their backward)."""
    _, te = gspmd_engines("tp", (1, 2), lambda M_: M_.SGD(1e-2))
    b, t, d = 4, 32, MODEL["d_model"]
    tok, tgt = batch(te.cfg.vocab, 3, b=b, t=t)
    te.train_batch(tok, tgt)
    act, row = b * t * d * 4, b * t * 4
    n = MODEL["n_layers"]
    assert te.telemetry_traffic()["per_axis"] == {
        "tp": {"bytes": n * 4 * act + act + 5 * row,
               "calls": n * 4 + 1 + 5}}


def test_resident_trees_are_the_owners_bytes():
    """`resident()` holds every replica's own parameters and state: at
    dp 2 twice one tree's bytes, and the driver's owners resolve it."""
    from shallowspeed_tpu_torch.telemetry.driver import owners_of

    _, te = engines(2, 1, "ring", lambda M_: M_.Adam(1e-2),
                    kw=dict(MODEL, n_kv_heads=0))
    for name, fn in owners_of(te).items():
        M.register_owner(name, fn)
    acct = M.per_owner_accounting()
    one = _f32_bytes(te.params)
    assert acct["owners"] == {"train.params": 2 * one,
                              "train.opt_state": 2 * 2 * one}
