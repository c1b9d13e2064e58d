"""The port's pipeline bubble accounting (`shallowspeed_tpu_torch/
telemetry/bubble.py`) against the JAX package's: `static_bubble`,
`costed_replay` and the replay of each schedule's verified placement
are equal for gpipe, 1f1b, zb and interleaved vpp 2 over pp in {1, 2,
4} and n_mu in {1, 4, 8}; `span_replay_ops` reads the port's
instruction-VM trace into the ops the reference reads off its own VM
trace, op for op; `calibrate_compiled` on a pp 2 `PipelineLMEngine`
leaves its losses and parameters bit-equal to an uncalibrated run;
`make_calibration_twin` has the reference twin's `schedule_info`."""

import numpy as np
import pytest
import torch

from shallowspeed_tpu.telemetry import bubble as RB
from shallowspeed_tpu_torch.telemetry import bubble as PB
from shallowspeed_tpu_torch.telemetry import trace as PT
from torch_parity import (PIPE_MODEL, pipeline_engines,  # noqa: F401
                          ref_telemetry)

SCHEDULES = {"gpipe": ("gpipe", 1), "1f1b": ("1f1b", 1), "zb": ("zb", 1),
             "vpp2": ("1f1b", 2)}


def _both(fn_name, *args, **kw):
    """(reference result or its exception type, port result or its
    exception type)."""
    out = []
    for mod in (RB, PB):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except Exception as e:      # the same refusal on both sides
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_static_and_replayed_bubbles_equal_the_reference(name):
    schedule, vpp = SCHEDULES[name]
    ran = 0
    for pp in (1, 2, 4):
        for n_mu in (1, 4, 8):
            want, got = _both("static_bubble", schedule, n_mu, pp, vpp)
            assert got == want, (pp, n_mu)
            for costs in ({}, {"c_f": 1.0, "c_b": 2.3, "c_w": 0.7}):
                want, got = _both("costed_replay", schedule, n_mu, pp, vpp,
                                  **costs)
                assert got == want, (pp, n_mu, costs)
            if pp > 1 and not isinstance(got, str):
                ran += 1
                ops = PB._placement(schedule, n_mu, pp, vpp)
                assert ops == RB._placement(schedule, n_mu, pp, vpp)
                timed = [(*op[:3], 1.0 + 0.1 * i, *op[3:])
                         for i, op in enumerate(ops)]
                assert PB.replay_trace(timed, pp) == RB.replay_trace(
                    timed, pp)
    assert ran >= 3
    if name == "gpipe":
        assert PB.static_bubble("gpipe", 4, 2)["bubble_fraction"] == 0.2


def test_replay_refusals_and_wall_clock_variants_equal():
    dup = [("F", 0, 0, 1.0), ("F", 0, 0, 1.0)]
    bad = [("B", 0, 0, 1.0)]
    for ops, pp in ((dup, None), (bad, None),
                    ([("F", 0, 0, 1.0), ("F", 1, 0, 1.0)], 1)):
        with pytest.raises(ValueError) as want:
            RB.replay_trace(ops, pp)
        with pytest.raises(ValueError) as got:
            PB.replay_trace(ops, pp)
        assert str(got.value) == str(want.value)
    rng = np.random.default_rng(0)
    events = [{"stage": int(s), "ts": float(t), "dur": float(d)}
              for s, t, d in zip(rng.integers(0, 3, 20),
                                 rng.uniform(0, 100, 20),
                                 rng.uniform(1, 9, 20))]
    assert PB.trace_bubble(events) == RB.trace_bubble(events)
    for t1, t2 in ((9.0, 17.0), (1.0, 2.3), (4.0, 4.5)):
        assert PB.two_point_bubble(t1, t2) == RB.two_point_bubble(t1, t2)


def _vm_ops(port: bool, data_dir, ref_tele=None):
    """The last batch's span_replay_ops of a pp 2 GPipe VM batch at
    `spans`, the port's or the reference's."""
    from test_torch_mlp_engines import build, datasets

    if port:
        from shallowspeed_tpu_torch.parallel import schedules as S
        tr, mod = PT.configure(level="spans"), PB
    else:
        from shallowspeed_tpu.parallel import schedules as S
        tr, mod = ref_tele.configure(level="spans"), RB
    layout = ("vm", 1, 2, "GPipeSchedule")
    eng = build(layout, port)
    ds = datasets(data_dir, 1, port)
    try:
        for b in range(2):
            mark = tr.event_count
            eng.train_batch(S.GPipeSchedule, 4, b, ds)
        return mod.span_replay_ops(tr.events_since(mark), batch=1), \
            mod.span_ops(tr.events_since(mark), batch=1)
    finally:
        (PT if port else ref_tele).configure()


def test_span_replay_ops_match_the_reference_vm(tmp_path, ref_telemetry):  # noqa: F811
    from shallowspeed_tpu_torch.data.mnist import prepare_mnist

    prepare_mnist(tmp_path, synthetic=True, n_samples=1024)
    got, got_spans = _vm_ops(True, tmp_path)
    want, want_spans = _vm_ops(False, tmp_path, ref_telemetry)
    assert [op[:3] for op in got] == [op[:3] for op in want]
    assert len(got) == 2 * 2 * 4
    assert [s[0] for s in got_spans] == [s[0] for s in want_spans]
    unit = [(*op[:3], 1.0) for op in got]
    assert PB.replay_trace(unit, 2) == RB.replay_trace(unit, 2)
    assert PB.replay_trace(unit, 2)["bubble_fraction"] == \
        PB.static_bubble("gpipe", 4, 2)["bubble_fraction"]
    assert PB.replay_trace(got, 2)["n_stages"] == 2


def _pipe_run(calibrate: bool, steps=5):
    from shallowspeed_tpu_torch.models import transformer as T
    from shallowspeed_tpu_torch.optim import Adam
    from shallowspeed_tpu_torch.parallel.mesh import make_pipeline_mesh
    from shallowspeed_tpu_torch.parallel.pipeline_lm import PipelineLMEngine

    cfg = T.TransformerConfig(**PIPE_MODEL)
    eng = PipelineLMEngine(cfg, Adam(1e-2), make_pipeline_mesh(1, 2, 1,
                                                              "cpu"),
                           n_mubatches=2, seed=5, schedule="1f1b")
    tr = PT.configure(level="spans")
    rng = np.random.default_rng(0)
    losses, cal = [], None
    try:
        for step in range(steps):
            tok = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
            tgt = np.roll(tok, -1, axis=1)
            losses.append(eng.train_batch(tok, tgt))
            if calibrate and step == 2:
                cal = PB.calibrate_compiled(eng, tr, tok, tgt)
                assert PB.calibrate_compiled(eng, tr, tok, tgt) is not None
    finally:
        PT.configure()
    return losses, eng.get_canonical_params(), cal


def test_calibration_leaves_the_trajectory_bit_equal():
    from shallowspeed_tpu_torch.weights import leaves

    want, pw, _ = _pipe_run(False)
    got, pg, cal = _pipe_run(True)
    assert got == want
    for a, b in zip(leaves(pg), leaves(pw)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    static = PB.static_bubble("1f1b", 2, 2)
    assert cal["bubble_static"] == static["bubble_fraction"]
    assert 0.0 <= cal["bubble_measured"] < 1.0
    d = cal["bubble_detail"]
    assert d["t_step"] > 0 and d["t_eval"] > 0 and d["c_f"] > 0


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zb"])
def test_calibration_twin_schedule_info_equals_the_reference(schedule):
    je, te = pipeline_engines(1, 2, n_mu=2, schedule=schedule)
    assert te.schedule_info() == je.schedule_info()
    jt, tt = je.make_calibration_twin(), te.make_calibration_twin()
    assert tt.schedule_info() == jt.schedule_info()
    assert tt.schedule_info()["n_mu"] == 4
    assert tt.seed == te.seed and tt.mesh is te.mesh
