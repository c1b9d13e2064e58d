"""The port's schedule verifier (`shallowspeed_tpu_torch/parallel/
verify.py`) against the JAX package's: `simulate`, `simulate_interleaved`,
`interleaved_tables`, `simulate_zb` and `zb_tables` give the same
reports and tables, field for field, over a grid of (n_mu, pp[, vpp]);
and the reference's pure-Python replay of the zero-bubble tables
(`tests/test_pipeline_zb.py::test_zb_tables_replay`) on the port's
tables. Exact equality: both are integer bookkeeping."""

import dataclasses

import numpy as np
import pytest

from shallowspeed_tpu.parallel import schedules as JS
from shallowspeed_tpu.parallel import verify as JV
from shallowspeed_tpu_torch.parallel import instructions as TI
from shallowspeed_tpu_torch.parallel import schedules as TS
from shallowspeed_tpu_torch.parallel import verify as TV

ZB_GRID = [(1, 1), (2, 2), (4, 2), (3, 3), (8, 4), (12, 3), (4, 4), (6, 2)]
VPP_GRID = [(2, 2, 2), (4, 2, 2), (8, 4, 2), (6, 2, 3), (4, 4, 2),
            (3, 3, 2)]
SCHEDULES = ["NaiveParallelSchedule", "GPipeSchedule", "PipeDreamSchedule"]


def fields(x) -> dict:
    """A report's or a table's fields, arrays as nested lists, nested
    reports as their own fields."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if dataclasses.is_dataclass(v):
            v = fields(v)
        elif isinstance(v, np.ndarray):
            v = (v.dtype.str, v.tolist())
        out[f.name] = v
    return out


@pytest.mark.parametrize("n_mu,pp", ZB_GRID)
def test_zb_tables_equal_the_reference(n_mu, pp):
    assert fields(TV.zb_tables(n_mu, pp)) == fields(JV.zb_tables(n_mu, pp))


@pytest.mark.parametrize("n_mu,pp", ZB_GRID)
def test_simulate_zb_equals_the_reference(n_mu, pp):
    assert fields(TV.simulate_zb(n_mu, pp)) == fields(JV.simulate_zb(n_mu,
                                                                      pp))


@pytest.mark.parametrize("n_mu,pp,vpp", VPP_GRID)
def test_interleaved_tables_equal_the_reference(n_mu, pp, vpp):
    assert (fields(TV.interleaved_tables(n_mu, pp, vpp))
            == fields(JV.interleaved_tables(n_mu, pp, vpp)))


@pytest.mark.parametrize("n_mu,pp,vpp", VPP_GRID[:3])
def test_simulate_interleaved_equals_the_reference(n_mu, pp, vpp):
    assert (fields(TV.simulate_interleaved(n_mu, pp, vpp))
            == fields(JV.simulate_interleaved(n_mu, pp, vpp)))


@pytest.mark.parametrize("n_mu,pp", [(4, 2), (8, 4), (3, 3)])
@pytest.mark.parametrize("name", SCHEDULES)
def test_simulate_equals_the_reference(name, n_mu, pp):
    got = TV.simulate(getattr(TS, name), n_mu, pp)
    want = JV.simulate(getattr(JS, name), n_mu, pp)
    assert fields(got) == fields(want)
    assert TV.simulate_schedule is TV.simulate


def test_a_broken_schedule_is_refused():
    """Channel semantics: a stage that waits for activations nobody
    sends deadlocks, and the simulator says so."""

    class Stuck(TS.GPipeSchedule):
        def steps(self):
            for step in super().steps():
                yield [c for c in step
                       if not isinstance(c, TI.SendActivations)]

    with pytest.raises(TV.ScheduleError):
        TV.simulate(Stuck, 2, 2)


@pytest.mark.parametrize("n_mu,pp", [(4, 2), (8, 4), (12, 3)])
def test_zb_tables_replay(n_mu, pp):
    """Pure-python execution of the port's static tables: every F/B/W
    runs exactly once, every read sees the matching write (act/grad
    messages and all three stash pools), and the round count IS the
    simulator's verified makespan."""
    tb = TV.zb_tables(n_mu, pp)
    rep = TV.simulate_zb(n_mu, pp)
    assert tb.n_rounds == rep.makespan

    act = [[None] * (tb.n_act_slots + 1) for _ in range(pp)]
    grad = [[None] * (tb.n_grad_slots + 1) for _ in range(pp)]
    resb = [[None] * (tb.n_resb_slots + 1) for _ in range(pp)]
    resw = [[None] * (tb.n_resw_slots + 1) for _ in range(pp)]
    tap = [[None] * (tb.n_tap_slots + 1) for _ in range(pp)]
    seen = {"F": set(), "B": set(), "W": set()}
    for r in range(tb.n_rounds):
        out_act = [None] * pp
        out_grad = [None] * pp
        for d in range(pp):
            op, m = tb.op[r, d], tb.mu[r, d]
            if op == 1:                                   # F
                if d > 0:
                    assert act[d][tb.act_read[r, d]] == ("act", d, m), \
                        (r, d, m)
                resb[d][tb.resb_write[r, d]] = ("resb", d, m)
                resw[d][tb.resw_write[r, d]] = ("resw", d, m)
                out_act[d] = ("act", d + 1, m)
                seen["F"].add((d, m))
            elif op == 2:                                 # B
                if d < pp - 1:
                    assert grad[d][tb.grad_read[r, d]] == \
                        ("grad", d, m), (r, d, m)
                assert resb[d][tb.resb_read[r, d]] == ("resb", d, m)
                assert resw[d][tb.resw_read_b[r, d]] == ("resw", d, m)
                tap[d][tb.tap_write[r, d]] = ("tap", d, m)
                out_grad[d] = ("grad", d - 1, m)
                seen["B"].add((d, m))
            elif op == 3:                                 # W
                assert resw[d][tb.resw_read[r, d]] == ("resw", d, m)
                assert tap[d][tb.tap_read[r, d]] == ("tap", d, m)
                seen["W"].add((d, m))
        for d in range(pp):                               # the hops
            act[d][tb.act_write[r, d]] = out_act[(d - 1) % pp]
            grad[d][tb.grad_write[r, d]] = out_grad[(d + 1) % pp]
    full = {(d, m) for d in range(pp) for m in range(n_mu)}
    assert seen["F"] == full and seen["B"] == full and seen["W"] == full
