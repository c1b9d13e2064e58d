"""The port's `train_lm` flags of the one-device training features on
the CPU (`--device cpu`, 2 layers, d_model 32): one case per flag the
driver used to refuse with `NotPorted`, showing that it acts, and the
root driver's refusals of their combinations."""

import json
import re

import numpy as np
import pytest

from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch import train_lm as tdriver

POLICIES = ["full", "attn", "dots"]


# -------------------------------------------------------------- driver

DBASE = ["--device", "cpu", "--seq-len", "32", "--d-model", "32",
         "--n-heads", "4", "--n-layers", "2", "--batch-size", "4",
         "--steps", "2", "--log-every", "1", "--lr", "1e-2"]
STEP = re.compile(r"step +(\d+)  loss (\S+)  tok/s")


def _run(capsys, tmp_path, *argv):
    """(loss values of the step lines, stdout lines, JSONL events) of
    `train_lm.main(DBASE + argv)`."""
    log = tmp_path / f"m{len(list(tmp_path.iterdir()))}.jsonl"
    assert tdriver.main([*DBASE, *map(str, argv), "--log-file",
                         str(log)]) == 0
    out = capsys.readouterr().out.splitlines()
    losses = [float(m.group(2)) for m in map(STEP.match, out) if m]
    events = [json.loads(x) for x in log.read_text().splitlines()]
    return losses, out, events


def _same(flag, *argv):
    """The flag leaves a 2-step run's losses as they were (CPU)."""
    def act(capsys, tmp_path):
        base, _, _ = _run(capsys, tmp_path, *argv)
        got, _, _ = _run(capsys, tmp_path, *argv, flag)
        assert got == base
    return act


def _act_accum(capsys, tmp_path):
    base, _, _ = _run(capsys, tmp_path)
    got, _, _ = _run(capsys, tmp_path, "--accum", 2)
    assert got[0] == pytest.approx(base[0], abs=2e-4)   # 4-digit lines
    with pytest.raises(ValueError, match="--accum 3 must divide"):
        _run(capsys, tmp_path, "--accum", 3)


def _act_remat_policy(capsys, tmp_path):
    base, _, _ = _run(capsys, tmp_path)
    for policy in POLICIES:
        got, _, _ = _run(capsys, tmp_path, "--remat", "--remat-policy",
                         policy)
        assert got == base


def _act_xent_chunk(capsys, tmp_path):
    base, _, _ = _run(capsys, tmp_path)
    got, _, _ = _run(capsys, tmp_path, "--xent-chunk", 48)
    assert got == pytest.approx(base, abs=2e-4)


def _differs(*argv, attn):
    """The flag moves the training losses, on the substrate it takes
    when --attn is not given."""
    def act(capsys, tmp_path):
        base, _, _ = _run(capsys, tmp_path, "--attn", attn)
        got, _, events = _run(capsys, tmp_path, *argv)
        assert got != base and all(np.isfinite(got))
        assert events[0]["attn"] == attn
    return act


def _act_adafactor(capsys, tmp_path):
    args = tdriver.parse_args([*DBASE, "--optimizer", "adafactor",
                               "--weight-decay", "0.05"])
    assert isinstance(tdriver.build(args)[1], O.Adafactor)
    assert tdriver.build(args)[1].weight_decay == 0.05
    base, _, _ = _run(capsys, tmp_path)
    got, _, _ = _run(capsys, tmp_path, "--optimizer", "adafactor")
    assert got[0] == base[0] and got[1] != base[1]


def _moe_events(capsys, tmp_path, *argv):
    losses, out, events = _run(capsys, tmp_path, "--experts", 4, *argv)
    lines = [ln for ln in out if ln.strip().startswith("moe drop")]
    router = [e for e in events if e["event"] == "moe_router"]
    assert len(lines) == len(router) == 2 and all(np.isfinite(losses))
    assert [e["step"] for e in router] == [0, 1]
    assert events[0]["attn"] == "ring"
    return losses, router


def _act_experts(capsys, tmp_path):
    _, router = _moe_events(capsys, tmp_path)
    assert len(router[0]["expert_load"]) == 4
    assert sum(router[0]["expert_load"]) == pytest.approx(1.0, abs=1e-3)


def _act_moe_top_k(capsys, tmp_path):
    args = tdriver.parse_args([*DBASE, "--experts", "4", "--moe-top-k",
                               "1"])
    assert tdriver.build(args)[0].moe_top_k == 1
    a, _ = _moe_events(capsys, tmp_path)
    b, _ = _moe_events(capsys, tmp_path, "--moe-top-k", 1)
    assert a != b


def _act_capacity(capsys, tmp_path):
    _, loose = _moe_events(capsys, tmp_path)
    _, tight = _moe_events(capsys, tmp_path, "--moe-capacity-factor", 0.25)
    assert tight[0]["drop_fraction"] > loose[0]["drop_fraction"]


def _act_routing(capsys, tmp_path):
    args = tdriver.parse_args([*DBASE, "--experts", "4", "--moe-routing",
                               "priority"])
    assert tdriver.build(args)[0].moe_routing == "priority"
    a, _ = _moe_events(capsys, tmp_path, "--moe-capacity-factor", 0.5)
    b, _ = _moe_events(capsys, tmp_path, "--moe-capacity-factor", 0.5,
                       "--moe-routing", "priority")
    assert a != b


def _act_z_weight(capsys, tmp_path):
    a, _ = _moe_events(capsys, tmp_path)
    b, _ = _moe_events(capsys, tmp_path, "--moe-z-weight", 0.1)
    assert b[0] > a[0]


def _act_ep(capsys, tmp_path):
    a, _ = _moe_events(capsys, tmp_path)
    b, _ = _moe_events(capsys, tmp_path, "--ep", 1)
    assert a == b


ACTS = {"--accum": _act_accum,
        "--remat": _same("--remat"),
        "--remat-policy": _act_remat_policy,
        "--xent-chunk": _act_xent_chunk,
        "--dropout": _differs("--dropout", 0.2, attn="flash"),
        "--attn-dropout": _differs("--attn-dropout", 0.2, attn="ring"),
        "--optimizer adafactor": _act_adafactor,
        "--experts": _act_experts,
        "--moe-top-k": _act_moe_top_k,
        "--moe-capacity-factor": _act_capacity,
        "--moe-routing": _act_routing,
        "--moe-z-weight": _act_z_weight,
        "--ep": _act_ep}


@pytest.mark.parametrize("flag", sorted(ACTS))
def test_ported_flag_acts(capsys, tmp_path, flag):
    """Each flag the driver used to refuse with `NotPorted` now does
    what the root driver's does."""
    assert flag.split()[0] not in tdriver.UNPORTED
    ACTS[flag](capsys, tmp_path)


REFUSED = {
    "accum-experts": ["--accum", "2", "--experts", "4"],
    "flash-attn-dropout": ["--attn", "flash", "--attn-dropout", "0.1"],
    "flash-experts": ["--attn", "flash", "--experts", "4"],
    "top-k-above-experts": ["--experts", "2", "--moe-top-k", "3"],
    "ep-2": ["--ep", "2"],
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_driver_mirrors_the_root_refusals(name):
    """The root driver's guards, with its messages; --ep > 1 needs
    --experts, and with them runs the expert-parallel grid."""
    argv = ["--device", "cpu", *REFUSED[name]]
    if name == "ep-2":
        with pytest.raises(SystemExit, match="--ep requires --experts > 0"):
            tdriver.parse_args(argv)
        assert tdriver.parse_args([*argv, "--experts", "4"]).ep == 2
        return
    with pytest.raises(SystemExit) as e:
        tdriver.parse_args(argv)
    assert re.search(r"--accum composes|--attn-dropout needs|not available "
                     r"with --experts|cannot exceed", str(e.value.code))
