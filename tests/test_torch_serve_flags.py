"""The port's serve driver against the root `serve.py`'s command line:
every root flag the port lacks is refused with `NotPorted` naming its
ROADMAP queue, no root flag is missing from both, and the chaos flags
act (a plan's draw held against the JAX package's `chaos`). The root
driver is read as text; nothing of it is imported."""

import json
import re
from pathlib import Path

import pytest

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch import serve as sdriver

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("flag", sorted(sdriver.UNPORTED))
def test_driver_refuses_root_flags_it_lacks(flag):
    """Each flag of the `UNPORTED` table raises `NotPorted` naming the
    flag and its queue, with or without a value (`--shed-load` takes
    none)."""
    for argv in ([flag, "1"], [flag]):
        with pytest.raises(NotPorted, match=re.escape(flag)) as err:
            sdriver.parse_args(["--device", "cpu", *argv])
        assert err.value.later == sdriver.UNPORTED[flag]
        assert err.value.later.startswith("Queue 1")


def _serve(tmp_path, *extra) -> list:
    """Two greedy requests through a tiny CPU `serve` with `extra`
    flags, no fault plan before or after it in this process; the log's
    records."""
    from shallowspeed_tpu_torch import chaos

    reqs = tmp_path / "r.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in [
        {"id": "a", "prompt": [5, 6, 7], "max_new": 4},
        {"id": "b", "prompt_len": 20, "max_new": 4}]) + "\n")
    log = tmp_path / "m.jsonl"
    chaos.configure(None)
    try:
        assert sdriver.main(["--device", "cpu", "--d-model", "16",
                             "--n-heads", "2", "--n-layers", "1",
                             "--max-seq", "64", "--requests", str(reqs),
                             "--log-file", str(log), *extra]) == 0
    finally:
        chaos.configure(None)
    return [json.loads(x) for x in log.read_text().splitlines()]


def _fault(recs) -> dict:
    fault, = (r for r in recs if r["event"] == "fault")
    return fault


def _act_chaos(tmp_path):
    """A tick-indexed stall: the engine's step hook at tick 2."""
    f = _fault(_serve(tmp_path, "--chaos", "stall@2:0.01"))
    assert (f["kind"], f["step"]) == ("stall", 2)


def _act_chaos_state(tmp_path):
    cs = tmp_path / "cs"
    _fault(_serve(tmp_path, "--chaos", "stall@1:0.01", "--chaos-state",
                  str(cs)))
    assert (cs / "fired_stall_at_1_0.01").exists()
    (tmp_path / "m.jsonl").unlink()
    assert not [r for r in _serve(tmp_path, "--chaos", "stall@1:0.01",
                                  "--chaos-state", str(cs))
                if r["event"] == "fault"]


def _act_chaos_seed(tmp_path):
    """nan@1 poisons the engine's parameter leaf the seed draws, in the
    reference's leaf order."""
    from shallowspeed_tpu.chaos import FaultPlan as JPlan
    from shallowspeed_tpu_torch.chaos import leaf_paths
    from shallowspeed_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(vocab=256, d_model=16, n_heads=2,
                              n_layers=1, max_seq=64)
    n = len(list(leaf_paths(T.init(cfg, seed=0, device="cpu"))))
    ref = JPlan.parse("nan@1", seed=4)
    f = _fault(_serve(tmp_path, "--chaos", "nan@1", "--chaos-seed", "4"))
    assert f["leaf"] == int(ref._rng(ref.faults[0]).integers(0, n))


CHAOS_ACTS = {"--chaos": _act_chaos, "--chaos-state": _act_chaos_state,
              "--chaos-seed": _act_chaos_seed}


@pytest.mark.parametrize("flag", sorted(CHAOS_ACTS))
def test_chaos_flag_acts(tmp_path, flag):
    """Each chaos flag the driver refused with `NotPorted` until the
    fault plane came does what the root driver's does."""
    assert flag not in sdriver.UNPORTED
    CHAOS_ACTS[flag](tmp_path)


def test_driver_covers_every_root_flag():
    """Each flag the root `serve.py` declares is either one of the
    port's own or in its `UNPORTED` table, and the table names only
    root flags."""
    root = re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"',
                      (ROOT / "serve.py").read_text())
    assert len(root) >= 30
    own = {o for a in sdriver.parser()._actions for o in a.option_strings
           if not isinstance(a, sdriver._Refuse)}
    missing = [f for f in root if f not in own and f not in sdriver.UNPORTED]
    assert not missing, missing
    assert set(sdriver.UNPORTED) <= set(root)
    assert not set(sdriver.UNPORTED) & own
