"""The port's serve driver against the root `serve.py`'s command line:
every root flag the port lacks is refused with `NotPorted` naming its
ROADMAP queue, and no root flag is missing from both. The root driver
is read as text; nothing of it is imported."""

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
