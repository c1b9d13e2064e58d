"""The port's `train_lm --pp` against the root driver: each newly ported
flag's step lines (`--pp`, `--pp-schedule`, `--n-mubatches`,
`--virtual-pp 1`, with --tp, --zero2, --fsdp and --attn flash), each of
the root driver's --pp refusals with its message, the step lines of
--virtual-pp 2, --pp --sp, --pp --ep and --pp --experts (deferred by
an earlier slice), `--generate` through the pipelined decode,
and a --pp 2 zb checkpoint resumed at --dp 2 --pp 2 --tp 2 1f1b.

Tolerances: step lines to their 4 digits (2e-4: the f32 losses, ~1e-7
apart, may round to neighbouring last digits)."""

import re
import signal
import sys
import types
from pathlib import Path

import pytest

from shallowspeed_tpu_torch import train_lm as tdriver

ROOT = Path(__file__).resolve().parent.parent
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


def port(argv):
    return tdriver.main(["--device", "cpu", *argv])


FLAGS = {
    "--pp": ["--pp", "2"],
    "--pp-schedule 1f1b --tp --virtual-pp 1": [
        "--dp", "2", "--pp", "2", "--tp", "2", "--pp-schedule", "1f1b",
        "--n-mubatches", "2", "--virtual-pp", "1"],
    "--pp-schedule zb --attn flash --zero2": [
        "--dp", "2", "--pp", "2", "--pp-schedule", "zb", "--attn", "flash",
        "--zero2", "--n-mubatches", "2", "--grad-clip", "0.5"],
    "--n-mubatches --fsdp": ["--dp", "2", "--pp", "2", "--n-mubatches",
                             "1", "--fsdp", "--optimizer", "adafactor"],
}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_pipeline_flag_matches_the_root_driver(capsys, root_train, flag):
    assert not set(flag.split()) & set(tdriver.UNPORTED)
    argv = [*DBASE, *FLAGS[flag]]
    want = _losses(capsys, root_train, argv)
    got = _losses(capsys, port, argv)
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=2e-4)


REFUSED = {
    "zero-dp1": (["--pp", "2", "--zero1"], "same"),
    "zero2-ep": (["--dp", "2", "--pp", "2", "--zero2", "--ep", "2",
                  "--experts", "4"], "same"),
    "two-axes": (["--pp", "2", "--tp", "2", "--sp", "2"], "same"),
    "vpp-ep": (["--pp", "2", "--virtual-pp", "2", "--ep", "2",
                "--experts", "4"], "same"),
    "experts-tp": (["--pp", "2", "--experts", "4", "--tp", "2"], "same"),
    "sp-flash": (["--pp", "2", "--sp", "2", "--attn", "flash"], "same"),
    "ulysses": (["--pp", "2", "--attn", "ulysses-flash"], "same"),
    "zb-tp": (["--pp", "2", "--tp", "2", "--pp-schedule", "zb"], "same"),
    "zb-vpp": (["--pp", "2", "--virtual-pp", "2", "--pp-schedule", "zb"],
               "same"),
    "zb-experts": (["--pp", "2", "--experts", "4", "--pp-schedule", "zb"],
                   "same"),
    "zb-dropout": (["--pp", "2", "--dropout", "0.1", "--pp-schedule",
                    "zb"], "same"),
    "zb-remat": (["--pp", "2", "--remat", "--pp-schedule", "zb"], "same"),
    "accum": (["--pp", "2", "--accum", "2"], "same"),
    "attn-dropout": (["--pp", "2", "--attn-dropout", "0.1"],
                     "--attn-dropout needs"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_driver_mirrors_the_root_pipeline_refusals(root_train, name):
    extra, want = REFUSED[name]
    argv = [*DBASE, *extra]
    with pytest.raises(SystemExit) as root:
        root_train(argv)
    with pytest.raises(SystemExit) as got:
        port(argv)
    if want == "same":
        assert got.value.code == root.value.code
    else:
        assert want in str(got.value.code)


def test_microbatches_must_divide_the_batch(root_train):
    """The engines' own check, the reference's message."""
    argv = [*DBASE, "--pp", "2", "--n-mubatches", "3"]
    with pytest.raises(AssertionError) as root:
        root_train(argv)
    with pytest.raises(AssertionError) as got:
        port(argv)
    assert str(got.value) == str(root.value)


@pytest.mark.parametrize("extra", [
    ["--pp", "2", "--virtual-pp", "2", "--n-layers", "4"],
    ["--pp", "2", "--sp", "2", "--attn", "ring"],
    ["--pp", "2", "--ep", "2", "--experts", "4"],
    ["--pp", "2", "--experts", "4"]], ids=["vpp", "sp", "ep", "experts"])
def test_deferred_pipeline_layouts_are_not_ported(capsys, root_train, extra):
    """The layouts an earlier slice deferred: their step lines are the
    root driver's."""
    argv = [*DBASE, "--n-mubatches", "2", *extra]
    want = _losses(capsys, root_train, argv)
    got = _losses(capsys, port, argv)
    assert len(got) == len(want) == 3
    assert got == pytest.approx(want, abs=2e-4)


def test_generate_runs_the_pipelined_decode(capsys):
    """--pp 2 --generate samples on the pp-cut parameters; its greedy
    stream is the one-device driver's on the same training."""
    argv = [*DBASE, "--steps", "2", "--generate", "12", "--temperature",
            "0"]
    port([*argv, "--pp", "2"])
    out = capsys.readouterr().out
    assert "pp-sharded decode" in out
    sample = [x for x in out.splitlines() if x.startswith("sample:")]
    port([*argv, "--attn", "ring"])
    one = [x for x in capsys.readouterr().out.splitlines()
           if x.startswith("sample:")]
    assert sample == one and len(sample) == 1


def test_pipeline_checkpoint_resumes_across_layouts(tmp_path, capsys):
    """--pp 2 zb saves at step 1; --dp 2 --pp 2 --tp 2 1f1b resumes it
    and continues the one-device run's losses."""
    base = [*DBASE, "--save-dir", str(tmp_path / "ck"), "--save-every", "2",
            "--n-mubatches", "2"]
    port([*base, "--steps", "2", "--pp", "2", "--pp-schedule", "zb"])
    capsys.readouterr()
    port([*base, "--steps", "4", "--resume", "--dp", "2", "--pp", "2",
          "--tp", "2", "--pp-schedule", "1f1b"])
    out = capsys.readouterr().out
    assert "at step 2" in out
    resumed = [float(m.group(2)) for m in map(STEP.match, out.splitlines())
               if m]
    straight = _losses(capsys, port, [*DBASE, "--steps", "4", "--attn",
                                      "ring"])
    assert len(resumed) == 2
    assert resumed == pytest.approx(straight[2:], abs=2e-4)
