"""The port's root scripts (`shallowspeed_tpu_torch.plot_schedule`,
`DDP_PyTorch_MNIST`, `bench_mfu`, `bench_decode`, `bench_attention`,
`bench_pipeline`, `bench_layout`) and the driver's asynchronous step
loop, on the CPU at tiny sizes.

- `plot_schedule` prints and writes, letter for letter, what the root
  `scripts/plot_schedule.py` does;
- `DDP_PyTorch_MNIST` trains to the root script's accuracies and weight
  divergence on the same synthetic set;
- each benchmark runs and prints the reference's keys (its numbers are
  the CPU's);
- `train_lm`'s loop reads the loss from the step only at `sync_every`
  steps and logs the losses the run with `train_batch` standing in for
  the asynchronous step logs.
"""

import json
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (torch on one intra-op thread)

from shallowspeed_tpu_torch import train_lm as tdriver
from shallowspeed_tpu_torch.data.prefetch import sync_every
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine

ROOT = Path(__file__).resolve().parent.parent


def _root_script(name, argv, monkeypatch):
    """Run the root `scripts/<name>.py` as __main__ with `argv`."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return runpy.run_path(str(ROOT / "scripts" / f"{name}.py"),
                          run_name="__main__")


# -------------------------------------------------------- plot_schedule

@pytest.mark.parametrize("pp,n_mu,vpp", [(4, 8, 2), (2, 4, 2), (3, 5, 0)])
def test_plot_schedule_equals_the_root_script(pp, n_mu, vpp, tmp_path,
                                              capsys, monkeypatch):
    from shallowspeed_tpu_torch import plot_schedule

    flags = ["--pp", str(pp), "--n-mu", str(n_mu), "--virtual-pp", str(vpp)]
    want_svg, got_svg = tmp_path / "root.svg", tmp_path / "port.svg"
    _root_script("plot_schedule", [*flags, "--svg", str(want_svg)],
                 monkeypatch)
    want = capsys.readouterr().out
    assert plot_schedule.main([*flags, "--svg", str(got_svg)]) == 0
    got = capsys.readouterr().out
    assert got.replace(str(got_svg), str(want_svg)) == want
    assert got_svg.read_text() == want_svg.read_text()
    assert "ZB-H1" in got and ("interleaved" in got) == (vpp > 1)


# ---------------------------------------------------- DDP_PyTorch_MNIST

def test_ddp_mnist_equals_the_root_script(tmp_path, capsys, monkeypatch):
    """One epoch of both scripts on the same 2048-sample synthetic set
    (written first, so both reuse it): the same accuracy lines and
    divergence, the DDP replicas identical (the script asserts it)."""
    from shallowspeed_tpu_torch import DDP_PyTorch_MNIST as ddp
    from shallowspeed_tpu_torch.data.mnist import prepare_mnist

    data = prepare_mnist(tmp_path / "mnist", n_samples=2048)
    flags = ["--epochs", "1", "--ranks", "4", "--data-dir", str(data)]
    threads = torch.get_num_threads()
    try:
        _root_script("DDP_PyTorch_MNIST", flags, monkeypatch)
        want = capsys.readouterr().out.splitlines()
        got = ddp.main([*flags, "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    lines = capsys.readouterr().out.splitlines()

    def tail(ln):       # the line without its seconds
        return re.sub(r"^(\S+( x\d+)?): [\d.]+s, ", r"\1: ", ln)

    assert [tail(x) for x in lines] == [tail(x) for x in want]
    assert got["ranks"] == 4 and got["device"] == "cpu"
    assert got["divergence"] < 1e-3
    assert 0.0 <= got["serial_accuracy"] <= 1.0


# --------------------------------------------------------- benchmarks

REF_MFU_KEYS = {"metric", "config", "tokens_per_sec", "flops_per_token",
                "tflops", "peak_tflops", "mfu"}


def test_bench_mfu_runs_on_the_cpu(capsys):
    from shallowspeed_tpu.flops import transformer_flops_per_token as jflops
    from shallowspeed_tpu.models.transformer import TransformerConfig

    from shallowspeed_tpu_torch import bench_mfu

    out = bench_mfu.main(["--device", "cpu", "--d-model", "64",
                          "--n-heads", "1", "--n-layers", "1",
                          "--seq-len", "16", "--batch-size", "2",
                          "--steps", "2"])
    assert json.loads(capsys.readouterr().out) == out
    assert set(out) == REF_MFU_KEYS
    assert out["metric"] == "transformer_train_mfu"
    assert out["mfu"] is None and out["peak_tflops"] is None
    assert out["tokens_per_sec"] > 0
    cfg = TransformerConfig(vocab=256, d_model=64, n_heads=1, n_layers=1,
                            max_seq=16, rope=True, norm="rmsnorm",
                            ffn="swiglu")
    assert out["flops_per_token"] == round(jflops(cfg, 16))


def test_bench_mfu_times_train_run(monkeypatch):
    """Four runs (one excluded) of `train_run` over `--steps` steps."""
    from shallowspeed_tpu_torch import bench_mfu

    calls = []
    run = ContextParallelEngine.train_run

    def counted(self, toks, tgts):
        calls.append(np.asarray(toks).shape)
        return run(self, toks, tgts)

    monkeypatch.setattr(ContextParallelEngine, "train_run", counted)
    bench_mfu.run(bench_mfu.parse_args([
        "--device", "cpu", "--d-model", "64", "--n-heads", "1",
        "--n-layers", "1", "--seq-len", "8", "--batch-size", "1",
        "--steps", "3"]))
    assert calls == [(3, 1, 8)] * 4


REF_DECODE_KEYS = {"metric", "config", "prefill_tokens_per_sec",
                   "decode_tokens_per_sec", "decode_ms_per_token"}


def test_bench_decode_run_config_on_the_cpu():
    from shallowspeed_tpu_torch import bench_decode

    out = bench_decode.run_config(batch=2, prompt_len=8, max_seq=48,
                                  d_model=64, n_layers=1, n_heads=1,
                                  device="cpu")
    assert set(out) == REF_DECODE_KEYS
    assert out["config"]["kv_heads"] == 1 and out["config"]["kv_quant"] \
        == "bf16"
    assert out["prefill_tokens_per_sec"] > 0


def test_bench_decode_int8_cache_and_main(monkeypatch, capsys):
    from shallowspeed_tpu_torch import bench_decode

    monkeypatch.setattr(bench_decode, "CONFIGS", (
        dict(batch=1, prompt_len=8, max_seq=48, d_model=64, n_layers=1,
             n_heads=2, kv_heads=1, kv_quant="int8"),))
    rows = bench_decode.main(["--device", "cpu"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows and len(rows) == 1
    assert rows[0]["config"]["kv_quant"] == "int8"


def test_bench_decode_pipelined_on_the_cpu():
    from shallowspeed_tpu_torch import bench_decode

    out = bench_decode.run_pp_config(2, batch=2, prompt_len=8, max_seq=40,
                                     d_model=32, n_layers=2, n_heads=2,
                                     device="cpu")
    assert set(out) == {"metric", "config", "decode_tokens_per_sec",
                        "decode_ms_per_token"}
    assert out["metric"] == "pp_decode_throughput"
    assert out["config"]["pp"] == 2


LINE = re.compile(r"T= +(\d+) (fwd|fwd\+bwd) +xla +[\d.]+ ms   flash +[\d.]+ "
                  r"ms   speedup +[\d.]+x   sdpa +[\d.]+ ms")


def test_bench_attention_prints_the_reference_lines(capsys):
    from shallowspeed_tpu_torch import bench_attention

    rows = bench_attention.main(["--device", "cpu", "--seqs", "16", "32",
                                 "--batch", "1", "--heads", "2",
                                 "--head-dim", "64", "--reps", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [LINE.fullmatch(x).groups() for x in lines] == [
        ("16", "fwd"), ("16", "fwd+bwd"), ("32", "fwd"), ("32", "fwd+bwd")]
    assert [(r["seq"], r["pass"]) for r in rows] == [
        (16, "fwd"), (16, "fwd+bwd"), (32, "fwd"), (32, "fwd+bwd")]


def test_bench_attention_variants_agree():
    """The three timed functions compute one attention: outputs and
    gradients within f32 rounding of each other."""
    from shallowspeed_tpu_torch import bench_attention as BA

    args = BA.parse_args(["--device", "cpu", "--batch", "1", "--heads", "2",
                          "--head-dim", "64", "--dtype", "f32"])
    q, k, v = BA.inputs(np.random.default_rng(0), 24, args, "cpu")
    ref = BA.plain(q, k, v)
    gref = BA.grads(BA.plain)(q, k, v)
    for fn in (BA.flash, BA.sdpa):
        assert torch.allclose(BA.forward(fn)(q, k, v), ref, atol=1e-5)
        for g, r in zip(BA.grads(fn)(q, k, v), gref):
            assert torch.allclose(g, r, atol=1e-4, rtol=1e-4)


REF_PIPELINE_KEYS = {
    "metric", "substrate", "config", "gpipe_tokens_per_sec",
    "1f1b_tokens_per_sec", "1f1b_over_gpipe", "zb_tokens_per_sec",
    "zb_over_1f1b", "zb_over_gpipe", "interleaved_tokens_per_sec",
    "interleaved_over_gpipe", "interleaved_1f1b_tokens_per_sec",
    "interleaved_1f1b_over_gpipe", "sp", "sp_gpipe_tokens_per_sec",
    "sp_1f1b_tokens_per_sec", "sp_1f1b_over_gpipe"}


def test_bench_pipeline_on_the_cpu(capsys, monkeypatch):
    """Every schedule's run of the reference's JSON, each through the
    asynchronous step."""
    from shallowspeed_tpu_torch import bench_pipeline

    seen = []
    step = GSPMDEngine.train_batch_async

    def counted(self, tok, tgt):
        seen.append(self.schedule)
        return step(self, tok, tgt)

    monkeypatch.setattr(GSPMDEngine, "train_batch_async", counted)
    out = bench_pipeline.main(["--device", "cpu", "--d-model", "64",
                               "--n-layers", "4", "--seq-len", "8",
                               "--batch-size", "4", "--n-mu", "2",
                               "--steps", "1", "--sp", "2"])
    assert json.loads(capsys.readouterr().out) == out
    assert set(out) == REF_PIPELINE_KEYS
    assert out["substrate"] == "cpu-2cells-one-device"
    # each engine: its warm-up train_batch, then 3 timed runs of 1 step
    assert seen == [s for s in ("gpipe", "1f1b", "zb", "gpipe", "1f1b",
                                "gpipe", "1f1b") for _ in range(4)]


def test_bench_layout_on_the_cpu(capsys):
    from shallowspeed_tpu_torch import bench_layout

    out = bench_layout.main(["--device", "cpu", "--batch", "1",
                             "--seq-len", "16", "--n-heads", "2",
                             "--head-dim", "64", "--steps", "2",
                             "--rounds", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    names = ["token_major", "head_major", "hm_qkv_only", "hm_out_only",
             "no_permute_lower_bound"]
    assert [ln["variant"] for ln in lines[:-1]] == names
    assert set(lines[-1]) == {"metric", "best_variant", "value", "verdict"}
    assert lines[-1] == out["verdict"]


def test_bench_layout_variants_share_the_math():
    """token_major, head_major and the two half variants compute the same
    gradients from the same weight bits (bf16 rounding apart);
    no_permute differs (its math is deliberately wrong)."""
    from shallowspeed_tpu_torch import bench_layout

    args = bench_layout.parse_args(["--batch", "1", "--seq-len", "16",
                                    "--n-heads", "2", "--head-dim", "64",
                                    "--steps", "2"])
    probes = {k: run().float() for k, run in
              bench_layout.build(args, torch.device("cpu")).items()}
    ref = probes.pop("token_major")
    wrong = probes.pop("no_permute_lower_bound")
    for name, got in probes.items():
        assert torch.allclose(got, ref, rtol=2e-2, atol=0.0), name
    assert not torch.allclose(wrong, ref, rtol=2e-2, atol=0.0)


# ------------------------------------------------ the driver's step loop

class _Read:
    """A step's loss that records the steps at which the driver reads it."""

    def __init__(self, loss, step, reads):
        self.loss, self.step, self.reads = loss, step, reads

    def __float__(self):
        self.reads.append(self.step)
        return float(self.loss)


FLAGS = ["--device", "cpu", "--steps", "7", "--seq-len", "16",
         "--batch-size", "4", "--d-model", "32", "--n-heads", "2",
         "--n-layers", "2", "--rope", "--norm", "rmsnorm", "--ffn",
         "swiglu", "--optimizer", "adamw", "--lr", "1e-2"]
ENGINES = {"context": ([], ContextParallelEngine),
           "pipeline": (["--pp", "2"], GSPMDEngine)}


@pytest.mark.parametrize("log_every", [1, 3])
@pytest.mark.parametrize("layout", sorted(ENGINES))
def test_driver_reads_the_loss_at_log_points_only(layout, log_every, capsys,
                                                  monkeypatch, tmp_path):
    """`train_lm`'s loop on `train_batch_async`: the loss is read at the
    `sync_every` steps only (the last included), and the step lines and
    events equal those of the run with `train_batch` standing in for
    the asynchronous step."""
    extra, cls = ENGINES[layout]
    flags = [*FLAGS, *extra, "--log-every", str(log_every)]
    step = cls.train_batch_async

    def run(standin):
        reads, count = [], []

        def lazy(self, tok, tgt):
            count.append(None)
            if standin:      # train_batch: the loss read at every step
                return torch.tensor(float(step(self, tok, tgt)))
            return _Read(step(self, tok, tgt), len(count) - 1, reads)

        log = tmp_path / f"{standin}.jsonl"
        monkeypatch.setattr(cls, "train_batch_async", lazy)
        tdriver.main([*flags, "--log-file", str(log)])
        monkeypatch.setattr(cls, "train_batch_async", step)
        lines = [re.sub(r"  tok/s.*", "", x) for x in
                 capsys.readouterr().out.splitlines()
                 if x.startswith("step")]
        events = [(e["step"], e["loss"]) for e in
                  map(json.loads, log.read_text().splitlines())
                  if e.get("event") == "step"]
        return reads, lines, events, len(count)

    reads, lines, events, n = run(False)
    ref_reads, ref_lines, ref_events, _ = run(True)
    assert n == 7
    assert reads == [s for s in range(7) if sync_every(s, log_every, 7)]
    assert lines == ref_lines and events == ref_events
    assert [s for s, _ in events] == reads
