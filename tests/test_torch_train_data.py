"""The port's `train_lm` on text, token shards and checkpoints, and
`serve --ckpt`, on the CPU (`--device cpu`, 1 layer, d_model 16).

- Text preparation and batches equal the root driver's, exactly.
- A run saved at step 4 and resumed to step 6 prints the loss lines of
  a straight 6-step run (the same float32 arithmetic on the same
  state), and the resumed losses stay within 1e-4 relative of the JAX
  engine's trajectory over the same batches (the bound of
  `tests/test_torch_train.py`).
- --auto-resume, --sample-only, --val-every, --ema-decay, BPE
  tokenizers under --save-dir, failed and skipped saves, and one case
  per data/checkpoint flag showing that it acts.
- `serve --ckpt` on a checkpoint the JAX package saved gives the same
  greedy streams as the port serving those params directly.
"""

import contextlib
import io
import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import train_lm as jdriver
from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JaxEngine)
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch import serve as tserve
from shallowspeed_tpu_torch import train_lm as tdriver
from shallowspeed_tpu_torch.data import TokenShards, build_shards
from shallowspeed_tpu_torch.models import generate as G
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.serving.engine import ServingEngine
from shallowspeed_tpu_torch.weights import params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
TEXT = (ROOT / "SURVEY.md").read_bytes()[:6_000]
BASE = ["--device", "cpu", "--seq-len", "16", "--d-model", "16",
        "--n-heads", "2", "--n-layers", "1", "--batch-size", "2",
        "--log-every", "1"]
STEP = re.compile(r"step +(\d+)  loss (\S+)  tok/s")


def run(*argv) -> list[str]:
    """`train_lm.main(BASE + argv)`'s stdout lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tdriver.main([*BASE, *map(str, argv)]) == 0
    return buf.getvalue().splitlines()


def loss_lines(lines) -> list:
    return [m.groups() for m in map(STEP.match, lines) if m]


def val_lines(lines) -> list:
    return [ln for ln in lines if "val_loss" in ln]


@pytest.fixture
def text(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_bytes(TEXT)
    return path


@pytest.fixture
def shards(tmp_path):
    build_shards(np.frombuffer(TEXT, np.uint8).astype(np.int32),
                 tmp_path / "shards", 256, shard_tokens=2_000,
                 val_fraction=0.1)
    return tmp_path / "shards"


# ------------------------------------------------ data vs the root driver


@pytest.mark.parametrize("mode", ["bytes", "bytes-val", "bpe", "shards"])
def test_prepared_data_and_batches_match_the_root_driver(tmp_path, text,
                                                         shards, mode):
    flags = {"bytes": ["--text", text],
             "bytes-val": ["--text", text, "--val-every", "3"],
             "bpe": ["--text", text, "--tokenizer", "bpe", "--vocab-size",
                     "300", "--val-every", "3", "--save-dir",
                     tmp_path / "ck"],
             "shards": ["--data-dir", shards, "--val-every", "3"]}[mode]
    flags = [str(f) for f in ["--seq-len", "16", "--batch-size", "3",
                              "--seed", "4", *flags]]
    args = tdriver.parse_args(["--device", "cpu", *flags])
    jargs = jdriver.parse_args(flags)
    vocab, tok, data, val = tdriver.prepare_text(args)
    jvocab, jtok, jdata, jval = jdriver.prepare_text(jargs)
    assert vocab == jvocab
    assert (tok is None) == (jtok is None)
    if tok is not None:
        assert tok.merges == jtok.merges and vocab == 300
        assert (tmp_path / "ck" / "tokenizer.json").exists()
    for step in (0, 5, 10**9 + 2):
        for src, jsrc in ((data, jdata), (val, jval)):
            if jsrc is None:
                assert src is None
                continue
            for g, r in zip(tdriver.make_batch(args, vocab, step, src),
                            jdriver.make_batch(jargs, jvocab, step, jsrc)):
                np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("flags,match", [
    (["--tokenizer", "bpe"], "tokenizer.json"),
    (["--text", "x.txt"], "replaces --text"),
    (["--val-every", "2", "--seq-len", "600"], "val.bin holds"),
], ids=["bpe-on-byte-shards", "data-dir-and-text", "short-val"])
def test_shard_flags_are_validated(shards, flags, match):
    args = tdriver.parse_args(["--device", "cpu", "--data-dir",
                               str(shards), *flags])
    with pytest.raises(SystemExit, match=match):
        tdriver.prepare_text(args)


# ------------------------------------------------------ save and resume


@pytest.mark.parametrize("source", ["text", "shards"])
def test_resume_prints_the_straight_runs_losses(tmp_path, text, shards,
                                                source):
    data = ["--text", text] if source == "text" else ["--data-dir", shards]
    flags = [*data, "--val-every", "2"]
    straight = run(*flags, "--steps", 6)
    first = run(*flags, "--steps", 4, "--save-dir", tmp_path / "ck",
                "--save-every", 2)
    resumed = run(*flags, "--steps", 6, "--save-dir", tmp_path / "ck",
                  "--save-every", 2, "--resume")
    assert f"resumed from {tmp_path / 'ck' / 'ckpt_3'} at step 4" in resumed
    assert loss_lines(first) + loss_lines(resumed) == loss_lines(straight)
    assert len(loss_lines(straight)) == 6
    assert val_lines(first) + val_lines(resumed) == val_lines(straight)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_1", "ckpt_3", "ckpt_5"]


def test_resumed_run_follows_the_jax_engines_trajectory(tmp_path, shards):
    """The port driver's run, saved at step 2 and resumed, against the
    JAX engine trained on the same six shard batches from the same
    draw (Adam, the driver's default)."""
    seen = []
    step = ContextParallelEngine.train_batch_async

    def recorded(self, tok, tgt):
        loss = step(self, tok, tgt)
        seen.append(float(loss))
        return loss

    ContextParallelEngine.train_batch_async = recorded
    try:
        run("--data-dir", shards, "--steps", 3, "--save-dir",
            tmp_path / "ck", "--save-every", 3)
        run("--data-dir", shards, "--steps", 6, "--save-dir",
            tmp_path / "ck", "--resume")
    finally:
        ContextParallelEngine.train_batch_async = step
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    je = JaxEngine(JT.TransformerConfig(vocab=256, d_model=16, n_heads=2,
                                        n_layers=1, max_seq=16),
                   JO.Adam(1e-3), mesh, seed=0, attn="ring")
    data = TokenShards(shards, 16)
    ref = [je.train_batch(*data.batch(s, 2)) for s in range(6)]
    assert len(seen) == 6
    for got, want in zip(seen, ref):
        assert abs(got - want) / abs(want) <= 1e-4


def test_auto_resume_starts_fresh_then_resumes(tmp_path, shards):
    ck = tmp_path / "ck"
    fresh = run("--data-dir", shards, "--steps", 2, "--save-dir", ck,
                "--auto-resume")
    assert not any("resumed" in ln for ln in fresh)
    assert [s for s, _ in loss_lines(fresh)] == ["0", "1"]
    again = run("--data-dir", shards, "--steps", 4, "--save-dir", ck,
                "--auto-resume")
    assert f"resumed from {ck / 'ckpt_1'} at step 2" in again
    assert [s for s, _ in loss_lines(again)] == ["2", "3"]
    for p in ck.glob("ckpt_*"):
        (p / "params.npz").write_bytes(b"rot")
    with pytest.warns(UserWarning, match="quarantin"):
        over = run("--data-dir", shards, "--steps", 2, "--save-dir", ck,
                   "--auto-resume")
    assert any("starting fresh" in ln for ln in over)
    assert loss_lines(over) == loss_lines(fresh)


def test_strict_resume_with_every_checkpoint_corrupt_exits_65(tmp_path,
                                                              shards):
    ck = tmp_path / "ck"
    run("--data-dir", shards, "--steps", 2, "--save-dir", ck,
        "--save-every", 1)
    for p in ck.glob("ckpt_*"):
        (p / "opt.npz").write_bytes(b"rot")
    with pytest.warns(UserWarning), pytest.raises(SystemExit) as err:
        run("--data-dir", shards, "--steps", 4, "--save-dir", ck,
            "--resume")
    assert err.value.code == C.EXIT_CORRUPT_CKPT == 65
    assert sorted(p.name for p in ck.iterdir()) == [
        "ckpt_0.corrupt", "ckpt_1.corrupt"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        run("--steps", 2, "--save-dir", tmp_path / "empty", "--resume")


def test_sample_only_generates_from_the_checkpoint(tmp_path, shards):
    ck = tmp_path / "ck"
    run("--data-dir", shards, "--seq-len", 32, "--steps", 3, "--save-dir",
        ck)
    out = run("--data-dir", shards, "--seq-len", 32, "--save-dir", ck,
              "--sample-only", "--generate", 6, "--temperature", 0)
    assert not loss_lines(out)
    cfg = T.TransformerConfig(vocab=256, d_model=16, n_heads=2, n_layers=1,
                              max_seq=32)
    params = params_from_numpy(C.load_params(ck / "ckpt_2",
                                             T.param_shapes(cfg)), "cpu")
    prompt = TokenShards(shards, 32).batch(0, 2)[0][:1, :16]
    want = G.generate(params, prompt, cfg, 6, temperature=0.0)
    assert f"sample: {bytes(int(x) for x in want[0])!r}" in out
    assert f"prompt: {bytes(int(x) for x in prompt[0])!r}" in out


def test_bpe_tokenizer_is_saved_and_reused_on_resume(tmp_path, text):
    ck = tmp_path / "ck"
    flags = ["--text", text, "--tokenizer", "bpe", "--vocab-size", 300,
             "--save-dir", ck, "--prompt", "the ", "--generate", 4]
    first = run(*flags, "--steps", 2)
    saved = (ck / "tokenizer.json").read_bytes()
    text.write_bytes(TEXT[::-1])      # a retrain would give other merges
    again = run(*flags, "--steps", 3, "--resume")
    assert (ck / "tokenizer.json").read_bytes() == saved
    assert "resumed from" in "\n".join(again)
    assert [ln for ln in first if ln.startswith("prompt:")] == [
        "prompt: b'the '"]


def test_val_every_prints_and_logs_held_out_loss(tmp_path, shards):
    log = tmp_path / "m.jsonl"
    out = run("--data-dir", shards, "--steps", 5, "--val-every", 2,
              "--log-file", log)
    vals = val_lines(out)
    assert [ln.split()[1] for ln in vals] == ["1", "3", "4"]
    assert all(re.fullmatch(r"step +\d+  val_loss \d+\.\d{4}  ppl [\d,.]+",
                            ln) for ln in vals)
    events = [json.loads(x) for x in log.read_text().splitlines()]
    assert [e["step"] for e in events if e["event"] == "val"] == [1, 3, 4]


def test_ema_update_matches_jax():
    rng = np.random.default_rng(0)
    ema = {"a": rng.normal(size=(5, 7)).astype(np.float32)}
    par = {"a": rng.normal(size=(5, 7)).astype(np.float32)}
    ref = JO.ema_update(jax.tree_util.tree_map(jax.numpy.asarray, ema),
                        par, 0.9)
    got = O.ema_update(params_from_numpy(ema, "cpu"),
                       params_from_numpy(par, "cpu"), 0.9)
    # the same two products and sum in f32; XLA may fuse them into an
    # FMA, so each element is held to one f32 rounding of each term and
    # of the sum: 2^-22 (|d e| + |(1 - d) p|)
    bound = 2.0 ** -22 * (0.9 * np.abs(ema["a"]) + 0.1 * np.abs(par["a"]))
    assert np.all(np.abs(got["a"].numpy() - np.asarray(ref["a"])) <= bound)
    copy = O.ema_init(got)
    assert copy["a"] is not got["a"] and torch.equal(copy["a"], got["a"])


def test_ema_rides_the_checkpoint_and_resumes_exactly(tmp_path, shards):
    flags = ["--data-dir", shards, "--ema-decay", 0.5, "--val-every", 3,
             "--seq-len", 32]
    run(*flags, "--steps", 6, "--save-dir", tmp_path / "a",
        "--save-every", 6)
    run(*flags, "--steps", 3, "--save-dir", tmp_path / "b",
        "--save-every", 3)
    resumed = run(*flags, "--steps", 6, "--save-dir", tmp_path / "b",
                  "--resume")
    assert not any("NOT be continued" in ln for ln in resumed)
    ema_a = C.load_pytree(tmp_path / "a/ckpt_5/ema.npz")
    ema_b = C.load_pytree(tmp_path / "b/ckpt_5/ema.npz")
    params = C.load_pytree(tmp_path / "b/ckpt_5/params.npz")
    np.testing.assert_array_equal(ema_a["tok_emb"], ema_b["tok_emb"])
    assert not np.array_equal(ema_b["tok_emb"], params["tok_emb"])
    out = run("--data-dir", shards, "--seq-len", 32, "--save-dir",
              tmp_path / "b", "--sample-only", "--generate", 4)
    assert any("sampling the average" in ln for ln in out)


def test_failed_save_warns_and_training_goes_on(tmp_path, shards,
                                                monkeypatch):
    def full_disk(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(C, "save", full_disk)
    out = run("--data-dir", shards, "--steps", 3, "--save-dir",
              tmp_path / "ck", "--save-every", 1)
    assert sum("checkpoint save failed" in ln for ln in out) == 3
    assert len(loss_lines(out)) == 3


def test_nonfinite_loss_skips_the_save_then_stops_at_a_log_point(
        tmp_path, shards, monkeypatch):
    step = ContextParallelEngine.train_batch_async
    calls = []

    def poisoned(self, tok, tgt):
        calls.append(step(self, tok, tgt))
        return (torch.full_like(calls[-1], float("nan"))
                if len(calls) in (2, 4) else calls[-1])

    monkeypatch.setattr(ContextParallelEngine, "train_batch_async", poisoned)
    ck = tmp_path / "ck"
    with pytest.raises(SystemExit, match="non-finite"):
        run("--data-dir", shards, "--steps", 6, "--save-dir", ck,
            "--save-every", 2, "--log-every", 3)
    # step 1 (a save point, not a log point) skipped its save; step 3
    # (a save and log point) stopped the run with a forensic snapshot
    assert sorted(p.name for p in ck.iterdir()) == ["diverged"]
    assert [p.name for p in (ck / "diverged").iterdir()] == ["ckpt_3"]


# --------------------------------------------- one case per ported flag


def _act_data_dir(tmp_path, shards, text):
    args = tdriver.parse_args([*BASE, "--data-dir", str(shards)])
    vocab, _, data, val = tdriver.prepare_text(args)
    assert vocab == 256 and isinstance(data, TokenShards) and val is not None
    np.testing.assert_array_equal(tdriver.make_batch(args, vocab, 3, data)[0],
                                  data.batch(3, 2)[0])


def _act_text(tmp_path, shards, text):
    args = tdriver.parse_args([*BASE, "--text", str(text)])
    vocab, tok, data, _ = tdriver.prepare_text(args)
    assert vocab == 256 and tok is None
    np.testing.assert_array_equal(data, np.frombuffer(TEXT, np.uint8))


def _act_tokenizer(tmp_path, shards, text):
    args = tdriver.parse_args([*BASE, "--text", str(text), "--tokenizer",
                               "bpe"])
    vocab, tok, data, _ = tdriver.prepare_text(args)
    assert vocab == tok.vocab_size > 256 and len(data) < len(TEXT)


def _act_vocab_size(tmp_path, shards, text):
    args = tdriver.parse_args([*BASE, "--text", str(text), "--tokenizer",
                               "bpe", "--vocab-size", "280"])
    assert tdriver.prepare_text(args)[0] == 280


def _act_save_dir(tmp_path, shards, text):
    run("--steps", 2, "--save-dir", tmp_path / "ck")
    C.verify(tmp_path / "ck" / "ckpt_1")


def _act_resume(tmp_path, shards, text):
    run("--steps", 2, "--save-dir", tmp_path / "ck")
    out = run("--steps", 3, "--save-dir", tmp_path / "ck", "--resume")
    assert [s for s, _ in loss_lines(out)] == ["2"]


def _act_auto_resume(tmp_path, shards, text):
    run("--steps", 2, "--save-dir", tmp_path / "ck")
    out = run("--steps", 3, "--save-dir", tmp_path / "ck", "--auto-resume")
    assert any(ln.startswith("resumed from") for ln in out)


def _act_save_every(tmp_path, shards, text):
    run("--steps", 5, "--save-dir", tmp_path / "ck", "--save-every", 2)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "ckpt_1", "ckpt_3", "ckpt_4"]


def _keep(flag):
    def act(tmp_path, shards, text):
        run("--steps", 4, "--save-dir", tmp_path / "ck", "--save-every", 1,
            flag, 2)
        assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
            "ckpt_2", "ckpt_3"]
    return act


def _act_async_save(tmp_path, shards, text):
    run("--steps", 2, "--save-dir", tmp_path / "s")
    run("--steps", 2, "--save-dir", tmp_path / "a", "--async-save")
    for f in ("params.npz", "opt.npz"):
        a = C.load_pytree(tmp_path / "a/ckpt_1" / f)
        s = C.load_pytree(tmp_path / "s/ckpt_1" / f)
        np.testing.assert_array_equal(a["m"]["tok_emb"] if "m" in a
                                      else a["tok_emb"],
                                      s["m"]["tok_emb"] if "m" in s
                                      else s["tok_emb"])


def _act_prefetch(tmp_path, shards, text):
    from shallowspeed_tpu_torch.data import prefetch

    made = []
    real = prefetch.DevicePrefetcher

    class Spy(real):
        def __init__(self, it, place, depth=2):
            made.append(depth)
            super().__init__(it, place, depth)

    prefetch.DevicePrefetcher = Spy
    try:
        deep = run("--data-dir", shards, "--steps", 3, "--prefetch", 3)
        sync = run("--data-dir", shards, "--steps", 3, "--prefetch", 0)
    finally:
        prefetch.DevicePrefetcher = real
    assert made == [3] and loss_lines(deep) == loss_lines(sync)


def _act_val_every(tmp_path, shards, text):
    out = run("--steps", 2, "--val-every", 1)
    assert len(val_lines(out)) == 2


def _act_sample_only(tmp_path, shards, text):
    run("--seq-len", 32, "--steps", 2, "--save-dir", tmp_path / "ck")
    out = run("--seq-len", 32, "--save-dir", tmp_path / "ck",
              "--sample-only", "--generate", 3)
    assert not loss_lines(out) and any(ln.startswith("sample:")
                                       for ln in out)


def _act_ema_decay(tmp_path, shards, text):
    run("--steps", 2, "--save-dir", tmp_path / "ck", "--ema-decay", 0.9)
    ema = C.load_pytree(tmp_path / "ck/ckpt_1/ema.npz")
    par = C.load_pytree(tmp_path / "ck/ckpt_1/params.npz")
    assert C._structure_mismatch(ema, par) is None
    assert not np.array_equal(ema["head"]["W"], par["head"]["W"])


ACTS = {"--data-dir": _act_data_dir, "--text": _act_text,
        "--tokenizer": _act_tokenizer, "--vocab-size": _act_vocab_size,
        "--save-dir": _act_save_dir, "--resume": _act_resume,
        "--auto-resume": _act_auto_resume, "--save-every": _act_save_every,
        "--keep-checkpoints": _keep("--keep-checkpoints"),
        "--keep-last": _keep("--keep-last"),
        "--async-save": _act_async_save, "--prefetch": _act_prefetch,
        "--val-every": _act_val_every, "--sample-only": _act_sample_only,
        "--ema-decay": _act_ema_decay}


@pytest.mark.parametrize("flag", sorted(ACTS))
def test_ported_flag_acts(tmp_path, shards, text, flag):
    """Each flag the driver used to refuse with `NotPorted` now does
    what the root driver's does."""
    assert flag not in tdriver.UNPORTED
    ACTS[flag](tmp_path, shards, text)


# ------------------------------------------------------------ serve --ckpt


def test_serve_ckpt_serves_a_jax_checkpoint(tmp_path, capsys, monkeypatch):
    """A JAX engine of the serve driver's default model, trained one
    step and saved by the JAX package; `serve --ckpt` on it streams what
    the port's engine streams over those params, and what the JAX
    serving engine streams over them (greedy; the JAX engine's
    constructor needs the `param_read_bytes` shim on this jax)."""
    jcfg = JT.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                n_layers=2, max_seq=128)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    je = JaxEngine(jcfg, JO.Adam(1e-2), mesh, seed=3, attn="ring")
    tok = np.random.default_rng(0).integers(0, 256, (2, 128)).astype(
        np.int32)
    je.train_batch(tok, np.roll(tok, -1, axis=1))
    JC.save(tmp_path, je, 0)
    reqs = tmp_path / "r.jsonl"
    reqs.write_text("\n".join(json.dumps(r) for r in [
        {"id": "a", "prompt_len": 40, "max_new": 8},
        {"id": "b", "prompt": [5, 6, 7, 8], "max_new": 12}]) + "\n")
    assert tserve.main(["--device", "cpu", "--ckpt",
                        str(tmp_path / "ckpt_0"), "--max-seq", "128",
                        "--requests", str(reqs)]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    got = {r["id"]: r["tokens"] for r in out if r["event"] == "result"}
    cfg = T.TransformerConfig(vocab=256, d_model=64, n_heads=4, n_layers=2,
                              max_seq=128)
    eng = ServingEngine(params_from_numpy(jax.device_get(je.params), "cpu"),
                        cfg, n_blocks=128, block_size=16, max_slots=4,
                        prefill_chunk=64, device="cpu")
    for q in tserve.load_requests(str(reqs), 256):
        eng.submit(q["prompt"], q["max_new"], rid=q["id"])
    assert got == {k: v.tolist() for k, v in eng.run().items()}
    from shallowspeed_tpu.serving import engine as JE

    monkeypatch.setattr(JE, "param_read_bytes", lambda params, cfg: 0)
    jeng = JE.ServingEngine(je.params, jcfg, n_blocks=128, block_size=16,
                            max_slots=4, prefill_chunk=64)
    for q in tserve.load_requests(str(reqs), 256):
        jeng.submit(q["prompt"], q["max_new"], rid=q["id"])
    assert got == {k: v.tolist() for k, v in jeng.run().items()}
    other = T.init(cfg, seed=0, device="cpu")
    assert not torch.equal(other["tok_emb"], params_from_numpy(
        jax.device_get(je.params), "cpu")["tok_emb"])
