"""The port's data layer (`shallowspeed_tpu_torch.data`: tokenizer,
token shards, prefetch, and the `build_token_shards` CLI) against the
JAX package's on the same inputs. Everything here is exact: the
modules are copies, so merges, ids, files and batches must be equal,
byte for byte."""

import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from shallowspeed_tpu.data import token_shards as JS
from shallowspeed_tpu.data import tokenizer as JTok
from shallowspeed_tpu_torch import build_token_shards as tbuild
from shallowspeed_tpu_torch.data import (ByteBPE, DevicePrefetcher,
                                         TokenShards, ValSplit, build_shards,
                                         place_on, prefetch_to_device,
                                         sync_every, train_bpe)

ROOT = Path(__file__).resolve().parent.parent
TEXT = (ROOT / "SURVEY.md").read_bytes()[:20_000]


def _files(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


# ----------------------------------------------------------- tokenizer


@pytest.fixture(scope="module")
def bpe_pair():
    return train_bpe(TEXT, 600), JTok.train_bpe(TEXT, 600)


def test_train_bpe_merges_match_jax(bpe_pair):
    got, ref = bpe_pair
    assert got.vocab_size == ref.vocab_size == 600
    assert got.merges == ref.merges


@pytest.mark.parametrize("text", [TEXT[:5_000], "def main():\n  x = 1 ✓",
                                  b"\x00\xff raw bytes \xfe"])
def test_encode_decode_match_jax(bpe_pair, text):
    got, ref = bpe_pair
    ids = got.encode(text)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, ref.encode(text))
    raw = text.encode() if isinstance(text, str) else text
    assert got.decode_bytes(ids) == ref.decode_bytes(ids) == raw
    assert got.decode(ids) == ref.decode(ids)


def test_tokenizer_json_crosses_both_ways(bpe_pair, tmp_path):
    got, ref = bpe_pair
    got.save(tmp_path / "port.json")
    ref.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert JTok.ByteBPE.load(tmp_path / "port.json").merges == ref.merges
    assert ByteBPE.load(tmp_path / "jax.json").merges == got.merges


# --------------------------------------------------------- token shards


@pytest.mark.parametrize("vocab,kw", [
    (256, dict(shard_tokens=1_000)),
    (300, dict(shard_tokens=1_500, val_fraction=0.1, meta={"src": "x"})),
    (70_000, dict(shard_tokens=4_096, val_fraction=0.25)),
    (512, dict(val=np.arange(400) % 512)),
], ids=["bytes", "val-fraction", "uint32", "explicit-val"])
def test_build_shards_is_byte_identical(tmp_path, vocab, kw):
    toks = np.random.default_rng(1).integers(0, vocab, 5_000)
    build_shards(toks, tmp_path / "port", vocab, **kw)
    JS.build_shards(toks, tmp_path / "jax", vocab, **kw)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.fixture
def shard_dirs(tmp_path):
    """One corpus built twice (7 windows of 33 tokens in the first
    shard, 6 in the second), with a val split."""
    toks = np.random.default_rng(2).integers(0, 1_000, 500)
    build_shards(toks, tmp_path / "port", 1_000, shard_tokens=240,
                 val_fraction=0.1)
    JS.build_shards(toks, tmp_path / "jax", 1_000, shard_tokens=240,
                    val_fraction=0.1)
    return TokenShards(tmp_path / "port", 32), JS.TokenShards(
        tmp_path / "jax", 32)


@pytest.mark.parametrize("order", ["perm", "random"])
def test_batches_match_jax_across_an_epoch(shard_dirs, order):
    """Steps 0-9 of 3 rows walk the 13 windows three times over, so the
    perm order crosses two epoch boundaries (each a fresh permutation)."""
    got, ref = shard_dirs
    assert got.n_windows == ref.n_windows == 13
    for seed in (0, 5):
        for step in range(10):
            for g, r in zip(got.batch(step, 3, seed, order),
                            ref.batch(step, 3, seed, order)):
                assert g.dtype == np.int32
                np.testing.assert_array_equal(g, r)


def test_perm_order_covers_each_window_once_an_epoch(shard_dirs):
    got, _ = shard_dirs
    n = got.n_windows
    rows = np.concatenate([got.batch(s, 1, 3)[0] for s in range(2 * n)])
    for epoch in (0, 1):
        seen = {tuple(r) for r in rows[epoch * n:(epoch + 1) * n]}
        assert len(seen) == n


def test_val_split_matches_jax(shard_dirs):
    got, ref = shard_dirs
    assert got.has_val and got.val_tokens == ref.val_tokens == 50
    for step in (0, 7, 10**9 + 3):
        for g, r in zip(ValSplit(got).batch(step, 2, 4),
                        JS.ValSplit(ref).batch(step, 2, 4)):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("tokenizer", ["bytes", "bpe"])
def test_build_token_shards_matches_the_root_script(tmp_path, tokenizer):
    """The port's CLI and `scripts/build_token_shards.py`, same flags,
    write the same directory and print the same summary line (the
    output path aside)."""
    text = tmp_path / "corpus.txt"
    text.write_bytes(TEXT)
    flags = ["--text", str(text), "--tokenizer", tokenizer,
             "--vocab-size", "400", "--val-fraction", "0.1",
             "--shard-mb", "1"]
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts/build_token_shards.py"),
         *flags, "--out", str(tmp_path / "jax")],
        capture_output=True, text=True, check=True, cwd=ROOT)
    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        assert tbuild.main([*flags, "--out", str(tmp_path / "port")]) == 0
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert buf.getvalue().replace("port", "X") == \
        ref.stdout.replace("jax", "X")


# ------------------------------------------------------------- prefetch


def _batches(n):
    for s in range(n):
        tok = np.random.default_rng([0, s]).integers(0, 32, (2, 8))
        yield tok.astype(np.int32), np.roll(tok, -1, 1).astype(np.int32)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order_and_places(depth):
    got = list(prefetch_to_device(_batches(7), place_on("cpu"), depth))
    assert len(got) == 7
    for (tok, tgt), (rt, rg) in zip(got, _batches(7)):
        assert tok.dtype == torch.int64 and tok.device.type == "cpu"
        np.testing.assert_array_equal(tok.numpy(), rt)
        np.testing.assert_array_equal(tgt.numpy(), rg)


def test_prefetch_raises_the_producers_error():
    def bad():
        yield from _batches(2)
        raise ValueError("broken shard")

    it = DevicePrefetcher(bad(), place_on("cpu"), depth=2)
    assert len([next(it), next(it)]) == 2
    with pytest.raises(ValueError, match="broken shard"):
        next(it)
    with pytest.raises(StopIteration):      # stays terminated
        next(it)


def test_prefetch_close_releases_a_blocked_producer():
    release = threading.Event()

    def endless():
        while True:
            yield from _batches(1)
            release.set()

    pf = DevicePrefetcher(endless(), place_on("cpu"), depth=1)
    assert release.wait(5)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._q.empty()
    with pytest.raises(StopIteration):
        next(pf)


def test_sync_every_marks_log_points_and_the_last_step():
    assert [s for s in range(10) if sync_every(s, 4, 10)] == [0, 4, 8, 9]
