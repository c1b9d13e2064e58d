"""The port's checkpoints (`shallowspeed_tpu_torch.checkpoint`) against
the JAX package's, on the CPU: the same files cross both ways, params
and optimizer state restore bit for bit, and training continues on the
same trajectory (f32 losses within 1e-4 relative, the bound of
`tests/test_torch_train.py`; the two engines sum in another order).
Then the integrity machinery: manifest, verify, quarantine, latest,
restore_latest, legacy checkpoints, pruning, config mismatches, no
pickle, stored members, and `AsyncSaver`."""

import json
import warnings
import zipfile

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel.context import (
    ContextParallelEngine as JaxEngine)
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

KW = dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
          max_seq=16, rope=True, norm="rmsnorm", ffn="swiglu")
OPTS = {"adamw": lambda M: M.AdamW(1e-2, weight_decay=0.01, grad_clip=1.0),
        "sgd": lambda M: M.SGD(0.1)}


def _batch(step):
    rng = np.random.default_rng([3, step])
    tok = rng.integers(0, KW["vocab"], (2, KW["max_seq"])).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1).astype(np.int32)


def _jax_engine(opt, seed=5):
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    return JaxEngine(JT.TransformerConfig(**KW), OPTS[opt](JO), mesh,
                     seed=seed, attn="ring")


def _port_engine(opt, seed=5, **kw):
    return ContextParallelEngine(T.TransformerConfig(**kw or KW),
                                 OPTS[opt](O), seed=seed, attn="ring",
                                 device="cpu")


def _flat(tree):
    """(structure spec, numpy leaves) of either package's tree, in the
    checkpoint's traversal order."""
    out = []
    spec = C._encode(tree, out)
    return spec, out


def _assert_same(a, b):
    sa, la = _flat(a)
    sb, lb = _flat(b)
    assert sa == sb
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _kinds(tree):
    if isinstance(tree, dict):
        return {k: _kinds(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, [_kinds(v) for v in tree])
    return None if tree is None else type(tree).__name__


# ------------------------------------------------- crossing the packages


TREE = {"a": [np.arange(3.0, dtype=np.float32), None,
              (np.int32(7), np.zeros((2, 0), np.float32))],
        "t": np.asarray(4, np.int32), "empty": (), "nested": {"x": []}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pytree_kinds_cross_both_ways(tmp_path, writer):
    """dict, list, tuple, None, an empty tuple and int32 scalars: each
    package reads what the other wrote with the kinds, dtypes and values
    kept."""
    save, load = ((C.save_pytree, JC.load_pytree) if writer == "port"
                  else (JC.save_pytree, C.load_pytree))
    save(tmp_path / "t.npz", TREE, meta={"k": 1})
    got, meta = load(tmp_path / "t.npz", with_meta=True)
    assert meta == {"k": 1}
    assert _kinds(got) == {"a": ("list", ["ndarray", None, (
        "tuple", ["ndarray", "ndarray"])]), "t": "ndarray",
        "empty": ("tuple", []), "nested": {"x": ("list", [])}}
    assert got["t"].dtype == np.int32 and got["t"].shape == ()
    assert got["a"][2][0].dtype == np.int32
    _assert_same(got, TREE)


def test_port_npz_members_are_stored_and_hold_no_pickle(tmp_path):
    eng = _port_engine("adamw")
    eng.train_batch(*_batch(0))
    C.save(tmp_path, eng, 0)
    for f in ("params.npz", "opt.npz"):
        with zipfile.ZipFile(tmp_path / "ckpt_0" / f) as z:
            assert {i.compress_type for i in z.infolist()} == {
                zipfile.ZIP_STORED}
        with np.load(tmp_path / "ckpt_0" / f, allow_pickle=False) as z:
            assert "spec" in z.files
            for k in z.files:
                assert z[k].dtype != object


@pytest.mark.parametrize("opt", list(OPTS))
def test_jax_checkpoint_restores_into_the_port(tmp_path, opt):
    """A JAX engine trained 2 steps and saved by the JAX package
    restores into the port's engine (another seed) with params and
    optimizer state bit for bit; both then take 2 more steps on the
    same trajectory."""
    je = _jax_engine(opt)
    for s in range(2):
        je.train_batch(*_batch(s))
    JC.save(tmp_path, je, 1)
    te = _port_engine(opt, seed=9)
    assert C.restore(te, tmp_path / "ckpt_1") == 2
    assert te._step_count == 2
    _assert_same(te.get_canonical_params(), jax.device_get(je.params))
    jstate = jax.device_get(je.opt_state)
    if opt == "sgd":
        assert te.opt_state == () == jstate
    else:
        assert te.opt_state["t"] == 2 and isinstance(te.opt_state["t"], int)
        _assert_same({k: te.opt_state[k] for k in "mv"},
                     {k: jstate[k] for k in "mv"})
    for s in (2, 3):
        jl, tl = je.train_batch(*_batch(s)), te.train_batch(*_batch(s))
        assert abs(tl - jl) / abs(jl) <= 1e-4


@pytest.mark.parametrize("opt", list(OPTS))
def test_port_checkpoint_restores_into_jax(tmp_path, opt):
    """The other way: the port's checkpoint restores into the JAX
    engine (its restore compares treedefs, so SGD's state must come back
    a tuple and `t` an int32 scalar) with no re-initialization
    warning, bit for bit, and both continue together."""
    te = _port_engine(opt)
    for s in range(2):
        te.train_batch(*_batch(s))
    C.save(tmp_path, te, 1)
    je = _jax_engine(opt, seed=9)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert JC.restore(je, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    _assert_same(jax.device_get(je.params), te.get_canonical_params())
    jstate = jax.device_get(je.opt_state)
    if opt == "sgd":
        assert jstate == ()
    else:
        assert jstate["t"].dtype == np.int32 and int(jstate["t"]) == 2
        _assert_same({k: jstate[k] for k in "mv"},
                     {k: te.opt_state[k] for k in "mv"})
    for s in (2, 3):
        jl, tl = je.train_batch(*_batch(s)), te.train_batch(*_batch(s))
        assert abs(tl - jl) / abs(jl) <= 1e-4


def test_manifests_verify_across_the_packages(tmp_path):
    te = _port_engine("adamw")
    C.save(tmp_path / "p", te, 0, extra={"ema": te.get_canonical_params()})
    je = _jax_engine("adamw")
    JC.save(tmp_path / "j", je, 0)
    man = json.loads((tmp_path / "p/ckpt_0/manifest.json").read_text())
    assert sorted(man["files"]) == ["ema.npz", "opt.npz", "params.npz"]
    JC.verify(tmp_path / "p/ckpt_0")
    C.verify(tmp_path / "j/ckpt_0")
    meta = C.load_pytree(tmp_path / "p/ckpt_0/opt.npz", with_meta=True)[1]
    assert meta == {"epoch": 0, "engine": "ContextParallelEngine",
                    "optimizer": "AdamW", "opt_is_canonical": True}


# -------------------------------------------------------------- integrity


def _saved(tmp_path, epochs=(0,), **kw):
    eng = _port_engine("adamw")
    for e in epochs:
        C.save(tmp_path, eng, e, **kw)
    return eng


def _flip(path, offset=None):
    data = bytearray(path.read_bytes())
    i = len(data) // 2 if offset is None else offset
    data[i] ^= 0xFF
    path.write_bytes(bytes(data))


DAMAGE = {
    "bitflip": lambda d: _flip(d / "params.npz"),
    "truncate": lambda d: (d / "opt.npz").write_bytes(
        (d / "opt.npz").read_bytes()[:100]),
    "missing-file": lambda d: (d / "params.npz").unlink(),
    "bad-manifest-json": lambda d: (d / "manifest.json").write_text("{"),
    "manifest-wrong-shape": lambda d: (d / "manifest.json").write_text(
        json.dumps({"files": ["params.npz"]})),
}


@pytest.mark.parametrize("kind", list(DAMAGE))
def test_verify_catches_each_kind_of_damage(tmp_path, kind):
    _saved(tmp_path)
    d = tmp_path / "ckpt_0"
    C.verify(d)
    DAMAGE[kind](d)
    with pytest.raises(C.CheckpointError):
        C.verify(d)
    assert not C.is_verified(d)
    with pytest.raises(C.CheckpointError):
        C.restore(_port_engine("adamw"), d)


def test_quarantine_numbers_collisions(tmp_path):
    for _ in range(3):
        (tmp_path / "ckpt_4").mkdir()
        with pytest.warns(UserWarning, match="quarantined"):
            C.quarantine(tmp_path / "ckpt_4")
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_4.corrupt", "ckpt_4.corrupt2", "ckpt_4.corrupt3"]
    assert C.quarantine(tmp_path / "gone") is None


def test_latest_skips_partial_foreign_and_corrupt_entries(tmp_path):
    _saved(tmp_path, epochs=(1, 3))
    (tmp_path / "ckpt_99").mkdir()               # no files at all
    (tmp_path / "ckpt_7.tmp").mkdir()            # a crashed save
    (tmp_path / "ckpt_backup").mkdir()           # not ours
    assert C.latest(tmp_path).name == "ckpt_3"
    _flip(tmp_path / "ckpt_3" / "params.npz")
    with pytest.warns(UserWarning, match="quarantined"):
        assert C.latest(tmp_path).name == "ckpt_1"
    assert (tmp_path / "ckpt_3.corrupt").exists()
    assert C.latest(tmp_path / "nope") is None
    assert C.has_checkpoint(tmp_path) and not C.has_checkpoint(
        tmp_path / "nope")


def test_restore_latest_falls_back_through_corrupt_checkpoints(tmp_path):
    eng = _port_engine("adamw")
    for e in (0, 1, 2):
        eng.train_batch(*_batch(e))
        C.save(tmp_path, eng, e)
    for e in (1, 2):
        _flip(tmp_path / f"ckpt_{e}" / "opt.npz")
    other = _port_engine("adamw", seed=1)
    with pytest.warns(UserWarning):
        nxt, path, bad = C.restore_latest(other, tmp_path)
    assert (nxt, path.name) == (1, "ckpt_0")
    assert [p.name for p in bad] == ["ckpt_2.corrupt", "ckpt_1.corrupt"]
    _flip(tmp_path / "ckpt_0" / "params.npz")
    with pytest.warns(UserWarning):
        assert C.restore_latest(other, tmp_path)[:2] == (0, None)


def test_legacy_checkpoints_without_manifest_restore(tmp_path):
    eng = _saved(tmp_path)
    (tmp_path / "ckpt_0" / "manifest.json").unlink()
    C.verify(tmp_path / "ckpt_0")
    other = _port_engine("adamw", seed=2)
    assert C.restore_latest(other, tmp_path)[:2] == (1, tmp_path / "ckpt_0")
    _assert_same(other.params, eng.params)
    (tmp_path / "ckpt_0" / "opt.npz").unlink()   # incomplete legacy dir
    assert not C.has_checkpoint(tmp_path)
    with pytest.raises(C.CheckpointError, match="incomplete"):
        C.verify(tmp_path / "ckpt_0")


def test_prune_never_deletes_the_newest_verified_checkpoint(tmp_path):
    _saved(tmp_path, epochs=(1, 2))
    (tmp_path / "ckpt_9.tmp").mkdir()
    _flip(tmp_path / "ckpt_2" / "params.npz")
    eng = _port_engine("adamw")
    C.save(tmp_path, eng, 3)
    _flip(tmp_path / "ckpt_3" / "params.npz")
    C.prune(tmp_path, 1)           # ckpt_3 newest, but ckpt_1 verifies
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_1", "ckpt_3", "ckpt_9.tmp"]
    C.save(tmp_path, eng, 4, keep=2)     # the fresh save is trusted
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_3", "ckpt_4", "ckpt_9.tmp"]
    with pytest.raises(ValueError):
        C.prune(tmp_path, 0)


def test_config_mismatch_raises_value_error(tmp_path):
    _saved(tmp_path)
    wider = _port_engine("adamw", **{**KW, "d_model": 64})
    with pytest.raises(ValueError, match="model config"):
        C.restore(wider, tmp_path / "ckpt_0")
    deeper = _port_engine("adamw", **{**KW, "n_layers": 3})
    with pytest.raises(ValueError, match="model config"):
        C.restore_latest(deeper, tmp_path)
    assert (tmp_path / "ckpt_0").exists()     # not quarantined
    with pytest.raises(ValueError, match="model config"):
        C.load_params(tmp_path / "ckpt_0", T.param_shapes(
            T.TransformerConfig(**{**KW, "vocab": 65})))


def test_restore_keeps_the_engines_leaf_order(tmp_path):
    """A checkpoint's dicts come back key-sorted; the engine keeps its
    own order, which the optimizer's and the clipping's sums follow."""
    eng = _saved(tmp_path)
    other = _port_engine("adamw", seed=4)
    C.restore(other, tmp_path / "ckpt_0")
    assert list(other.params) == list(eng.params)
    assert list(other.params["blocks"][0]) == list(eng.params["blocks"][0])
    assert list(other.opt_state["m"]) == list(eng.opt_state["m"])


def test_bf16_tensors_are_refused(tmp_path):
    with pytest.raises(TypeError, match="float32 master"):
        C.save_pytree(tmp_path / "x.npz", {"w": torch.ones(2,
                                                           dtype=torch.bfloat16)})


def test_save_and_restore_report_their_stages(tmp_path):
    eng = _port_engine("adamw")
    stats, back = {}, {}
    C.save(tmp_path, eng, 0, stats=stats)
    assert set(stats) == {"fetch_s", "write_s", "hash_s", "rename_s",
                          "bytes"}
    assert stats["bytes"] == sum(p.stat().st_size for p in
                                 (tmp_path / "ckpt_0").glob("*.npz"))
    C.restore(_port_engine("adamw", seed=1), tmp_path / "ckpt_0", back)
    assert set(back) == {"verify_s", "load_s", "place_s", "bytes"}
    assert back["bytes"] == stats["bytes"]


# ------------------------------------------------------------ AsyncSaver


def test_async_save_snapshots_at_the_save_point(tmp_path):
    """The async save holds the state of the moment it was called, even
    though the optimizer updates the tensors in place afterwards; a save
    after training equals the synchronous one; saves land in order."""
    eng = _port_engine("adamw")
    eng.train_batch(*_batch(0))
    saver = C.AsyncSaver()
    saver.save(tmp_path / "a", eng, 1)
    eng.train_batch(*_batch(1))
    C.save(tmp_path / "b", eng, 1)
    saver.save(tmp_path / "a2", eng, 1)
    for e in (2, 3, 4):
        saver.save(tmp_path / "order", eng, e, keep=2)
    saver.close()
    at = C.load_pytree(tmp_path / "a/ckpt_1/params.npz")
    after = C.load_pytree(tmp_path / "b/ckpt_1/params.npz")
    assert any(not np.array_equal(x, y) for x, y in
               zip(_flat(at)[1], _flat(after)[1]))
    _assert_same(C.load_pytree(tmp_path / "a2/ckpt_1/params.npz"), after)
    assert sorted(p.name for p in (tmp_path / "order").iterdir()) == [
        "ckpt_3", "ckpt_4"]


def test_async_save_errors_surface_on_the_next_call(tmp_path):
    eng = _port_engine("sgd")
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = C.AsyncSaver()
    saver.save(blocker, eng, 0)          # mkdir under a file fails
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    saver.save(blocker, eng, 1)
    saver._q.join()
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.save(tmp_path / "ok", eng, 2)
    saver.save(tmp_path / "ok", eng, 2)
    saver.close()
    assert C.latest(tmp_path / "ok").name == "ckpt_2"
    assert not saver._thread.is_alive()
