"""The MLP path's building blocks in the port against the JAX package's,
on the CPU, at the sizes of `tests/test_integration.py` ([784, 32, ...,
10], global batch 64, 4 microbatches, 1,024 synthetic samples):

- the synthetic MNIST arrays and files, and every rank's `Dataset`
  batches for dp in {1, 2, 4}: equal byte for byte;
- `init_stage_params` for every (pp, stage): bit-identical;
- the functional ops and their hand-written VJPs against `jax.numpy`
  (rtol 1e-6, atol 1e-7: one f32 op each, summation order only), and
  the VJPs against `torch.autograd` of the forward (the same bound; the
  softmax's 1e-4 / 1e-6, as autograd also differentiates the max shift
  and sums in another order);
- `MLPStage.forward` / `backward` per stage against the JAX stage
  (rtol 2e-4, atol 2e-6, the JAX package's own cross-engine bound:
  784-long f32 dot products in another summation order);
- every schedule's instruction stream, class and fields, equal;
- `map_state_trees` of each optimizer: the same trees reach the
  transform and the same structure comes back.
"""

import filecmp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu import utils as JU
from shallowspeed_tpu.data import dataset as JD
from shallowspeed_tpu.data import mnist as JM
from shallowspeed_tpu.models import mlp as JMLP
from shallowspeed_tpu.ops import functional as JF
from shallowspeed_tpu.parallel import schedules as JS
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.data import dataset as D
from shallowspeed_tpu_torch.data import mnist as M
from shallowspeed_tpu_torch.models import mlp as MLP
from shallowspeed_tpu_torch.ops import functional as F
from shallowspeed_tpu_torch.parallel import schedules as S
from shallowspeed_tpu_torch.utils import get_model_hash

SIZES = [784, 32, 31, 30, 29, 28, 27, 10]
GBS = 64
N_MU = 4
N_SAMPLES = 1024
OP_TOL = dict(rtol=1e-6, atol=1e-7)
STAGE_TOL = dict(rtol=2e-4, atol=2e-6)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The same synthetic set written by each package."""
    jd = tmp_path_factory.mktemp("mnist_jax")
    td = tmp_path_factory.mktemp("mnist_torch")
    JM.prepare_mnist(jd, synthetic=True, n_samples=N_SAMPLES)
    M.prepare_mnist(td, synthetic=True, n_samples=N_SAMPLES)
    return jd, td


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), **tol)


# ------------------------------------------------------------------ data


def test_synthetic_arrays_equal():
    x, y = M.synthesize_mnist(N_SAMPLES)
    jx, jy = JM.synthesize_mnist(N_SAMPLES)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    assert x.tobytes() == jx.tobytes() and y.tobytes() == jy.tobytes()


@pytest.mark.parametrize("name", M.FILES)
def test_prepared_files_equal(dirs, name):
    jd, td = dirs
    assert filecmp.cmp(jd / name, td / name, shallow=False)


def test_never_fetches(dirs, tmp_path):
    """The OpenML-only mode raises; the default mode synthesizes (the
    same files as synthetic=True), and `ensure_mnist` reuses files that
    exist."""
    with pytest.raises(RuntimeError, match="OpenML"):
        M.prepare_mnist(tmp_path / "a", synthetic=False)
    d = M.prepare_mnist(tmp_path / "b", n_samples=N_SAMPLES)
    for name in M.FILES:
        assert filecmp.cmp(d / name, dirs[1] / name, shallow=False)
    mtime = (d / "x_train.npy").stat().st_mtime_ns
    assert M.ensure_mnist(d) == d
    assert (d / "x_train.npy").stat().st_mtime_ns == mtime


@pytest.mark.parametrize("val", [False, True], ids=["train", "val"])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_dataset_batches_equal(dirs, dp, val):
    """Every rank's shard, microbatches, batches, microbatch stacks and
    the stacked epoch, byte for byte."""
    jd, td = dirs
    local = GBS // dp
    mubs = local if val else local // N_MU
    ports = [D.Dataset(td, GBS, mubs, validation=val).load(r, dp)
             for r in range(dp)]
    refs = [JD.Dataset(jd, GBS, mubs, validation=val).load(r, dp)
            for r in range(dp)]
    for p, j in zip(ports, refs):
        assert len(p) == len(j)
        assert p.get_num_batches() == j.get_num_batches()
        assert p.get_num_mubatches() == j.get_num_mubatches()
        assert p.input_X.tobytes() == j.input_X.tobytes()
        assert p.target_Y.tobytes() == j.target_Y.tobytes()
        for b in (0, p.get_num_batches() - 1):
            for m in range(p.get_num_mubatches()):
                assert np.array_equal(p.load_micro_batch_input(b, m),
                                      j.load_micro_batch_input(b, m))
                assert np.array_equal(p.load_micro_batch_target(b, m),
                                      j.load_micro_batch_target(b, m))
            for a, c in zip(p.load_mubatch_stack(b), j.load_mubatch_stack(b)):
                assert a.shape == c.shape and np.array_equal(a, c)
    n = min(3, ports[0].get_num_batches())
    for a, c in zip(D.stack_epoch(ports, n), JD.stack_epoch(refs, n)):
        assert a.shape == c.shape and a.tobytes() == c.tobytes()


# ------------------------------------------------------------------ init


@pytest.mark.parametrize("pp", [1, 2, 4, 8])
def test_init_bit_identical(pp):
    for s in range(pp):
        got = MLP.init_stage_params(SIZES, s, pp)
        ref = JMLP.init_stage_params(SIZES, s, pp)
        assert MLP.stage_layer_sizes(SIZES, s, pp) == \
            JMLP.stage_layer_sizes(SIZES, s, pp)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g["W"].dtype == r["W"].dtype
            assert g["W"].tobytes() == r["W"].tobytes()
            assert g["b"].tobytes() == r["b"].tobytes()
    assert get_model_hash(MLP.init_stage_params(SIZES, 0, pp)) == \
        JU.get_model_hash(JMLP.init_stage_params(SIZES, 0, pp))


# ------------------------------------------------------------ functional


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def test_forward_ops_match_jax():
    x, w, b = _rand((16, 24), 0), _rand((12, 24), 1), _rand((1, 12), 2)
    _close(F.relu(_t(x)), JF.relu(jnp.asarray(x)), OP_TOL)
    _close(F.linear(_t(x), _t(w), _t(b)),
           JF.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), OP_TOL)
    logits = _rand((16, 10), 3, 3.0)
    _close(F.softmax(_t(logits)), JF.softmax(jnp.asarray(logits)), OP_TOL)
    tgt = np.eye(10, dtype=np.float32)[np.arange(16) % 10]
    _close(F.mse_loss(_t(logits), _t(tgt), 64),
           JF.mse_loss(jnp.asarray(logits), jnp.asarray(tgt), 64), OP_TOL)


def test_global_max_softmax():
    """The block's global max, not each row's: a row far below the max
    underflows toward zero (the reference's numerics)."""
    x = np.array([[0.0, 1.0], [-200.0, -199.0]], np.float32)
    got = F.softmax(_t(x)).numpy()
    ref = np.asarray(JF.softmax(jnp.asarray(x)))
    np.testing.assert_array_equal(got, ref)
    assert got[1].sum() < 1e-3


def test_vjps_match_jax_and_autograd():
    x, w, b = _rand((16, 24), 4), _rand((12, 24), 5), _rand((1, 12), 6)
    dout = _rand((16, 12), 7)
    got = F.linear_grad(_t(dout), _t(x), _t(w))
    ref = JF.linear_grad(jnp.asarray(dout), jnp.asarray(x), jnp.asarray(w))
    for g, r in zip(got, ref):
        _close(g, r, OP_TOL)
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, b))
    torch.autograd.backward(F.linear(tx, tw, tb), _t(dout))
    for g, a in zip(got, (tx, tw, tb)):
        _close(g, a.grad.numpy(), OP_TOL)

    mask = x > 0
    _close(F.relu_grad(_t(x), torch.from_numpy(mask)),
           JF.relu_grad(jnp.asarray(x), jnp.asarray(mask)), OP_TOL)
    tx = _t(x).requires_grad_(True)
    F.relu(tx).backward(_t(x))
    _close(F.relu_grad(_t(x), torch.from_numpy(mask)), tx.grad.numpy(), OP_TOL)

    logits, d = _rand((16, 10), 8, 2.0), _rand((16, 10), 9)
    got = F.softmax_grad(_t(d), _t(logits))
    _close(got, JF.softmax_grad(jnp.asarray(d), jnp.asarray(logits)), OP_TOL)
    tl = _t(logits).requires_grad_(True)
    F.softmax(tl).backward(_t(d))
    # autograd also differentiates through the max shift, whose
    # gradient sums to zero over the block
    _close(got, tl.grad.numpy(), dict(rtol=1e-4, atol=1e-6))

    tgt = np.eye(10, dtype=np.float32)[np.arange(16) % 10]
    probs = F.softmax(_t(logits)).numpy()
    got = F.mse_loss_grad(_t(probs), _t(tgt), 64)
    _close(got, JF.mse_loss_grad(jnp.asarray(probs), jnp.asarray(tgt), 64),
           OP_TOL)
    tp = _t(probs).requires_grad_(True)
    F.mse_loss(tp, _t(tgt), 64).backward()
    _close(got, tp.grad.numpy(), OP_TOL)


# ----------------------------------------------------------------- stage


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_stage_forward_backward_match_jax(pp):
    """Each stage's output, stash, dx and grads on one microbatch; the
    last stage's backward takes the target."""
    rows = GBS // N_MU
    x = _rand((rows, 784), 10)
    tgt = np.eye(10, dtype=np.float32)[np.arange(rows) % 10]
    for s in range(pp):
        st = MLP.MLPStage(SIZES, s, pp, batch_size=GBS)
        jst = JMLP.MLPStage(SIZES, s, pp, batch_size=GBS)
        assert repr(st) == repr(jst)
        host = st.init()
        params = [{k: _t(v) for k, v in layer.items()} for layer in host]
        jparams = jax.tree_util.tree_map(jnp.asarray, host)
        xin = x if s == 0 else _rand((rows, st.in_dim), 11 + s)
        out, stash = st.forward(params, _t(xin))
        jout, jstash = jst.forward(jparams, jnp.asarray(xin))
        _close(out, jout, STAGE_TOL)
        assert len(stash) == len(jstash)
        for e, je in zip(stash, jstash):
            assert sorted(e) == sorted(je)
            for k in e:
                _close(e[k].float(), np.asarray(je[k], np.float32),
                       STAGE_TOL)
        dout = tgt if st.is_last_stage else _rand(out.shape, 20 + s)
        dx, grads = st.backward(params, stash, _t(dout))
        jdx, jgrads = jst.backward(jparams, jstash, jnp.asarray(dout))
        _close(dx, jdx, STAGE_TOL)
        for g, jg in zip(grads, jgrads):
            _close(g["W"], jg["W"], STAGE_TOL)
            _close(g["b"], jg["b"], STAGE_TOL)
        if st.is_last_stage:
            _close(st.loss(params, _t(xin), _t(tgt)),
                   jst.loss(jparams, jnp.asarray(xin), jnp.asarray(tgt)),
                   STAGE_TOL)


# ------------------------------------------------------------- schedules

SCHEDULES = ["NaiveParallelSchedule", "GPipeSchedule", "InferenceSchedule",
             "PipeDreamSchedule"]


def _stream(mod, name, n_mu, pp, s):
    sched = getattr(mod, name)(n_mu, pp, s)
    return [[(type(c).__name__, vars(c)) for c in step]
            for step in sched.steps()], sched


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("n_mu", [1, 4])
@pytest.mark.parametrize("pp", [1, 2, 4])
def test_instruction_streams_equal(name, n_mu, pp):
    for s in range(pp):
        got, sched = _stream(S, name, n_mu, pp, s)
        ref, jsched = _stream(JS, name, n_mu, pp, s)
        assert got == ref
        assert sched.num_buffers == jsched.num_buffers
        if name == "PipeDreamSchedule":
            assert sched.max_stashed_mubatches() == \
                jsched.max_stashed_mubatches()


# ------------------------------------------------------------- optimizer

OPTS = {
    "sgd": lambda M: M.SGD(0.1),
    "sgd_sched": lambda M: M.SGD(M.warmup_linear(0.1, 2, 10)),
    "momentum": lambda M: M.MomentumSGD(0.1),
    "momentum_sched": lambda M: M.MomentumSGD(M.warmup_cosine(0.1, 2, 10)),
    "adam": lambda M: M.Adam(1e-2),
    "adamw": lambda M: M.AdamW(1e-2),
}


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_map_state_trees_matches_jax(opt):
    """The transform sees the same params-shaped trees in the same
    order and the result keeps the JAX package's structure."""
    host = MLP.init_stage_params(SIZES, 0, 2)
    params = [{k: _t(v) for k, v in layer.items()} for layer in host]
    jparams = jax.tree_util.tree_map(jnp.asarray, host)
    state = OPTS[opt](O).init(params)
    jstate = OPTS[opt](JO).init(jparams)
    seen, jseen = [], []

    def fn(acc):
        return lambda tree: (acc.append(len(tree)), list(reversed(tree)))[1]

    got = OPTS[opt](O).map_state_trees(state, fn(seen))
    ref = OPTS[opt](JO).map_state_trees(jstate, fn(jseen))
    assert seen == jseen
    assert jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda _: 0, got)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(lambda _: 0, ref))
