"""The port's MLP engines against the JAX package's, on the CPU, at the
sizes of `tests/test_integration.py` ([784, 32, ..., 10], global batch
64, 4 microbatches, SGD lr 0.5, 1,024 synthetic samples, 3 batches):

- each port engine against the JAX engine of the same layout: fused
  dp 1 and dp 2, the VM at pp 4 with each schedule and at dp 2 x pp 2,
  the SPMD engine at pp 2 and dp 2 x pp 2 — the canonical parameters
  within the JAX package's cross-engine bound (rtol 2e-4, atol 2e-6,
  `tests/test_integration.py:81-85`), and the replicas bit-identical;
- `infer` / `infer_batch` outputs against the JAX engines' (rtol 2e-4,
  atol 1e-6, the JAX package's inference bound);
- every layout the chip check runs against the port's serial fused run
  (the same bound);
- the epoch paths against the per-batch paths, the SPMD padding staying
  zero, the deadlock check, and the refusals of what is not ported.
"""

import numpy as np
import pytest
import torch

from shallowspeed_tpu import utils as JU
from shallowspeed_tpu.data.dataset import Dataset as JDataset
from shallowspeed_tpu.engine import FusedDPEngine as JFused
from shallowspeed_tpu.models.mlp import MLPStage as JStage
from shallowspeed_tpu.optim import SGD as JSGD
from shallowspeed_tpu.parallel import schedules as JS
from shallowspeed_tpu.parallel.mesh import make_mesh as j_mesh
from shallowspeed_tpu.parallel.spmd_pipeline import (
    SPMDPipelineEngine as JSpmd)
from shallowspeed_tpu.parallel.worker import PipelineExecutor as JVM
from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch.data.dataset import Dataset
from shallowspeed_tpu_torch.data.mnist import prepare_mnist
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.models.mlp import MLPStage, stage_layer_sizes
from shallowspeed_tpu_torch.optim import SGD
from shallowspeed_tpu_torch.parallel import schedules as S
from shallowspeed_tpu_torch.parallel.instructions import (RecvActivations,
                                                          ZeroGrad)
from shallowspeed_tpu_torch.parallel.mesh import make_mesh
from shallowspeed_tpu_torch.parallel.spmd_pipeline import SPMDPipelineEngine
from shallowspeed_tpu_torch.parallel.worker import PipelineExecutor
from shallowspeed_tpu_torch.utils import (assert_replicas_in_sync,
                                          get_model_hash)

SIZES = [784, 32, 31, 30, 29, 28, 27, 10]
GBS = 64
N_MU = 4
LR = 0.5
TOL = dict(rtol=2e-4, atol=2e-6)
INFER_TOL = dict(rtol=2e-4, atol=1e-6)

# (engine, dp, pp, schedule) of each layout compared with the JAX engine
LAYOUTS = {
    "fused_dp1": ("fused", 1, 1, None),
    "fused_dp2": ("fused", 2, 1, None),
    "vm_pp4_naive": ("vm", 1, 4, "NaiveParallelSchedule"),
    "vm_pp4_gpipe": ("vm", 1, 4, "GPipeSchedule"),
    "vm_pp4_pipedream": ("vm", 1, 4, "PipeDreamSchedule"),
    "vm_dp2_pp2": ("vm", 2, 2, "GPipeSchedule"),
    "spmd_pp2": ("spmd", 1, 2, None),
    "spmd_dp2_pp2": ("spmd", 2, 2, None),
}
# the layouts `chip_smoke.py` holds against the serial run on the card
CHIP_LAYOUTS = {
    "fused_dp2": ("fused", 2, 1, None),
    "vm_pp1_naive": ("vm", 1, 1, "NaiveParallelSchedule"),
    "vm_dp4_gpipe": ("vm", 4, 1, "GPipeSchedule"),
    "vm_pp4_naive": ("vm", 1, 4, "NaiveParallelSchedule"),
    "vm_pp4_gpipe": ("vm", 1, 4, "GPipeSchedule"),
    "vm_pp4_pipedream": ("vm", 1, 4, "PipeDreamSchedule"),
    "vm_dp2_pp2": ("vm", 2, 2, "GPipeSchedule"),
    "vm_dp2_pp4_pipedream": ("vm", 2, 4, "PipeDreamSchedule"),
    "spmd_pp2": ("spmd", 1, 2, None),
    "spmd_dp2_pp4": ("spmd", 2, 4, None),
}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist_engines")
    prepare_mnist(d, synthetic=True, n_samples=1024)
    return d


def datasets(data_dir, dp, port=True, val=False, n_mu=N_MU):
    cls = Dataset if port else JDataset
    local = GBS // dp
    mubs = local if val else local // n_mu
    return [cls(data_dir, GBS, mubs, validation=val).load(r, dp)
            for r in range(dp)]


def build(layout, port=True, opt=None):
    kind, dp, pp, _ = layout
    if port:
        mesh, opt = make_mesh(dp, pp, "cpu"), opt or SGD(LR)
        fused, vm, spmd, stage = (FusedDPEngine, PipelineExecutor,
                                  SPMDPipelineEngine, MLPStage)
    else:
        mesh, opt = j_mesh(dp, pp), opt or JSGD(LR)
        fused, vm, spmd, stage = JFused, JVM, JSpmd, JStage
    if kind == "fused":
        return fused(stage(SIZES, 0, 1, batch_size=GBS), opt, mesh)
    if kind == "spmd":
        return spmd(SIZES, opt, mesh, N_MU, GBS // dp // N_MU, GBS)
    return vm(mesh, [stage(SIZES, s, pp, batch_size=GBS) for s in range(pp)],
              opt)


def train(data_dir, layout, port=True, n_batches=3, opt=None):
    eng = build(layout, port, opt)
    ds = datasets(data_dir, layout[1], port)
    sched = layout[3]
    for b in range(n_batches):
        if layout[0] == "vm":
            eng.train_batch(getattr(S if port else JS, sched), N_MU, b, ds)
        else:
            eng.train_batch(b, ds)
    return eng


def canonical(eng) -> list:
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
            for layer in eng.get_canonical_params()
            for x in (layer["W"], layer["b"])]


def assert_close(a, b, tol=TOL):
    la, lb = canonical(a), canonical(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, **tol)


@pytest.fixture(scope="module")
def serial(data_dir):
    """The port's serial fused run (dp 1, 3 batches)."""
    return train(data_dir, LAYOUTS["fused_dp1"])


# ------------------------------------------------------- against the JAX


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_engine_matches_jax_engine(data_dir, name):
    ours = train(data_dir, LAYOUTS[name])
    ref = train(data_dir, LAYOUTS[name], port=False)
    assert_close(ours, ref)
    assert_replicas_in_sync(ours.replicas())
    if LAYOUTS[name][1] > 1:
        JU.assert_replicas_in_sync(ref.params)


@pytest.mark.parametrize("name", ["fused_dp1", "fused_dp2", "spmd_pp2",
                                  "spmd_dp2_pp2"])
def test_infer_matches_jax(data_dir, name):
    """`infer` on a validation batch, split over the replicas."""
    ours = train(data_dir, LAYOUTS[name], n_batches=2)
    ref = train(data_dir, LAYOUTS[name], port=False, n_batches=2)
    dp = LAYOUTS[name][1]
    x = np.concatenate([ds.load_micro_batch_input(0, 0)
                        for ds in datasets(data_dir, dp, val=True)])
    got = ours.infer(x)
    assert got.shape == (GBS, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.infer(x)),
                               **INFER_TOL)


@pytest.mark.parametrize("name,n_mu", [("vm_pp4_gpipe", 1),
                                       ("vm_dp2_pp2", 1),
                                       ("vm_dp2_pp2", 4)])
def test_infer_batch_matches_jax(data_dir, name, n_mu):
    """The VM's forward-only streaming: every microbatch's outputs, in
    microbatch order and each microbatch's replicas in rank order."""
    ours = train(data_dir, LAYOUTS[name], n_batches=2)
    ref = train(data_dir, LAYOUTS[name], port=False, n_batches=2)
    dp, val = LAYOUTS[name][1], n_mu == 1
    got = ours.infer_batch(S.InferenceSchedule, n_mu, 0,
                           datasets(data_dir, dp, val=val, n_mu=n_mu))
    want = ref.infer_batch(JS.InferenceSchedule, n_mu, 0,
                           datasets(data_dir, dp, port=False, val=val,
                                    n_mu=n_mu))
    assert got.shape == (GBS, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **INFER_TOL)


# ------------------------------------------ against the port's serial run


@pytest.mark.parametrize("name", sorted(CHIP_LAYOUTS))
def test_layout_matches_serial(data_dir, serial, name):
    eng = train(data_dir, CHIP_LAYOUTS[name])
    assert_close(eng, serial)
    reps = eng.replicas()
    assert len(reps) == CHIP_LAYOUTS[name][1]
    assert_replicas_in_sync(reps)


def test_vm_serial_schedules_are_bit_identical(data_dir, serial):
    """At dp 1 the VM's microbatch sums run in the fused engine's
    order under naive and PipeDream (FIFO backward), so the weights and
    hashes agree bit for bit; GPipe's reversed backward does not."""
    for sched in ("NaiveParallelSchedule", "PipeDreamSchedule"):
        eng = train(data_dir, ("vm", 1, 4, sched))
        assert get_model_hash(eng.get_canonical_params()) == \
            get_model_hash(serial.params)


def test_replica_check_catches_a_drift(data_dir):
    eng = train(data_dir, LAYOUTS["fused_dp2"], n_batches=1)
    with torch.no_grad():
        eng.replicas()[1][3]["W"][0, 0] += 1e-6
    with pytest.raises(AssertionError, match="replica 1"):
        assert_replicas_in_sync(eng.replicas())


@pytest.mark.parametrize("name", ["fused_dp2", "spmd_dp2_pp2"])
def test_epoch_path_matches_batch_path(data_dir, name):
    """`train_epoch` over the staged epoch equals `train_batch` over the
    same batches, bit for bit (the same ops on the same values)."""
    a = train(data_dir, LAYOUTS[name], n_batches=3)
    b = build(LAYOUTS[name])
    b.train_epoch(b.stage_epoch(datasets(data_dir, LAYOUTS[name][1]), 3))
    for x, y in zip(canonical(a), canonical(b)):
        np.testing.assert_array_equal(x, y)


def test_fused_run_matches_epochs(data_dir):
    a = build(LAYOUTS["fused_dp2"])
    staged = a.stage_epoch(datasets(data_dir, 2), 2)
    for _ in range(2):
        a.train_epoch(staged)
    b = build(LAYOUTS["fused_dp2"])
    b.train_run(b.stage_epoch(datasets(data_dir, 2), 2), 2)
    for x, y in zip(canonical(a), canonical(b)):
        np.testing.assert_array_equal(x, y)


def test_spmd_padding_stays_zero(data_dir):
    eng = train(data_dir, ("spmd", 2, 4, None), n_batches=4)
    st = eng.stack
    for rep in eng.replicas():
        W = rep["W"].numpy()
        for s in range(st.pp):
            local = stage_layer_sizes(SIZES, s, st.pp)
            for i in range(st.L):
                if i < len(local) - 1:
                    assert not W[s, i, local[i + 1]:, :].any()
                    assert not W[s, i, :, local[i]:].any()
                else:
                    assert not W[s, i].any()


# ------------------------------------------------------------- refusals


def test_vm_raises_on_deadlock(data_dir):
    """A stream that waits on a channel no stage feeds raises instead of
    spinning."""
    class Starved(S.GPipeSchedule):
        def steps(self):
            yield [ZeroGrad()]
            if self.stage_id == 1:
                yield [RecvActivations(buffer_id=0)]

    eng = build(("vm", 1, 2, None))
    eng.allocate_buffers(2)
    with pytest.raises(RuntimeError, match="pipeline deadlock"):
        eng.execute([Starved(N_MU, 2, s) for s in range(2)], 0,
                    datasets(data_dir, 1))


def test_unported_options_raise():
    """The SPMD engine over distinct devices waits for the multi-process
    launch (ROADMAP Queue 1 item 5b); comm overlap is ported
    (`tests/test_torch_overlap_engines.py`)."""
    with pytest.raises(NotPorted, match="several devices"):
        SPMDPipelineEngine(SIZES, SGD(LR), make_mesh(1, 2, ["cpu", "meta"]),
                           N_MU, 16, GBS)
