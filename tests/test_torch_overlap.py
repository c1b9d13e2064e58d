"""The port's comm overlap (`shallowspeed_tpu_torch/parallel/overlap.py`)
against the JAX package's (`shallowspeed_tpu/parallel/overlap.py`,
imported through the `ref_overlap` fixture's stub walker): the bucket
plans as pure functions and against the reference's on the same shapes,
each engine's `_bucket_sigs` against the reference engine's, the
`BucketReducer` on its own, and every refusal against the reference's
type and message (the GSPMD engines, FSDP with Adafactor, the drivers'
combinations, the instruction VM)."""

import re
import signal
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import MODEL, jax_mesh, ref_overlap  # noqa: F401

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch import train as mlp_driver
from shallowspeed_tpu_torch import train_lm as lm_driver
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.parallel.mesh import (make_context_mesh,
                                                  make_fsdp_mesh, make_grid,
                                                  make_mesh)
from shallowspeed_tpu_torch.weights import leaves

ROOT = Path(__file__).resolve().parents[1]
SIZES = [784, 128, 127, 126, 125, 124, 123, 10]


def _shapes(seed, n=12):
    rng = np.random.default_rng(seed)
    return [np.zeros(tuple(rng.integers(1, 300, rng.integers(0, 3))),
                     rng.choice([np.float32, np.float16, np.int8]))
            for _ in range(n)]


# -------------------------------------------------------- bucket plans


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("target", [1, 500, 8 << 10, 1 << 30])
def test_plan_partitions_in_order_within_the_target(seed, target):
    """Every leaf in exactly one bucket, the buckets contiguous in the
    order given, each at most the target unless it is one leaf."""
    xs = _shapes(seed)
    plan = OV.plan_buckets(xs, target)
    assert [i for b in plan for i in b] == list(range(len(xs)))
    for b in plan:
        assert len(b) == 1 or sum(OV.leaf_bytes(xs[i]) for i in b) <= target


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("target", [1, 500, 8 << 10, 1 << 30])
def test_plan_equals_the_reference(ref_overlap, seed, target):
    """`plan_buckets` and `leaf_bytes` equal the reference's on the same
    shapes (tensors here, numpy arrays there)."""
    xs = _shapes(seed)
    ts = [torch.from_numpy(x) for x in xs]
    assert OV.plan_buckets(ts, target) == ref_overlap.plan_buckets(xs,
                                                                   target)
    assert [OV.leaf_bytes(t) for t in ts] == [ref_overlap.leaf_bytes(x)
                                              for x in xs]


@pytest.mark.parametrize("mb", [0.001, 0.01, 0.25, 4.0])
def test_param_plan_equals_the_reference(ref_overlap, mb):
    """A transformer tree's plan (reversed flatten order) equals the
    reference's index for index, and `leaf_plan` names the same leaves
    in this package's `leaves()` order."""
    cfg = dict(MODEL, tie_embeddings=False)
    tree = T.init(T.TransformerConfig(**cfg), seed=1, device="cpu")
    jtree = JT.init(JT.TransformerConfig(**cfg), seed=1)
    bb = OV.OverlapConfig(bucket_mb=mb).bucket_bytes
    assert bb == ref_overlap.OverlapConfig(bucket_mb=mb).bucket_bytes
    plan, flat = OV.plan_param_buckets(tree, bb)
    jplan, jflat, _ = ref_overlap.plan_param_buckets(jtree, bb)
    assert plan == jplan
    assert [tuple(x.shape) for x in flat] == [tuple(x.shape) for x in jflat]
    mine = list(leaves(tree))
    assert [[mine[i] for i in b] for b in OV.leaf_plan(tree, bb)] == \
        [[flat[j] for j in b] for b in plan]


def test_mlp_leaf_order_equals_the_reference(ref_overlap):
    """The MLP's (id, leaf) order and its plan equal the reference's."""
    from shallowspeed_tpu.models.mlp import MLPStage as JStage
    from shallowspeed_tpu_torch.models.mlp import MLPStage
    from shallowspeed_tpu_torch.weights import params_from_numpy

    host = MLPStage(SIZES, 0, 1, 32).init()
    order = OV.mlp_leaf_order(params_from_numpy(host, "cpu"))
    jorder = ref_overlap.mlp_leaf_order(JStage(SIZES, 0, 1, 32).init())
    assert [(i, tuple(x.shape)) for i, x in order] == \
        [(i, tuple(x.shape)) for i, x in jorder]
    for mb in (0.01, 0.25, 4.0):
        bb = OV.OverlapConfig(bucket_mb=mb).bucket_bytes
        raw = ref_overlap.plan_buckets([x for _, x in jorder], bb)
        assert OV.plan_ids(order, bb) == [[jorder[j][0] for j in b]
                                          for b in raw]


def test_config_and_flags(ref_overlap):
    assert OV.from_flags("off", 2.0) is None
    for mb in (0.5, 4.0, 64.0):
        ov = OV.from_flags("on", mb)
        ref = ref_overlap.from_flags("on", mb)
        assert (ov.bucket_mb, ov.bucket_bytes, ov.double_buffer_hops) == \
            (ref.bucket_mb, ref.bucket_bytes, ref.double_buffer_hops)
    assert OV.OverlapConfig(bucket_mb=0.0).bucket_bytes == 1


def test_bucket_signature_equals_the_reference(ref_overlap):
    xs = _shapes(7, 5)
    assert OV.bucket_signature([torch.from_numpy(x) for x in xs]) == \
        ref_overlap.bucket_signature(xs)


# ------------------------------------------------ engines' bucket layout


@pytest.mark.parametrize("zero2", [False, True], ids=["dense", "zero2"])
def test_context_bucket_sigs_equal_the_reference(ref_overlap, zero2):
    """The context engine's `_bucket_sigs` (per bucket; per leaf under
    ZeRO-2) equal the reference engine's at dp 2 x sp 2."""
    from shallowspeed_tpu.parallel.context import ContextParallelEngine as J
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine

    for mb in (0.01, 0.1):
        je = J(JT.TransformerConfig(**MODEL), JO.SGD(0.1),
               jax_mesh(("dp", "sp"), (2, 2)), attn="ring", zero2=zero2,
               overlap=ref_overlap.OverlapConfig(bucket_mb=mb))
        te = ContextParallelEngine(T.TransformerConfig(**MODEL), O.SGD(0.1),
                                   attn="ring",
                                   mesh=make_context_mesh(2, 2, "cpu"),
                                   zero2=zero2,
                                   overlap=OV.OverlapConfig(bucket_mb=mb))
        assert te._bucket_sigs == je._bucket_sigs
        assert len(te._bucket_sigs) > 2


def test_fsdp_bucket_sigs_equal_the_reference(ref_overlap):
    """FSDP at dp 4 (a model whose biases dp cannot all divide): the
    replicated leaves' buckets, then one per sharded leaf, as the
    reference's."""
    from shallowspeed_tpu.parallel.fsdp import FSDPEngine as J
    from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine

    kw = dict(MODEL, d_model=48, n_heads=3, n_kv_heads=0, vocab=90)
    je = J(JT.TransformerConfig(**kw), JO.Adam(1e-3),
           jax_mesh(("dp",), (4,)),
           overlap=ref_overlap.OverlapConfig(bucket_mb=0.0005))
    te = FSDPEngine(T.TransformerConfig(**kw), O.Adam(1e-3),
                    mesh=make_fsdp_mesh(4, "cpu"),
                    overlap=OV.OverlapConfig(bucket_mb=0.0005))
    assert te._bucket_sigs == je._bucket_sigs
    assert any(len(b) > 1 for b in te._plan[:3])


# the MLP's shapes at a width whose JAX arrays stay small (the suite's
# workers share one JAX process per test file they run)
SMALL_SIZES = [96, 48, 47, 46, 45, 10]


@pytest.mark.parametrize("kind", ["fused", "spmd"])
def test_mlp_bucket_sigs_equal_the_reference(ref_overlap, kind):
    from shallowspeed_tpu.engine import FusedDPEngine as JF
    from shallowspeed_tpu.models.mlp import MLPStage as JStage
    from shallowspeed_tpu.parallel.mesh import make_mesh as j_mesh
    from shallowspeed_tpu.parallel.spmd_pipeline import (
        SPMDPipelineEngine as JS)
    from shallowspeed_tpu_torch.engine import FusedDPEngine
    from shallowspeed_tpu_torch.models.mlp import MLPStage
    from shallowspeed_tpu_torch.optim import SGD
    from shallowspeed_tpu_torch.parallel.spmd_pipeline import (
        SPMDPipelineEngine)

    for mb in (0.001, 0.25):
        jov, ov = (M.OverlapConfig(bucket_mb=mb) for M in (ref_overlap, OV))
        if kind == "fused":
            je = JF(JStage(SMALL_SIZES, 0, 1, 32), JO.SGD(0.1),
                    j_mesh(2, 1), overlap=jov)
            te = FusedDPEngine(MLPStage(SMALL_SIZES, 0, 1, 32), SGD(0.1),
                               make_mesh(2, 1, "cpu"), overlap=ov)
        else:
            je = JS(SMALL_SIZES, JO.SGD(0.1), j_mesh(2, 2), 2, 8, 32,
                    overlap=jov)
            te = SPMDPipelineEngine(SMALL_SIZES, SGD(0.1),
                                    make_mesh(2, 2, "cpu"), 2, 8, 32,
                                    overlap=ov)
            assert te.schedule_info() == je.schedule_info()
        assert te._bucket_sigs == je._bucket_sigs


# ------------------------------------------------------- the reducer


def test_reducer_emits_each_bucket_once_complete():
    """`emit`: a bucket is added the moment its last leaf comes, each
    leaf once, folded into `earlier` when given."""
    done = []
    earlier = {k: torch.full((2,), float(k)) for k in range(4)}
    red = OV.BucketReducer([[3, 2], [1], [0]],
                           lambda k, g: done.append((k, g.tolist())), "cpu",
                           earlier=earlier)
    red.emit(2, torch.ones(2))
    assert done == []
    red.emit(3, torch.ones(2))
    assert done == [(3, [4.0, 4.0]), (2, [3.0, 3.0])]
    red.emit(1, torch.ones(2))
    red.emit(0, torch.ones(2))
    red.finish()
    assert [k for k, _ in done] == [3, 2, 1, 0]
    assert earlier[0].tolist() == [1.0, 1.0]


def test_reducer_refuses_a_bucket_left_open_or_issued_twice():
    red = OV.BucketReducer([[0, 1]], lambda k, g: None, "cpu")
    red.emit(0, torch.ones(1))
    with pytest.raises(RuntimeError, match="never closed"):
        red.finish()
    red = OV.BucketReducer([[0]], lambda k, g: None, "cpu")
    red.emit(0, torch.ones(1))
    with pytest.raises(RuntimeError, match="twice"):
        red.emit(0, torch.ones(1))


def test_reducer_hooks_fire_inside_the_backward():
    """Autograd leaves: a bucket's add runs from its hook before the
    backward of the earlier layers (the order the adds come in is the
    backward's), an unreached leaf adds zeros at `finish`, the hooks are
    gone and `.grad` is cleared after, also when the backward raises."""
    w1, w2, w3, unused = (torch.randn(3, requires_grad=True)
                          for _ in range(4))
    order = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            order.append("w1's layer")
            return g

    loss = (Probe.apply(w1 * 2.0) * w2).sum() + (w3 ** 2).sum()
    got = {}
    red = OV.BucketReducer([[2], [1], [0, 3]],
                           lambda k, g: (order.append(k),
                                         got.__setitem__(k, g.clone())),
                           "cpu")
    red.backward(loss, {0: w1, 1: w2, 2: w3, 3: unused})
    assert order.index(1) < order.index("w1's layer") < order.index(0)
    assert torch.equal(got[3], torch.zeros(3))
    assert torch.equal(got[2], 2 * w3.detach())
    assert all(t.grad is None for t in (w1, w2, w3, unused))
    assert not w1._backward_hooks

    class Boom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            raise ValueError("boom")

    red = OV.BucketReducer([[0], [1]], lambda k, g: None, "cpu")
    with pytest.raises(ValueError, match="boom"):
        red.backward((Boom.apply(w1) * w2).sum(), {0: w1, 1: w2})
    assert w2.grad is None and not w1._backward_hooks
    assert not w2._backward_hooks


def test_reducer_without_a_gpu_uses_no_stream():
    assert OV.side_stream("cpu") is None
    OV.join("cpu")


# ------------------------------------------------------------ refusals


def _message(fn):
    try:
        fn()
    except Exception as err:            # noqa: BLE001 — compared below
        return type(err), str(err)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("kind", ["tp", "3d", "ep"])
def test_gspmd_engines_refuse_overlap_as_the_reference(ref_overlap, kind):
    """The tensor, composite and expert engines refuse `overlap=` with the
    reference's ValueError and message."""
    from torch_parity import MOE_MODEL, _gspmd_kinds

    jcls, tcls, names = _gspmd_kinds()[kind]
    shape = {"tp": (1, 2), "3d": (1, 1, 2), "ep": (1, 2)}[kind]
    kw = MOE_MODEL if kind == "ep" else MODEL
    want = _message(lambda: jcls(JT.TransformerConfig(**kw), JO.SGD(0.1),
                                 jax_mesh(names, shape),
                                 overlap=ref_overlap.OverlapConfig()))
    got = _message(lambda: tcls(T.TransformerConfig(**kw), O.SGD(0.1),
                                mesh=make_grid(names, shape, "cpu"),
                                overlap=OV.OverlapConfig()))
    assert got == want
    if kind == "3d":        # the reference's composite takes no overlap
        assert got[0] is TypeError and "'overlap'" in got[1]
    else:
        assert got[0] is ValueError and "GSPMD-partitioned" in got[1]


def test_fsdp_refuses_adafactor_as_the_reference(ref_overlap):
    from shallowspeed_tpu.parallel.fsdp import FSDPEngine as J
    from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine

    want = _message(lambda: J(JT.TransformerConfig(**MODEL),
                              JO.Adafactor(1e-3), jax_mesh(("dp",), (2,)),
                              overlap=ref_overlap.OverlapConfig()))
    got = _message(lambda: FSDPEngine(T.TransformerConfig(**MODEL),
                                      O.Adafactor(1e-3),
                                      mesh=make_fsdp_mesh(2, "cpu"),
                                      overlap=OV.OverlapConfig()))
    assert got == want and "Adafactor" in got[1]


@pytest.fixture
def root_lm(monkeypatch, ref_overlap):  # noqa: F811
    """The root `train_lm` module, importable with the reference's
    overlap module in place (and its SIGTERM handler put back)."""
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("train_lm", None)
    import train_lm as root

    handler = signal.getsignal(signal.SIGTERM)
    try:
        yield root
    finally:
        signal.signal(signal.SIGTERM, handler)
        sys.modules.pop("train_lm", None)


@pytest.mark.parametrize("extra", [
    ["--pp", "2"], ["--tp", "2"], ["--ep", "2", "--experts", "2"],
    ["--experts", "2"], ["--fsdp", "--sp", "2", "--dp", "2"],
    ["--fsdp", "--tp", "2", "--dp", "2"]],
    ids=["pp", "tp", "ep", "experts", "fsdp-sp", "fsdp-tp"])
def test_lm_driver_refuses_as_the_root_driver(root_lm, extra):
    """`train_lm --overlap on` with the root driver's refused layouts:
    the same SystemExit and message."""
    argv = ["--seq-len", "32", "--d-model", "32", "--n-heads", "4",
            "--n-layers", "2", "--batch-size", "4", "--steps", "1",
            "--overlap", "on", "--bucket-mb", "1", *extra]
    with pytest.raises(SystemExit) as want:
        root_lm.train(root_lm.parse_args(argv))
    with pytest.raises(SystemExit) as got:
        lm_driver.main(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value)
    assert "--overlap on supports" in str(got.value)


def test_lm_driver_takes_overlap_where_the_root_does():
    """The flags parse and reach the engines everywhere else."""
    for extra in ([], ["--dp", "2", "--zero2", "--accum", "2"],
                  ["--dp", "2", "--fsdp"], ["--sp", "2"]):
        args = lm_driver.parse_args(["--device", "cpu", "--overlap", "on",
                                     "--bucket-mb", "0.5", *extra])
        assert (args.overlap, args.bucket_mb) == ("on", 0.5)
    assert not {"--overlap", "--bucket-mb"} & set(lm_driver.UNPORTED)
    assert not {"--overlap", "--bucket-mb"} & set(mlp_driver.UNPORTED)


def test_vm_refuses_overlap_as_the_root_driver(monkeypatch, ref_overlap,
                                               tmp_path):
    """`train --overlap on` on the instruction VM (pp 2 pipedream): the
    root driver's SystemExit and message."""
    from shallowspeed_tpu_torch.data.mnist import prepare_mnist

    prepare_mnist(tmp_path, synthetic=True, n_samples=256)
    monkeypatch.syspath_prepend(str(ROOT))
    sys.modules.pop("train", None)
    try:
        import train as root

        argv = ["--pp", "2", "--schedule", "pipedream", "--overlap", "on",
                "--data-dir", str(tmp_path)]
        with pytest.raises(SystemExit) as want:
            root.build(root.parse_args(argv))
    finally:
        sys.modules.pop("train", None)
    with pytest.raises(SystemExit) as got:
        mlp_driver.build(mlp_driver.parse_args(["--device", "cpu", *argv]),
                         torch.device("cpu"))
    assert str(got.value) == str(want.value)
    assert re.search("needs a compiled engine", str(got.value))
