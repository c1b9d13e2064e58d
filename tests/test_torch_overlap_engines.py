"""The overlapped engines of the port (`parallel.overlap.BucketReducer`
inside the context, FSDP, fused-DP and SPMD-pipeline engines) on the
CPU, where the bucket hooks add in hook order:

- overlap on equals overlap off bit for bit (`torch.equal` on the loss,
  the parameters and the optimizer state over 3 steps): the context
  engine dense, ZeRO-1 and ZeRO-2 at accum 1 and 2 and at dp 2 x sp 2
  ring and ring-flash; FSDP at dp 4 (with remat too); fused dp 2 (4
  microbatches and 1); SPMD dp 2 x pp 2 in both hop modes;
- against the JAX package's overlapped engines (its walker stubbed,
  `torch_parity.ref_overlap`) within TRAJECTORY_TOL: fused, SPMD in
  both hop modes, FSDP;
- the health pack and a guard skip under overlap equal overlap off's;
  a save under overlap on restores into overlap off and continues bit
  for bit; the hooks add buckets while the backward runs."""

import json

import jax
import numpy as np
import pytest
import torch
from torch_parity import (MODEL, TRAJECTORY_TOL, batch, jax_mesh,
                          ref_overlap, worst)  # noqa: F401

from shallowspeed_tpu import optim as JO
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.engine import FusedDPEngine
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.mlp import MLPStage
from shallowspeed_tpu_torch.parallel import overlap as OV
from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
from shallowspeed_tpu_torch.parallel.fsdp import FSDPEngine
from shallowspeed_tpu_torch.parallel.mesh import (make_context_mesh,
                                                  make_fsdp_mesh, make_mesh)
from shallowspeed_tpu_torch.parallel.spmd_pipeline import SPMDPipelineEngine
from shallowspeed_tpu_torch.weights import leaves

SIZES = [784, 64, 63, 62, 61, 10]
MLP_SPMD = [12, 14, 13, 10]
ADAMW = (lambda M: M.AdamW(1e-2, weight_decay=0.01, grad_clip=1.0))
SMALL = 0.01        # MiB: several buckets at the test widths


def _tensors(tree):
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


def assert_bitwise(a, b):
    """Two engines' parameters and optimizer states equal bit for bit."""
    assert _tensors(a.params)
    for get in (lambda e: e.params, lambda e: e.opt_state):
        xs, ys = _tensors(get(a)), _tensors(get(b))
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)


def lm_steps(engines, steps=3, b=4):
    for step in range(steps):
        tok, tgt = batch(engines[0].cfg.vocab, 20 + step, b=b)
        losses = [e.train_batch(tok, tgt) for e in engines]
        assert len(set(losses)) == 1, (step, losses)


def context_pair(dp, sp, attn, opt=ADAMW, **kw):
    return [ContextParallelEngine(T.TransformerConfig(**MODEL), opt(O),
                                  seed=5, attn=attn,
                                  mesh=make_context_mesh(dp, sp, "cpu"),
                                  overlap=ov, **kw)
            for ov in (None, OV.OverlapConfig(bucket_mb=SMALL))]


# ------------------------------------------------- on == off, bit for bit


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("zero", ["dense", "zero1", "zero2"])
def test_context_overlap_equals_off(zero, accum):
    kw = {} if zero == "dense" else {zero: True}
    pair = context_pair(2, 1, "flash", accum=accum, **kw)
    lm_steps(pair)
    assert_bitwise(*pair)


@pytest.mark.parametrize("attn,zero", [("ring", "dense"),
                                       ("ring-flash", "zero2")])
def test_context_overlap_equals_off_at_dp2_sp2(attn, zero):
    kw = {} if zero == "dense" else {zero: True}
    pair = context_pair(2, 2, attn, accum=2, **kw)
    lm_steps(pair)
    assert_bitwise(*pair)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_fsdp_overlap_equals_off(remat):
    """FSDP at dp 4: the in-backward reduce-scatter and the gather one
    block ahead (not under remat, whose blocks gather inside the
    checkpoint) train as the bulk step."""
    cfg = T.TransformerConfig(**MODEL, remat=remat)
    pair = [FSDPEngine(cfg, ADAMW(O), 5, mesh=make_fsdp_mesh(4, "cpu"),
                       overlap=ov)
            for ov in (None, OV.OverlapConfig(bucket_mb=SMALL))]
    lm_steps(pair, b=8)
    assert_bitwise(*pair)


class _Shard:
    """A seeded (n_mu, mubs, d) microbatch stack per batch: the
    `Dataset.load_mubatch_stack` interface."""

    def __init__(self, seed, n_mu, mubs, d_in, d_out):
        self.seed, self.n_mu, self.mubs = seed, n_mu, mubs
        self.d_in, self.d_out = d_in, d_out

    def load_mubatch_stack(self, batch_id):
        rng = np.random.default_rng([self.seed, batch_id])
        x = rng.standard_normal((self.n_mu, self.mubs, self.d_in)
                                ).astype(np.float32)
        y = np.eye(self.d_out, dtype=np.float32)[
            rng.integers(0, self.d_out, (self.n_mu, self.mubs))]
        return x, y


def mlp_engine(kind, ov, port=True, n_mu=4, gbs=32, dp=2):
    """A fused (dp 2) or SPMD (dp 2 x pp 2) engine of either package, and
    its dp data shards."""
    sizes = SIZES if kind == "fused" else MLP_SPMD
    mubs = gbs // dp // n_mu
    shards = [_Shard(r, n_mu, mubs, sizes[0], sizes[-1]) for r in range(dp)]
    if port:
        from shallowspeed_tpu_torch.optim import SGD
        mesh = (make_mesh(dp, 1, "cpu") if kind == "fused"
                else make_mesh(dp, 2, "cpu"))
        fused, spmd, stage = FusedDPEngine, SPMDPipelineEngine, MLPStage
    else:
        from shallowspeed_tpu.engine import FusedDPEngine as fused
        from shallowspeed_tpu.models.mlp import MLPStage as stage
        from shallowspeed_tpu.optim import SGD
        from shallowspeed_tpu.parallel.mesh import make_mesh as j_mesh
        from shallowspeed_tpu.parallel.spmd_pipeline import (
            SPMDPipelineEngine as spmd)
        mesh = j_mesh(dp, 1) if kind == "fused" else j_mesh(dp, 2)
    if kind == "fused":
        eng = fused(stage(sizes, 0, 1, batch_size=gbs), SGD(0.1), mesh,
                    overlap=ov)
    else:
        eng = spmd(sizes, SGD(0.1), mesh, n_mu, mubs, gbs, overlap=ov)
    return eng, shards


MLP_CASES = {"fused": ("fused", 4, None), "fused-1mu": ("fused", 1, None),
             "spmd": ("spmd", 2, False), "spmd-db": ("spmd", 2, True)}


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_mlp_overlap_equals_off(case):
    kind, n_mu, db = MLP_CASES[case]
    ov = OV.OverlapConfig(bucket_mb=0.001 if kind == "spmd" else 0.01,
                          double_buffer_hops=bool(db))
    (off, shards), (on, _) = (mlp_engine(kind, o, n_mu=n_mu)
                              for o in (None, ov))
    for b in range(3):
        off.train_batch(b, shards)
        on.train_batch(b, shards)
    assert_bitwise(off, on)
    if kind == "spmd":
        x = np.random.default_rng(0).standard_normal((8, 12)).astype(
            np.float32)
        assert torch.equal(off.infer(x), on.infer(x))
        assert on.ticks == 2 + (2 if db else 1)     # n_mu + k (pp - 1)
        assert on.schedule_info()["hop_double_buffer"] is bool(db)


# ------------------------------------------ against the JAX engines


@pytest.mark.parametrize("case", ["fused", "spmd", "spmd-db"])
def test_mlp_overlap_matches_the_jax_engine(ref_overlap, case):
    """The port's overlapped fused / SPMD engine against the JAX
    package's overlapped engine after 3 batches, within TRAJECTORY_TOL
    of each parameter leaf's largest element."""
    kind, n_mu, db = MLP_CASES[case]
    kw = dict(bucket_mb=0.001 if kind == "spmd" else 0.01,
              double_buffer_hops=bool(db))
    te, shards = mlp_engine(kind, OV.OverlapConfig(**kw), n_mu=n_mu)
    je, _ = mlp_engine(kind, ref_overlap.OverlapConfig(**kw), port=False,
                       n_mu=n_mu)
    for b in range(3):
        te.train_batch(b, shards)
        je.train_batch(b, shards)
    assert worst(te.params, jax.device_get(je.params)) <= TRAJECTORY_TOL
    if kind == "spmd":
        assert te.schedule_info() == je.schedule_info()


def test_fsdp_overlap_matches_the_jax_engine(ref_overlap):
    """The port's overlapped FSDP engine at dp 4 against the JAX
    package's overlapped shard_map step (Adam, no dropout), 3 steps:
    losses and parameters within TRAJECTORY_TOL."""
    from shallowspeed_tpu.parallel.fsdp import FSDPEngine as J

    def opt(M):
        return M.Adam(1e-3)

    je = J(JT.TransformerConfig(**MODEL), opt(JO), jax_mesh(("dp",), (4,)),
           seed=5, overlap=ref_overlap.OverlapConfig(bucket_mb=SMALL))
    te = FSDPEngine(T.TransformerConfig(**MODEL), opt(O), 5,
                    mesh=make_fsdp_mesh(4, "cpu"),
                    overlap=OV.OverlapConfig(bucket_mb=SMALL))
    for step in range(3):
        tok, tgt = batch(MODEL["vocab"], 20 + step, b=8)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= TRAJECTORY_TOL, (step, tl, jl)
    assert worst(te.params, jax.device_get(je.params),
                 absolute=True) <= TRAJECTORY_TOL


# ------------------------------------- health, guard, checkpoints, hooks


@pytest.mark.parametrize("zero", ["dense", "zero2"])
def test_health_pack_under_overlap_equals_off(zero):
    kw = {} if zero == "dense" else {"zero2": True}
    pair = context_pair(2, 2, "ring", accum=2, health="monitor", **kw)
    lm_steps(pair, steps=2)
    a, b = (e.health_snapshot() for e in pair)
    assert a == b and a["nonfinite"] == 0


def test_guard_skip_under_overlap_equals_off():
    """One NaN in replica 1's first leaf, through the bulk partial (off)
    and through the bucket hook's add (on): both skip the step bit for
    bit, and the next clean step matches."""
    off, on = context_pair(2, 1, "flash", accum=2, health="guard")
    lm_steps([off, on], steps=1)
    orig_grads, orig_adder = off._replica_grads, on._adder

    def poisoned_grads(r, tok, tgt):
        loss, part = orig_grads(r, tok, tgt)
        if r == 1:
            part[0].view(-1)[0] = float("nan")
        return loss, part

    def poisoned_adder(acc):
        add = orig_adder(acc)

        def poisoned(i, g):
            if i == 0:
                g = g.clone()
                g.view(-1)[0] = float("nan")
            add(i, g)
        return poisoned

    off._replica_grads, on._adder = poisoned_grads, poisoned_adder
    before = [x.clone() for x in _tensors(on.params)]
    lm_steps([off, on], steps=1)
    assert all(torch.equal(x, y) for x, y in zip(before,
                                                 _tensors(on.params)))
    # NaN-aware: the poisoned pack's norms are NaN in both
    assert json.dumps(off.health_snapshot(), sort_keys=True) == \
        json.dumps(on.health_snapshot(), sort_keys=True)
    assert on.health_snapshot()["skipped_total"] == 1
    off._replica_grads, on._adder = orig_grads, orig_adder
    lm_steps([off, on], steps=1)
    assert_bitwise(off, on)


def test_save_under_overlap_resumes_without_it(tmp_path):
    """A checkpoint saved by the overlapped ZeRO-2 engine restores into
    an engine with overlap off, which continues bit for bit as the
    overlapped engine does."""
    on, _ = context_pair(2, 2, "ring", zero2=True, accum=2)[::-1]
    lm_steps([on], steps=2)
    C.save(tmp_path, on, 1)
    off = context_pair(2, 2, "ring", zero2=True, accum=2)[0]
    assert C.restore(off, tmp_path / "ckpt_1") == 2
    assert_bitwise(on, off)
    for step in range(2):
        tok, tgt = batch(MODEL["vocab"], 40 + step, b=4)
        assert on.train_batch(tok, tgt) == off.train_batch(tok, tgt)
    assert_bitwise(on, off)


def test_buckets_are_added_while_the_backward_runs(monkeypatch):
    """The context engine's replica 1: every bucket but those of leaves
    the loss does not reach is issued from its hook during the backward
    (the rest at `finish`), in backward-finalization order: the head and
    the last block before the first block and the embeddings."""
    _, on = context_pair(2, 1, "flash")
    issued = []
    fire = OV.BucketReducer._fired

    def spy(self, bi, grads):
        issued.append(bi)
        return fire(self, bi, grads)

    monkeypatch.setattr(OV.BucketReducer, "_fired", spy)
    tok, tgt = batch(MODEL["vocab"], 3, b=4)
    on.train_batch(tok, tgt)
    assert len(issued) >= len(on._plan) - 2
    names = {id(x): n for n, x in _named(on.params)}
    flat = list(leaves(on.params))
    first = [names[id(flat[i])] for i in on._plan[issued[0]]]
    last = [names[id(flat[i])] for i in on._plan[issued[-1]]]
    assert any(n.startswith(("head", "blocks/1", "ln_f")) for n in first)
    assert any(n.startswith(("tok_emb", "blocks/0")) for n in last)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree
