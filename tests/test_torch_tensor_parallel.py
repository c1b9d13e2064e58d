"""The port's `TensorParallelEngine` (Megatron over a (dp, tp) grid of
the CPU) against the JAX package's on the same host mesh, and its
pieces: `param_specs` against the reference's tree, each cell's shard
shapes, Megatron's two operators, the vocabulary-parallel loss, the
replicated leaves, checkpoints across the packages.

Tolerances (f32): the loss at init 1e-5 relative and every gradient
leaf 1e-4 relative (`torch_parity.check_loss_and_grads`); 3-step
trajectories under SGD, momentum and Adafactor (`torch_parity.
GSPMD_OPTS`: the reference's factoring, eps 1e-6) as
`tests/test_torch_context_mesh.py` (1e-4, `torch_parity.trajectory`);
the vocabulary-parallel loss 1e-6 relative of `token_loss` (one
product per logit either way; only the sums' order differs);
checkpoints bit for bit, then losses within 1e-4.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec
from torch_parity import (GSPMD_OPTS, MODEL, batch, check_loss_and_grads,
                          gspmd_engines, trajectory, worst)

from shallowspeed_tpu import checkpoint as JC
from shallowspeed_tpu.models import transformer as JT
from shallowspeed_tpu.parallel import tensor as JTP
from shallowspeed_tpu_torch import checkpoint as C
from shallowspeed_tpu_torch import optim as O
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.parallel import tensor as TP
from shallowspeed_tpu_torch.parallel.gspmd import P
from shallowspeed_tpu_torch.parallel.mesh import make_grid, make_tp_mesh
from shallowspeed_tpu_torch.weights import leaves

CONFIGS = {"gqa": MODEL,
           "mha-gelu-tied": dict(MODEL, n_kv_heads=0, ffn="gelu",
                                 norm="layernorm", rope=False,
                                 tie_embeddings=True),
           "gqa-tied": dict(MODEL, tie_embeddings=True)}
LAYOUTS = [(1, 2), (2, 2), (1, 4)]


def spec_entries(spec, ndim):
    entries = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return entries


def flat_specs(tree, shapes):
    out = {}

    def walk(node, shp, path):
        if isinstance(node, dict):
            for k in node:
                walk(node[k], shp[k], f"{path}/{k}")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, shp[i], f"{path}/{i}")
        else:
            out[path] = spec_entries(node, len(shp.shape))

    walk(tree, shapes, "")
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_specs_equal_the_reference(name):
    """Leaf for leaf, the reference's PartitionSpec tree."""
    kw = CONFIGS[name]
    shapes = T.param_shapes(T.TransformerConfig(**kw))
    got = flat_specs(TP.param_specs(T.TransformerConfig(**kw)), shapes)
    ref = JTP.param_specs(JT.TransformerConfig(**kw))
    ref = jax.tree_util.tree_map(lambda s: s, ref,
                                 is_leaf=lambda x: isinstance(
                                     x, PartitionSpec))
    want = flat_specs(ref, shapes)
    assert got == want
    assert ("head" in T.param_shapes(T.TransformerConfig(**kw))) == \
        (not kw.get("tie_embeddings", False))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"dp{x[0]}tp{x[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(name, layout):
    kw = dict(CONFIGS[name])
    if kw.get("n_kv_heads", 0) % layout[1]:
        kw["n_kv_heads"] = layout[1]      # whole kv heads per tp cell
    je, te = gspmd_engines("tp", layout, GSPMD_OPTS["momentum"][0], kw=kw)
    check_loss_and_grads(je, te)


# momentum and Adafactor at every layout, SGD (its schedule) at one
TRAJECTORIES = [(layout, opt) for layout in LAYOUTS
                for opt in ("momentum", "adafactor")] + [((2, 2), "sgd")]


@pytest.mark.parametrize(
    "layout,optname", TRAJECTORIES,
    ids=[f"dp{x[0]}tp{x[1]}-{o}" for x, o in TRAJECTORIES])
def test_trajectory_matches_jax(layout, optname):
    opt, slots = GSPMD_OPTS[optname]
    je, te = gspmd_engines("tp", layout, opt,
                           kw=dict(MODEL, n_kv_heads=4 if layout[1] == 4
                                   else MODEL["n_kv_heads"]))
    trajectory(je, te, slots)


@pytest.mark.parametrize("zero", ["zero1", "zero2"])
def test_zero_on_tp_sharded_leaves_matches_jax(zero):
    """ZeRO-1/2 at dp 2 x tp 2: each tp-sharded leaf also sliced over dp
    on a dimension its spec leaves free."""
    opt, slots = GSPMD_OPTS["adafactor"]
    je, te = gspmd_engines("tp", (2, 2), opt, **{zero: True})
    qkv = te.specs["blocks"][0]["q"]["W"]
    assert te._uspecs[te._pspecs.index(qkv)] == P("dp", "tp")
    trajectory(je, te, slots)


def test_shard_shapes():
    """Each cell holds the reference's blocks: column shards of q/kv,
    up, gate and the head (with their biases), row shards of proj and
    down, everything else whole."""
    cfg = T.TransformerConfig(**MODEL)
    eng = TP.TensorParallelEngine(cfg, O.SGD(0.1),
                                  mesh=make_tp_mesh(2, 2, "cpu"))
    d, ff, v = cfg.d_model, cfg.ffn_dim, cfg.vocab
    kv = 2 * cfg.kv_heads * cfg.head_dim
    for c in eng.coords:
        tree = dict(zip([k for k in _paths(eng._template)],
                        eng._shards[c]))
        assert tree["/blocks/0/q/W"].shape == (d, d // 2)
        assert tree["/blocks/0/kv/W"].shape == (d, kv // 2)
        assert tree["/blocks/0/kv/b"].shape == (kv // 2,)
        assert tree["/blocks/1/proj/W"].shape == (d // 2, d)
        assert tree["/blocks/1/proj/b"].shape == (d,)
        assert tree["/blocks/0/up/W"].shape == (d, ff // 2)
        assert tree["/blocks/0/gate/W"].shape == (d, ff // 2)
        assert tree["/blocks/0/down/W"].shape == (ff // 2, d)
        assert tree["/head/W"].shape == (d, v // 2)
        assert tree["/tok_emb"].shape == (v, d)
        assert tree["/blocks/0/ln1/g"].shape == (d,)
    params, state = eng.cell_bytes()[(0, 0)]
    assert params < 4 * sum(m.numel() for m in leaves(eng._template))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix


def test_replicated_leaves_identical_across_tp_cells():
    """Norms, embeddings, row biases (and a tied head) get one gradient
    per replica, reduced over dp only: after three steps every cell's
    copy is the same bit for bit, and the gradient equals the one-device
    engine's (not tp times it)."""
    kw = CONFIGS["gqa-tied"]
    cfg = T.TransformerConfig(**kw)
    eng = TP.TensorParallelEngine(cfg, O.MomentumSGD(0.05),
                                  mesh=make_tp_mesh(2, 2, "cpu"))
    tok, tgt = batch(cfg.vocab, 3, b=4)
    _, grads = eng.loss_and_grads(tok, tgt)
    from shallowspeed_tpu_torch.parallel.context import ContextParallelEngine
    one = ContextParallelEngine(cfg, O.SGD(0.0), attn="ring", device="cpu")
    _, ref = one.loss_and_grads(tok, tgt)
    assert worst(grads, ref) <= 1e-4
    for step in range(3):
        eng.train_batch(*batch(cfg.vocab, 4 + step, b=4))
    rep = [i for i, s in enumerate(eng._pspecs) if not s.axes()]
    assert len(rep) > 10
    for i in rep:
        first = eng._shards[eng.coords[0]][i]
        for c in eng.coords[1:]:
            assert torch.equal(eng._shards[c][i], first)


def test_megatron_operators_sum_in_rank_order():
    """f: identity forward, the cells' gradients summed in rank order;
    g: the partials summed in rank order, the gradient handed back
    as it is."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g, requires_grad=True)
    outs = TP.copy_to_cells(x, [torch.device("cpu")] * 3)
    assert all(torch.equal(o, x) for o in outs)
    ws = [torch.randn(3, 5, generator=g) for _ in range(3)]
    (gx,) = torch.autograd.grad(sum((o * w).sum() for o, w in
                                    zip(outs, ws)), [x])
    assert torch.equal(gx, ws[0] + ws[1] + ws[2])
    parts = [torch.randn(3, 5, generator=g, requires_grad=True)
             for _ in range(3)]
    y = TP.reduce_from_cells(parts, torch.device("cpu"))
    assert torch.equal(y, parts[0] + parts[1] + parts[2])
    w = torch.randn(3, 5, generator=g)
    grads = torch.autograd.grad((y * w).sum(), parts)
    assert all(torch.equal(gp, w) for gp in grads)


@pytest.mark.parametrize("case", ["plain", "smooth-softcap", "chunked",
                                  "chunked-smooth"])
def test_vocab_parallel_loss_equals_token_loss(case):
    """The loss over a vocabulary-sharded head equals `token_loss` /
    `chunked_token_loss` of the whole head, and so do its gradients."""
    extra = {"plain": {}, "smooth-softcap": dict(label_smoothing=0.1,
                                                 logit_softcap=3.0),
             "chunked": dict(xent_chunk=24),
             "chunked-smooth": dict(xent_chunk=40, label_smoothing=0.2)}[case]
    cfg = T.TransformerConfig(**MODEL, **extra)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, cfg.d_model, generator=g, requires_grad=True)
    w = (torch.randn(cfg.d_model, cfg.vocab, generator=g) * 0.3
         ).requires_grad_(True)
    b = torch.randn(cfg.vocab, generator=g).requires_grad_(True)
    tgt = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    if cfg.xent_chunk:
        ref = T.chunked_token_loss({"head": {"W": w, "b": b}}, x, tgt, cfg)
    else:
        ref = T.token_loss(T.head_logits({"head": {"W": w, "b": b}}, x, cfg),
                           tgt, cfg)
    heads = [{"head": {"W": wc, "b": bc}} for wc, bc in
             zip(w.chunk(4, dim=1), b.chunk(4))]
    got = TP.vocab_parallel_loss(heads, x, tgt, cfg)
    assert abs(got.item() - ref.item()) <= 1e-6 * abs(ref.item())
    gr = torch.autograd.grad(ref, [x, w, b])
    gg = torch.autograd.grad(got, [x, w, b])
    for a, r in zip(gg, gr):
        assert float((a - r).abs().max() / r.abs().max()) <= 1e-5


def test_eval_loss_logits_and_health_match_jax():
    """eval_loss, logits (the vocabulary blocks concatenated) and the
    health pack (monitor) at dp 2 x tp 2."""
    from test_torch_health import _pack_close

    opt = GSPMD_OPTS["momentum"][0]
    je, te = gspmd_engines("tp", (2, 2), opt, health="monitor")
    for step in range(2):
        tok, tgt = batch(te.cfg.vocab, 30 + step, b=4)
        je.train_batch(tok, tgt)
        te.train_batch(tok, tgt)
    _pack_close(te.health_snapshot(), je.health_snapshot())
    tok, tgt = batch(te.cfg.vocab, 40, b=4)
    assert te.eval_loss(tok, tgt) == pytest.approx(je.eval_loss(tok, tgt),
                                                   rel=1e-5)
    jl = np.asarray(je.logits(tok))
    tl = te.logits(tok).numpy()
    assert tl.shape == jl.shape
    assert float(np.abs(tl - jl).max() / np.abs(jl).max()) <= 1e-5


@pytest.mark.parametrize("case", ["heads", "kv-heads", "moe", "axes",
                                  "overlap", "fp8"])
def test_refusals(case):
    """The reference engine's checks, with its messages; comm overlap is
    refused as the reference refuses it (a GSPMD program's collectives
    are compiler-inserted)."""
    kw, mesh, extra, err = dict(MODEL), make_tp_mesh(1, 2, "cpu"), {}, \
        ValueError
    if case == "heads":
        kw.update(n_heads=4, n_kv_heads=0)
        mesh = make_tp_mesh(1, 8, "cpu")
    elif case == "kv-heads":
        mesh = make_tp_mesh(1, 4, "cpu")
        kw.update(n_kv_heads=1)
    elif case == "moe":
        kw.update(n_experts=4)
    elif case == "axes":
        mesh = make_grid(("dp", "sp"), (1, 2), "cpu")
    elif case == "overlap":
        extra, err = {"overlap": object()}, ValueError
    else:
        kw.update(fp8_dense=True)
    with pytest.raises(err):
        TP.TensorParallelEngine(T.TransformerConfig(**kw), O.SGD(0.1),
                                mesh=mesh, **extra)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """A JAX TensorParallelEngine (dp 2 x tp 2, AdamW) checkpoint
    restores into the port's engine at the same layout bit for bit with
    no re-initialization; both continue within 1e-4."""
    def opt(M):
        return M.AdamW(1e-3, weight_decay=0.01)

    je, _ = gspmd_engines("tp", (2, 2), opt, seed=5)
    _, te = gspmd_engines("tp", (2, 2), opt, seed=9)
    for s in range(2):
        je.train_batch(*batch(te.cfg.vocab, 50 + s, b=4))
    JC.save(tmp_path, je, 1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert C.restore(te, tmp_path / "ckpt_1") == 2
    assert not [w for w in seen if "re-initializ" in str(w.message)]
    jstate = jax.device_get(je.opt_state)
    assert worst(te.params, jax.device_get(je.params)) == 0.0
    assert worst({k: te.opt_state[k] for k in "mv"},
                 {k: jstate[k] for k in "mv"}) == 0.0
    assert te.opt_state["t"] == 2
    for s in (2, 3):
        tok, tgt = batch(te.cfg.vocab, 50 + s, b=4)
        jl, tl = je.train_batch(tok, tgt), te.train_batch(tok, tgt)
        assert abs(tl - jl) / abs(jl) <= 1e-4
