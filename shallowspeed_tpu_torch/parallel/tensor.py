"""Tensor parallelism — Megatron placement over a (dp, tp) grid;
counterpart of `shallowspeed_tpu/parallel/tensor.py`.

`param_specs` is the reference's placement, leaf for leaf: `qkv` (or
`q` / `kv` under GQA, whole head groups per shard), `up` and `gate`
column-parallel, their biases too; `proj` and `down` row-parallel, their
biases replicated and added once after the sum; the head column-
parallel over the vocabulary unless `tie_embeddings`; embeddings and
norms replicated.

Where the reference lets GSPMD insert the collectives, the block here is
written in PyTorch's idiom with Megatron's two conjugate operators as
autograd functions (one process drives the tp cells, each sum in rank
order — autograd's own accumulation into a tensor that several cells
read has no fixed order):

- `copy_to_cells` (Megatron's f): the replicated activation forwarded
  to every tp cell, identity in the forward; the backward sums the
  cells' gradients in rank order.
- `reduce_from_cells` (g): the row-parallel partial outputs summed in
  rank order onto the home cell; the backward hands each cell the
  gradient as it is.

`tp_block` is `models.transformer._block` on shard parameters (its
norm, RoPE, SwiGLU / GELU and dense pieces), and `vocab_parallel_loss`
the cross-entropy over a vocabulary-sharded head: the global max and
the sum of exponentials over the tp shards in rank order, the target
logit from the shard that owns it, label smoothing as a sum over the
whole vocabulary, the soft cap elementwise before the max, rows chunked
as `chunked_token_loss` chunks them. Replicated leaves then get one
gradient per replica, reduced over dp only (`parallel.gspmd`).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops.dropout import dropout as _dropout
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine, P
from shallowspeed_tpu_torch.telemetry import collectives as C
from shallowspeed_tpu_torch.weights import leaves


def param_specs(cfg: T.TransformerConfig) -> dict:
    """The spec tree matching `transformer.init`'s structure."""
    col = {"W": P(None, "tp"), "b": P("tp")}
    row = {"W": P("tp", None), "b": P()}
    ln = {"g": P(), "b": P()}
    # GQA splits the attention projection: q and kv both column-sharded
    # (whole head groups per shard; needs kv_heads % tp == 0 too)
    attn_proj = {"q": col, "kv": col} if cfg.gqa else {"qkv": col}
    block = {"ln1": ln, **attn_proj, "proj": row,
             "ln2": ln, "up": col, "down": row}
    if cfg.ffn == "swiglu" and cfg.n_experts == 0:
        # SwiGLU's gate is column-parallel like up: the elementwise
        # silu(gate) * up then stays local to each tp shard
        block = {**block, "gate": col}
    out = {
        "tok_emb": P(),
        "pos_emb": P(),
        "blocks": [block for _ in range(cfg.n_layers)],
        "ln_f": ln,
    }
    if not cfg.tie_embeddings:
        out["head"] = col
    return out


class _Copy(torch.autograd.Function):
    """Megatron's f."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.home = x.device
        return tuple(x.view_as(x) if d == x.device else x.to(d)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        C.count_tensors("tp", grads[0])    # the all-reduce's operand
        acc = None
        for g in grads:
            g = g.to(ctx.home)
            acc = g if acc is None else acc + g
        return acc, None


class _Reduce(torch.autograd.Function):
    """Megatron's g."""

    @staticmethod
    def forward(ctx, home, *parts):
        ctx.devices = [p.device for p in parts]
        C.count_tensors("tp", parts[0])    # the all-reduce's operand
        acc = parts[0].to(home) + parts[1].to(home)
        for p in parts[2:]:
            acc = acc + p.to(home)
        return acc

    @staticmethod
    def backward(ctx, g):
        return (None, *(g.to(d) for d in ctx.devices))


def copy_to_cells(x, devices) -> tuple:
    """The replicated activation `x` on each tp cell's device (f)."""
    return _Copy.apply(x, list(devices))


def reduce_from_cells(parts, home):
    """The tp cells' partial outputs summed in rank order on `home` (g)."""
    return _Reduce.apply(home, *parts)


def shard_config(cfg: T.TransformerConfig, tp: int) -> T.TransformerConfig:
    """The config one tp cell's attention runs: H / tp heads and Hkv / tp
    kv heads of the same head_dim."""
    return dataclasses.replace(
        cfg, d_model=cfg.d_model // tp, n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.kv_heads // tp if cfg.gqa else 0)


def tp_block(ps, x, cfg: T.TransformerConfig, pos, attn_fns, key=None):
    """One pre-norm block over the tp cells: `ps` each cell's parameter
    tree (the replicated leaves read from cell 0's), `attn_fns` each
    cell's attention substrate, `x` the replicated residual stream on
    the home cell. `transformer._block`'s arithmetic and dropout sites;
    attention-probability dropout draws shard t's masks from the
    probability key folded with t. Returns (x, (0.0, 0.0, None))."""
    tp = len(ps)
    devs = [p["proj"]["W"].device for p in ps]
    scfg = shard_config(cfg, tp)
    k_attn = k_ffn = k_prob = None
    if key is not None:
        k_attn, k_ffn, k_prob = (fold_key(key, site) for site in range(3))
    b, t, d = x.shape
    hs = copy_to_cells(T._norm(ps[0]["ln1"], x, cfg), devs)
    parts = []
    for s, (p, h, fn) in enumerate(zip(ps, hs, attn_fns)):
        q, k, v = T._qkv(p, h, scfg)
        if cfg.rope:
            q = T.rope_rotate(q, pos, cfg.rope_theta)
            k = T.rope_rotate(k, pos, cfg.rope_theta)
        extra = {}
        if cfg.attn_dropout > 0.0:
            base = fn
            while isinstance(base, partial):
                base = base.func
            if not getattr(base, "supports_prob_dropout", False):
                raise ValueError(
                    "cfg.attn_dropout needs the plain attention substrate "
                    "(the fused flash kernels cannot mask probabilities "
                    "inside their score blocks)")
            extra = {"dropout": cfg.attn_dropout,
                     "dropout_key": fold_key(k_prob, s)}
        a = fn(q, k, v, **extra)
        parts.append(a.reshape(b, t, d // tp) @ p["proj"]["W"])
    y = reduce_from_cells(parts, x.device) + ps[0]["proj"]["b"]
    x = x + _dropout(y, cfg.dropout, k_attn)
    hs = copy_to_cells(T._norm(ps[0]["ln2"], x, cfg), devs)
    parts = []
    for p, h in zip(ps, hs):
        if "gate" in p:
            u = F.silu(T._dense(p["gate"], h)) * T._dense(p["up"], h)
        else:
            u = F.gelu(T._dense(p["up"], h), approximate="tanh")
        parts.append(u @ p["down"]["W"])
    y = reduce_from_cells(parts, x.device) + ps[0]["down"]["b"]
    return x + _dropout(y, cfg.dropout, k_ffn), (0.0, 0.0, None)


def _vp_nll(heads, xc, tc, cfg: T.TransformerConfig, ls: float):
    """Summed nll of one chunk of rows over the vocabulary-sharded head
    (`transformer._chunk_nll`'s arithmetic): each shard's logits on its
    cell, the max and the sum of exponentials over the shards in rank
    order, the target logit from its owner."""
    devs = [next(iter(leaves(hp))).device for hp in heads]
    home = xc.device
    logits = [T.head_logits(hp, x, cfg).float()
              for hp, x in zip(heads, copy_to_cells(xc, devs))]
    m = logits[0].detach().amax(-1)
    C.count_tensors("tp", m)        # the max's all-reduce operand
    m = m.to(home)
    for lg in logits[1:]:
        m = torch.maximum(m, lg.detach().amax(-1).to(home))
    se = tgt = total = None
    off = 0
    for lg in logits:
        v = lg.shape[-1]
        idx = tc.to(lg.device) - off
        own = (idx >= 0) & (idx < v)
        picked = torch.gather(lg, -1, idx.clamp(0, v - 1)[:, None])[:, 0]
        e = torch.exp(lg - m.to(lg.device)[:, None]).sum(-1)
        pt = torch.where(own, picked, 0.0)
        if off == 0:    # the sums' all-reduce operands: one shard's
            e, pt = C.tap(e, "tp"), C.tap(pt, "tp")
        e, pt = e.to(home), pt.to(home)
        se = e if se is None else se + e
        tgt = pt if tgt is None else tgt + pt
        if ls > 0.0:
            s = lg.sum(-1)
            s = (C.tap(s, "tp") if off == 0 else s).to(home)
            total = s if total is None else total + s
        off += v
    lse = m + torch.log(se)
    nll = lse - tgt
    if ls > 0.0:
        nll = (1.0 - ls) * nll + ls * (lse - total / off)
    return nll.sum()


def vocab_parallel_loss(heads, x, targets, cfg: T.TransformerConfig,
                        train: bool = True):
    """Mean token cross-entropy of the final-norm output `x` (B, T, d) on
    the home cell through the tp cells' head shards `heads` (each
    {"head": {"W": (d, V / tp), "b"}} in the compute dtype, vocabulary
    blocks in rank order): `transformer.token_loss(head_logits(x))` without any cell
    holding the whole vocabulary. With cfg.xent_chunk the rows go in
    chunks of that many, each recomputed in the backward, as
    `chunked_token_loss` runs them."""
    b, t, d = x.shape
    total = b * t
    ls = cfg.label_smoothing if train else 0.0
    xf, tf = x.reshape(total, d), targets.reshape(total).long()
    if cfg.xent_chunk <= 0:
        return _vp_nll(heads, xf, tf, cfg, ls) / total
    n = min(cfg.xent_chunk, total)
    grad = torch.is_grad_enabled()
    tot = None
    for xc, tc in zip(xf.split(n), tf.split(n)):
        part = (checkpoint(_vp_nll, heads, xc, tc, cfg, ls,
                           use_reentrant=False, preserve_rng_state=False)
                if grad else _vp_nll(heads, xc, tc, cfg, ls))
        tot = part if tot is None else tot + part
    return tot / total


class TensorParallelEngine(GSPMDEngine):
    """Data x tensor parallel trainer for the transformer LM family over a
    ("dp", "tp") grid (`parallel.mesh.make_tp_mesh`)."""

    default_axes = ("dp", "tp")

    def validate(self, cfg: T.TransformerConfig, mesh) -> None:
        if mesh.axis_names != ("dp", "tp"):
            raise ValueError(f"TensorParallelEngine expects a ('dp', 'tp') "
                             f"grid, got {mesh.axis_names}")
        self.tp = mesh.shape["tp"]
        check_tp(cfg, self.tp)
        if cfg.n_experts != 0:
            raise ValueError("TensorParallelEngine shards the dense FFN; use "
                             "ExpertParallelEngine for MoE configs")

    def param_specs(self, cfg: T.TransformerConfig) -> dict:
        return param_specs(cfg)


def check_tp(cfg: T.TransformerConfig, tp: int) -> None:
    """The reference's divisibility checks of a tp degree, its
    messages."""
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} must be divisible by "
                         f"tp={tp}")
    if cfg.kv_heads % tp:
        raise ValueError(f"n_kv_heads={cfg.kv_heads} must be divisible by "
                         f"tp={tp}")
    if cfg.ffn_dim % tp or cfg.vocab % tp:
        raise ValueError(f"d_ff={cfg.ffn_dim} and vocab={cfg.vocab} must be "
                         f"divisible by tp={tp}")
