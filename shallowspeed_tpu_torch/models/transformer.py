"""Decoder-only transformer LM — counterpart of
`shallowspeed_tpu/models/transformer.py`.

Functional like the reference: `init(cfg, seed)` draws the parameter
tree with numpy (bit-identical to the JAX package's draw, so one seed
gives both packages the same weights), and the forward pieces take the
tree as an argument. Parameters keep the JAX layout — dense leaves
{"W": (K, N), "b": (N,)} applied as `x @ W + b`, blocks in a list — so
a tree crosses between the packages by copy (`weights.params_from_numpy`).

Mixed precision follows the reference: master weights in `cfg.dtype`,
`cast_params` casts every float leaf except the norm scales to
`cfg.compute_dtype` (a torch dtype, or None for no cast); norm
statistics, attention scores and softmax, and the soft-cap stay in
float32.

`forward`/`forward_with_aux`/`loss` are differentiable with torch
autograd and take the attention substrate as `attn_fn` (the plain
`attention` by default, or `ops.flash_attention.flash_attention`);
`eval_forward` is the no-grad entry the serving checks use.

Quantized weight storage for decode (`quantize_weights`, int8 or
fp8-e4m3 with per-out-channel f32 scales) turns dense leaves into
{"Wq", "Ws", "b"}; `_dense` dispatches on "Wq" to
`ops.matmul.dequant_matmul`, and `cast_params` leaves both leaves in
their storage dtypes.

Training features, as in the reference: dropout on the embedding sum
and on each attention and FFN output, and attention-probability dropout
in the plain attention, with masks from explicit keys (`ops.dropout`:
a forward given no `dropout_key` runs no RNG op); remat of every block
under the policies "full", "attn" and "dots" (`_remat_block`); chunked
cross-entropy (`chunked_token_loss`); and the MoE FFN (`ops.moe`), its
balance and z-losses added in `loss`. With cfg.fp8_dense every dense
product of a block and the untied head runs as `ops.matmul.fp8_dense`
(e4m3 operands, f32 sum, straight-through f32 gradients), the
activation scale per tensor and just in time.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import contextlib

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from shallowspeed_tpu_torch import resolve_device
from shallowspeed_tpu_torch.ops.attention import attention
from shallowspeed_tpu_torch.ops.dropout import dropout as _dropout
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.ops.matmul import (E4M3_MAX, dequant_matmul,
                                               fp8_dense)
from shallowspeed_tpu_torch.ops.moe import moe_ffn
from shallowspeed_tpu_torch.weights import leaves, params_from_numpy


@dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field (see its docstrings for
    what each one means). `compute_dtype` is a torch dtype here; `dtype`
    stays a numpy dtype because `init` draws with numpy."""
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    max_seq: int = 1024
    dtype: np.dtype = np.float32
    compute_dtype: object = None
    remat: bool = False
    remat_policy: str = "full"
    rope: bool = False
    rope_theta: float = 10000.0
    norm: str = "layernorm"
    ffn: str = "gelu"
    n_kv_heads: int = 0
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_aux_weight: float = 1e-2
    moe_routing: str = "sequence"
    moe_z_weight: float = 0.0
    tie_embeddings: bool = False
    label_smoothing: float = 0.0
    attn_window: int = 0
    logit_softcap: float = 0.0
    dropout: float = 0.0
    attn_dropout: float = 0.0
    d_ff: int = 0
    xent_chunk: int = 0
    fp8_dense: bool = False

    def __post_init__(self):
        assert self.norm in ("layernorm", "rmsnorm"), self.norm
        assert self.ffn in ("gelu", "swiglu"), self.ffn
        assert self.moe_routing in ("sequence", "priority"), \
            self.moe_routing
        assert self.remat_policy in ("full", "attn", "dots"), \
            self.remat_policy
        assert self.xent_chunk >= 0, self.xent_chunk
        assert 0.0 <= self.dropout < 1.0, self.dropout
        assert 0.0 <= self.attn_dropout < 1.0, self.attn_dropout
        assert 0.0 <= self.label_smoothing < 1.0, self.label_smoothing
        assert self.attn_window >= 0, self.attn_window
        assert self.n_kv_heads >= 0, (
            f"n_kv_heads must be non-negative, got {self.n_kv_heads}")
        assert self.n_heads % self.kv_heads == 0, (
            f"n_heads={self.n_heads} must be divisible by "
            f"n_kv_heads={self.kv_heads}")
        if (self.compute_dtype is not None
                and not isinstance(self.compute_dtype, torch.dtype)):
            raise TypeError(f"compute_dtype must be a torch dtype or None, "
                            f"got {self.compute_dtype!r}")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def gqa(self) -> bool:
        return self.kv_heads != self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        """The dtype activations and KV pools run in."""
        return self.compute_dtype or getattr(torch, np.dtype(self.dtype).name)


def _param_tree(cfg: TransformerConfig, normal, const):
    """The parameter tree with its leaves from `normal(shape, std)` and
    `const(shape, value)`, called in the reference's draw order."""
    d = cfg.d_model

    def dense(in_d, out_d):
        return {"W": normal((in_d, out_d), 1.0 / np.sqrt(in_d)),
                "b": const((out_d,), 0.0)}

    def norm():
        return {"g": const((d,), 1.0), "b": const((d,), 0.0)}

    blocks = []
    for _ in range(cfg.n_layers):
        blk = {"ln1": norm(), "proj": dense(d, d), "ln2": norm()}
        if cfg.gqa:
            blk["q"] = dense(d, d)
            blk["kv"] = dense(d, 2 * cfg.kv_heads * cfg.head_dim)
        else:
            blk["qkv"] = dense(d, 3 * d)
        if cfg.ffn == "swiglu" and cfg.n_experts == 0:
            blk["gate"] = dense(d, cfg.ffn_dim)
        if cfg.n_experts > 0:
            e, ff = cfg.n_experts, cfg.ffn_dim
            blk["moe"] = {"gate": normal((d, e), 0.02),
                          "wi": normal((e, d, ff), 1.0 / np.sqrt(d)),
                          "bi": const((e, ff), 0.0),
                          "wo": normal((e, ff, d), 1.0 / np.sqrt(ff)),
                          "bo": const((e, d), 0.0)}
        else:
            blk["up"] = dense(d, cfg.ffn_dim)
            blk["down"] = dense(cfg.ffn_dim, d)
        blocks.append(blk)
    out = {
        "tok_emb": normal((cfg.vocab, d), 0.02),
        "pos_emb": normal((cfg.max_seq, d), 0.02),
        "blocks": blocks,
        "ln_f": norm(),
    }
    if not cfg.tie_embeddings:
        out["head"] = dense(d, cfg.vocab)
    return out


def init_numpy(cfg: TransformerConfig, seed: int = 0):
    """The parameter tree as numpy arrays, drawn exactly as the
    reference's `init` draws it (same generator, same order)."""
    rng = np.random.default_rng(seed)
    dt = cfg.dtype
    return _param_tree(
        cfg, lambda shape, std: rng.normal(0.0, std, shape).astype(dt),
        lambda shape, value: np.full(shape, value, dt))


def param_shapes(cfg: TransformerConfig):
    """The parameter tree's structure, with meta tensors of each leaf's
    shape and dtype in place of values: nothing drawn or allocated (a
    checkpoint's structure check against the config)."""
    dt = getattr(torch, np.dtype(cfg.dtype).name)

    def meta(shape, _):
        return torch.empty(shape, dtype=dt, device="meta")

    return _param_tree(cfg, meta, meta)


def init(cfg: TransformerConfig, seed: int = 0, device=None):
    """Seeded parameter tree as torch tensors on `device` (default
    cuda; see `resolve_device`)."""
    dev = resolve_device(device)
    return params_from_numpy(init_numpy(cfg, seed), dev)


_NORM_KEYS = {"ln1", "ln2", "ln_f"}
# Quantized weight-storage leaves (`quantize_weights`): "Wq" holds the
# int8/fp8 values, "Ws" the per-out-channel f32 scales.
_QUANT_KEYS = {"Wq", "Ws"}

WEIGHT_QUANT_MODES = ("", "int8", "fp8")
_QMAX = {"int8": 127.0, "fp8": 448.0}     # e4m3's largest normal is 448


def quantize_weights(params, mode: str):
    """Every dense {"W": (K, N), "b"} of the tree (block q/kv/qkv, proj,
    up/down/gate, the untied head) as {"Wq": (K, N) int8 or
    float8_e4m3fn, "Ws": (N,) f32, "b"}: symmetric absmax over the
    in-channel axis, scale = max(max|W|, 1e-8) / 127 (448 for fp8),
    int8 values clip(round(W / scale), -127, 127) with round half to
    even, fp8 values W / scale rounded to e4m3. Embeddings, norms and
    biases stay as they are; an already quantized dense stays as it is;
    mode "" returns the tree unchanged."""
    if mode not in WEIGHT_QUANT_MODES:
        raise ValueError(
            f"unsupported weight_quant={mode!r}; expected one of "
            f"{WEIGHT_QUANT_MODES} ('' = weights in the master dtype)")
    if not mode:
        return params

    def quant_dense(p):
        w = p["W"].float()
        ws = w.abs().amax(dim=0).clamp_min(1e-8) / _QMAX[mode]
        if mode == "int8":
            wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
        else:
            wq = (w / ws).to(torch.float8_e4m3fn)
        rest = {k: v for k, v in p.items() if k != "W"}
        return {"Wq": wq, "Ws": ws, **rest}

    def walk(node):
        if isinstance(node, dict):
            if "W" in node and node["W"].dim() == 2:
                return quant_dense(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def weight_quant_mode(params) -> str:
    """"int8" or "fp8" when the tree holds `quantize_weights` leaves,
    else ""."""
    for node in leaves(params):
        if node.dtype == torch.int8 and node.dim() == 2:
            return "int8"
        if node.dtype == torch.float8_e4m3fn:
            return "fp8"
    return ""


def cast_params(params, compute_dtype):
    """Float leaves to `compute_dtype` (None = identity). Norm leaves
    (ln1/ln2/ln_f) stay in the master dtype: every consumer upcasts
    them to f32 for the statistics anyway. Quantized-storage leaves
    (Wq/Ws) stay in their storage dtypes: float8_e4m3fn is a floating
    dtype, and a cast would turn it back into a full-size copy (and
    round the f32 scales)."""
    if compute_dtype is None:
        return params

    def walk(node, keep):
        if isinstance(node, dict):
            return {k: walk(v, keep or k in _NORM_KEYS or k in _QUANT_KEYS)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, keep) for v in node]
        if keep or not node.is_floating_point():
            return node
        return node.to(compute_dtype)

    return walk(params, False)


def _layernorm(p, x, eps=1e-5):
    """Statistics in float32; result in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["g"].float() + p["b"].float()
    return y.to(x.dtype)


def _rmsnorm(p, x, eps=1e-5):
    """Root-mean-square scaling only (p["b"] is kept but unused); f32
    statistics like `_layernorm`."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * p["g"].float()
    return y.to(x.dtype)


def _norm(p, x, cfg: TransformerConfig):
    return (_rmsnorm if cfg.norm == "rmsnorm" else _layernorm)(p, x)


def _dense(p, x, fp8: bool = False):
    if "Wq" in p:      # quantized storage: the scale meets the f32 sum
        return dequant_matmul(x, p["Wq"], p["Ws"]) + p["b"]
    if fp8:     # cfg.fp8_dense: the training-time e4m3 product, with a
        #         just-in-time per-tensor activation scale (no gradient)
        w = p["W"]
        x2 = x.reshape(-1, x.shape[-1]).float()
        with torch.no_grad():
            sx = torch.clamp(torch.amax(torch.abs(x2)) / E4M3_MAX,
                             min=1e-12)
        out = fp8_dense(x2, w.float(), sx)
        return (out.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)
                + p["b"])
    return x @ p["W"] + p["b"]


def head_logits(params, x, cfg: TransformerConfig):
    """Vocabulary projection: the untied head, or tok_emb^T when tied;
    optionally soft-capped in f32."""
    logits = (x @ params["tok_emb"].T if cfg.tie_embeddings
              else _dense(params["head"], x, cfg.fp8_dense))
    if cfg.logit_softcap > 0.0:
        cap = cfg.logit_softcap
        logits = cap * torch.tanh(logits.float() / cap)
    return logits


def rope_rotate(x, pos, theta: float = 10000.0):
    """Rotary embeddings on (B, T, H, D) at positions `pos` ((T,) or a
    scalar): half-split pairs (d, d + D/2), f32 phases, result in x's
    dtype."""
    d = x.shape[-1]
    assert d % 2 == 0, f"rope needs an even head_dim, got {d}"
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -ar / half)
    pos = torch.as_tensor(pos, device=x.device).to(torch.float32).reshape(-1)
    ang = pos[:, None] * freqs                          # (T, half)
    cos = torch.cos(ang)[None, :, None, :]              # (1, T, 1, half)
    sin = torch.sin(ang)[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv(p, h, cfg: TransformerConfig):
    """(q (B,T,H,hd), k, v (B,T,Hkv,hd)): the fused head-major qkv, or
    split q / fused kv under GQA."""
    b, t, _ = h.shape
    if "kv" in p:
        q = _dense(p["q"], h, cfg.fp8_dense).reshape(b, t, cfg.n_heads,
                                                     cfg.head_dim)
        kv = _dense(p["kv"], h, cfg.fp8_dense).reshape(b, t, cfg.kv_heads,
                                                       2, cfg.head_dim)
        k, v = kv[..., 0, :], kv[..., 1, :]
    else:
        qkv = _dense(p["qkv"], h, cfg.fp8_dense).reshape(b, t, cfg.n_heads,
                                                         3, cfg.head_dim)
        q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    return q, k, v


def _ffn(p, x, cfg: TransformerConfig, h, key=None):
    """Post-attention half of a block: GELU (tanh form, JAX's default),
    SwiGLU or the routed MoE on the norm output `h`, dropout (with a
    `key`), residual onto `x`. Returns (x, (balance aux, router z-loss,
    routing stats)), the MoE terms unweighted and (0.0, 0.0, None) for
    a dense FFN."""
    if "moe" in p:
        y, aux, z, st = moe_ffn(p["moe"], h, cfg.moe_top_k,
                                cfg.moe_capacity_factor,
                                priority=cfg.moe_routing == "priority")
        return x + _dropout(y, cfg.dropout, key), (aux, z, st)
    if "gate" in p:
        u = (F.silu(_dense(p["gate"], h, cfg.fp8_dense))
             * _dense(p["up"], h, cfg.fp8_dense))
    else:
        u = F.gelu(_dense(p["up"], h, cfg.fp8_dense), approximate="tanh")
    return (x + _dropout(_dense(p["down"], u, cfg.fp8_dense), cfg.dropout,
                         key),
            (0.0, 0.0, None))


def _attn_in(p, x, cfg: TransformerConfig, pos):
    """A block's attention inputs: (q, k, v) of the ln1 output, rotated
    at positions `pos` under RoPE."""
    h = _norm(p["ln1"], x, cfg)
    q, k, v = _qkv(p, h, cfg)
    if cfg.rope:
        q = rope_rotate(q, pos, cfg.rope_theta)
        k = rope_rotate(k, pos, cfg.rope_theta)
    return q, k, v


def _site_keys(key):
    """(attention output, FFN output, attention probabilities) dropout
    keys of a block's `key` (all None without one)."""
    if key is None:
        return None, None, None
    return tuple(fold_key(key, site) for site in range(3))


def _attn_out(p, x, a, cfg: TransformerConfig, key=None):
    """The rest of a block after its attention output `a`: the
    projection, dropout and residual, then `_ffn`. Returns (x, MoE
    terms)."""
    k_attn, k_ffn, _ = _site_keys(key)
    b, t, d = x.shape
    x = x + _dropout(_dense(p["proj"], a.reshape(b, t, d), cfg.fp8_dense),
                     cfg.dropout,
                     k_attn)
    return _ffn(p, x, cfg, _norm(p["ln2"], x, cfg), k_ffn)


def _block(p, x, cfg: TransformerConfig, pos, attn_fn, key=None,
           with_kv: bool = False):
    """One pre-norm block: (x, MoE terms as `_ffn` gives them). `key`
    (training only) seeds the block's dropout masks: site 0 the
    attention output, 1 the FFN output, 2 the attention probabilities.
    With `with_kv` also returns this block's (k, v) (B, T, Hkv, hd),
    rotated and unrepeated — what a decode prefill writes into its
    cache."""
    q, k, v = _attn_in(p, x, cfg, pos)
    extra = {}
    if cfg.attn_dropout > 0.0:
        fn = attn_fn
        while isinstance(fn, partial):
            fn = fn.func
        if not getattr(fn, "supports_prob_dropout", False):
            raise ValueError(
                "cfg.attn_dropout needs the plain attention substrate "
                "(the fused flash kernels cannot mask probabilities "
                "inside their score blocks)")
        extra = {"dropout": cfg.attn_dropout,
                 "dropout_key": _site_keys(key)[2]}
    a = attn_fn(q, k, v, **extra)
    x, moe = _attn_out(p, x, a, cfg, key)
    return (x, moe, (k, v)) if with_kv else (x, moe)


def _block_tiles(ps, xs, cfg: TransformerConfig, poss, attn_tiles,
                 keys):
    """One block on several sequence tiles of one sp group in lockstep:
    tile i runs its own parameters `ps[i]` on `xs[i]` at positions
    `poss[i]` with dropout key `keys[i]`; `attn_tiles(qs, ks, vs)` is
    the group's substrate over the tiles (`ops.attention.ring_tiles`
    and its kin). Returns (the tiles' outputs, their MoE terms)."""
    qkv = [_attn_in(p, x, cfg, pos) for p, x, pos in zip(ps, xs, poss)]
    outs = attn_tiles(*(list(t) for t in zip(*qkv)))
    done = [_attn_out(p, x, a, cfg, key)
            for p, x, a, key in zip(ps, xs, outs, keys)]
    return [x for x, _ in done], [moe for _, moe in done]


# What remat policy "dots" saves: the outputs of the 2-D dense products
# (every projection; the reference's dots_with_no_batch_dims_saveable).
# Batched products (the plain attention's, the MoE experts') recompute.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(stash, ctx, op, *args, **kwargs):
    if op in _DOTS and not stash.busy:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class _Both:
    """Two contexts entered as one; re-enterable, as a recompute context
    must be (a second backward recomputes again)."""

    def __init__(self, *cms):
        self.cms = cms
        self._stacks: list = []

    def __enter__(self):
        stack = contextlib.ExitStack()
        for cm in self.cms:
            stack.enter_context(cm)
        self._stacks.append(stack)

    def __exit__(self, *exc):
        return self._stacks.pop().__exit__(*exc)


def _remat_contexts(policy: str):
    """(forward, recompute) contexts of one rematerialized block: "attn"
    keeps each flash call's (o, lse) through the recompute
    (`ops.flash_attention.AttnStash`); "dots" also keeps every dense
    product's output (a selective-checkpoint policy over torch's
    ops)."""
    stash = FA.AttnStash()
    if policy == "attn":
        return stash.recording(), stash.replaying()
    fwd, rec = create_selective_checkpoint_contexts(
        partial(_dots_policy, stash))
    return _Both(fwd, stash.recording()), _Both(rec, stash.replaying())


def _remat_block(cfg: TransformerConfig, fn=None):
    """`_block` (or another block function of its signature, `fn`: the
    parallel engines' blocks) rematerialized (torch.utils.checkpoint,
    non-reentrant) under cfg.remat_policy: "full" saves nothing (the
    backward reruns the whole block, K1 included); "attn" saves the
    attention output and its lse, so the backward never relaunches K1;
    "dots" saves those and every dense product's output, so the backward
    recomputes only the elementwise work (norms, rope, silu / gelu,
    dropout masks, which come from keys, not from a stream)."""
    ctx = (None if cfg.remat_policy == "full"
           else partial(_remat_contexts, cfg.remat_policy))
    fn = _block if fn is None else fn

    def block(p, x, cfg, pos, attn_fn, key):
        kw = {} if ctx is None else {"context_fn": ctx}
        return checkpoint(fn, p, x, cfg, pos, attn_fn, key,
                          use_reentrant=False, preserve_rng_state=False,
                          **kw)

    return block


def token_loss(logits, targets, cfg: TransformerConfig, train: bool = True):
    """Mean token cross-entropy in float32, with label smoothing in
    training only (eval passes train=False: plain NLL)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    ls = cfg.label_smoothing
    if train and ls > 0.0:
        nll = (1.0 - ls) * nll + ls * (-logp.mean(dim=-1))
    return nll.mean()


def _chunk_nll(hp, xc, tc, cfg: TransformerConfig, ls: float):
    """Summed nll of one chunk of positions: lse minus the target logit
    in f32 (with smoothing: -mean logp = lse - mean(logits))."""
    logits = head_logits(hp, xc, cfg).float()                 # (n, V)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - torch.gather(logits, -1, tc[:, None])[:, 0]
    if ls > 0.0:
        nll = (1.0 - ls) * nll + ls * (lse - logits.mean(dim=-1))
    return nll.sum()


def chunked_token_loss(params, x, targets, cfg: TransformerConfig,
                       train: bool = True):
    """`token_loss(head_logits(x))` without ever holding the (B*T,
    vocab) logits: positions go in chunks of cfg.xent_chunk, each
    chunk's logits recomputed in the backward (a non-reentrant
    checkpoint per chunk), so the forward and the backward hold one
    chunk's logits at a time. The last chunk is the remainder when
    cfg.xent_chunk does not divide B*T (the reference pads it and masks
    the pad rows out: the same sum). `params` is the uncast tree (only
    the head leaves are cast here); `x` is the final-norm output (B, T,
    d)."""
    key = "tok_emb" if cfg.tie_embeddings else "head"
    hp = cast_params({key: params[key]}, cfg.compute_dtype)
    b, t, d = x.shape
    total = b * t
    n = min(cfg.xent_chunk, total)
    ls = cfg.label_smoothing if train else 0.0
    grad = torch.is_grad_enabled()
    tot = None
    for xc, tc in zip(x.reshape(total, d).split(n),
                      targets.reshape(total).long().split(n)):
        part = (checkpoint(_chunk_nll, hp, xc, tc, cfg, ls,
                           use_reentrant=False, preserve_rng_state=False)
                if grad else _chunk_nll(hp, xc, tc, cfg, ls))
        tot = part if tot is None else tot + part
    return tot / total


def forward_with_aux(params, tokens, cfg: TransformerConfig, attn_fn=None,
                     dropout_key=None, with_stats: bool = False,
                     head: bool = True):
    """tokens (B, T) int -> (logits (B, T, vocab), (balance aux, router
    z-loss) summed over the MoE layers, 0.0 for a dense config).
    Differentiable in `params`. `attn_fn(q, k, v)` defaults to the plain
    causal `attention` with the config's window. `dropout_key`
    (training only, `ops.dropout.fold_key`) switches the config's
    dropout on: the embedding sum's mask from (key, n_layers), block i's
    from (key, i). With cfg.remat every block is rematerialized
    (`_remat_block`) when grad is enabled. `head=False` returns the
    final-norm hidden states instead of logits (chunked cross-entropy
    projects them itself); `with_stats` adds a third element, the MoE
    routing stats averaged over the layers ({"load": (E,),
    "drop_fraction"}, None for a dense config)."""
    if attn_fn is None:
        attn_fn = partial(attention, causal=True, window=cfg.attn_window)
    if not head:         # not cast for nothing: chunking casts its own
        params = {k: v for k, v in params.items() if k != "head"}
    params = cast_params(params, cfg.compute_dtype)
    b, t = tokens.shape
    if t > cfg.max_seq:
        raise ValueError(f"sequence of {t} exceeds max_seq={cfg.max_seq}")
    if cfg.dropout == 0.0 and cfg.attn_dropout == 0.0:
        dropout_key = None
    pos = torch.arange(t, device=tokens.device)
    x = params["tok_emb"][tokens]
    if not cfg.rope:
        x = x + params["pos_emb"][pos]
    if dropout_key is not None:
        x = _dropout(x, cfg.dropout, fold_key(dropout_key, cfg.n_layers))
    block = (_remat_block(cfg) if cfg.remat and torch.is_grad_enabled()
             else _block)
    aux_total, z_total = 0.0, 0.0
    stats_sum, n_moe = None, 0
    for i, blk in enumerate(params["blocks"]):
        key = None if dropout_key is None else fold_key(dropout_key, i)
        x, (aux, z, st) = block(blk, x, cfg, pos, attn_fn, key)
        aux_total = aux_total + aux
        z_total = z_total + z
        if st is not None:
            stats_sum = (st if stats_sum is None else
                         {k: stats_sum[k] + st[k] for k in st})
            n_moe += 1
    x = _norm(params["ln_f"], x, cfg)
    out = head_logits(params, x, cfg) if head else x
    if with_stats:
        stats = (None if stats_sum is None else
                 {k: v / n_moe for k, v in stats_sum.items()})
        return out, (aux_total, z_total), stats
    return out, (aux_total, z_total)


def forward(params, tokens, cfg: TransformerConfig, attn_fn=None,
            dropout_key=None):
    """Logits only (see `forward_with_aux`)."""
    return forward_with_aux(params, tokens, cfg, attn_fn, dropout_key)[0]


@torch.no_grad()
def eval_forward(params, tokens, cfg: TransformerConfig):
    """No-grad forward through the plain attention: the full-sequence
    reference the paged serving path is held against."""
    return forward(params, tokens, cfg)


def loss(params, tokens, targets, cfg: TransformerConfig, attn_fn=None,
         dropout_key=None, train: bool = True):
    """Mean softmax cross-entropy over all (batch, seq) positions
    (`token_loss`, or `chunked_token_loss` with cfg.xent_chunk), plus
    moe_aux_weight x the balance loss and, when moe_z_weight > 0, the
    weighted router z-loss. `train=False` drops label smoothing."""
    if cfg.xent_chunk > 0:
        hid, (aux, z) = forward_with_aux(params, tokens, cfg, attn_fn,
                                         dropout_key, head=False)
        tl = chunked_token_loss(params, hid, targets, cfg, train)
    else:
        logits, (aux, z) = forward_with_aux(params, tokens, cfg, attn_fn,
                                            dropout_key)
        tl = token_loss(logits, targets, cfg, train)
    total = tl + cfg.moe_aux_weight * aux
    if cfg.moe_z_weight > 0.0:
        total = total + cfg.moe_z_weight * z
    return total


def tile_losses(params_list, tokens_list, targets_list,
                cfg: TransformerConfig, attn_tiles, offsets, keys=None,
                train: bool = True) -> list:
    """`loss` on each sequence tile of one sp group, each with its own
    parameter copy, run in lockstep so the group's substrate
    `attn_tiles` sees every tile's q, k and v (the reference's
    per-device `local_loss`): tile i holds tokens at global positions
    offsets[i] + [0, T_i) — its position embeddings and RoPE angles —
    takes its dropout masks from keys[i] and routes its own MoE tokens.
    Returns each tile's mean token loss plus its weighted MoE terms."""
    n = len(params_list)
    keys = [None] * n if keys is None else list(keys)
    if cfg.dropout == 0.0 and cfg.attn_dropout == 0.0:
        keys = [None] * n
    cast = [cast_params({k: v for k, v in p.items() if k != "head"}
                        if cfg.xent_chunk > 0 else p, cfg.compute_dtype)
            for p in params_list]
    poss, xs = [], []
    for p, tok, off, key in zip(cast, tokens_list, offsets, keys):
        t = tok.shape[1]
        if off + t > cfg.max_seq:
            raise ValueError(f"sequence of {off + t} exceeds "
                             f"max_seq={cfg.max_seq}")
        pos = off + torch.arange(t, device=tok.device)
        x = p["tok_emb"][tok]
        if not cfg.rope:
            x = x + p["pos_emb"][pos]
        if key is not None:
            x = _dropout(x, cfg.dropout, fold_key(key, cfg.n_layers))
        poss.append(pos)
        xs.append(x)
    block = (_remat_block(cfg, _block_tiles)
             if cfg.remat and torch.is_grad_enabled() else _block_tiles)
    aux = [0.0] * n
    z = [0.0] * n
    for i in range(cfg.n_layers):
        ks = [None if key is None else fold_key(key, i) for key in keys]
        xs, moes = block([p["blocks"][i] for p in cast], xs, cfg, poss,
                         attn_tiles, ks)
        aux = [a + m[0] for a, m in zip(aux, moes)]
        z = [b + m[1] for b, m in zip(z, moes)]
    out = []
    for p, c, x, tgt, a, b in zip(params_list, cast, xs, targets_list, aux,
                                  z):
        hf = _norm(c["ln_f"], x, cfg)
        tl = (chunked_token_loss(p, hf, tgt, cfg, train) if cfg.xent_chunk > 0
              else token_loss(head_logits(c, hf, cfg), tgt, cfg, train))
        total = tl + cfg.moe_aux_weight * a
        if cfg.moe_z_weight > 0.0:
            total = total + cfg.moe_z_weight * b
        out.append(total)
    return out


def _tile_blocks(cast, tokens_list, cfg: TransformerConfig, attn_tiles,
                 offsets) -> tuple:
    """The lockstep forward of `tile_losses` through the blocks, no
    dropout, on parameters already cast: (each tile's last block
    output, each tile's MoE routing stats averaged over the layers as
    `forward_with_aux(with_stats=True)` averages them, None for a dense
    config)."""
    poss, xs = [], []
    for p, tok, off in zip(cast, tokens_list, offsets):
        pos = off + torch.arange(tok.shape[1], device=tok.device)
        x = p["tok_emb"][tok]
        xs.append(x if cfg.rope else x + p["pos_emb"][pos])
        poss.append(pos)
    sums, n_moe = [None] * len(xs), 0
    for i in range(cfg.n_layers):
        xs, moes = _block_tiles([p["blocks"][i] for p in cast], xs, cfg, poss,
                                attn_tiles, [None] * len(xs))
        if moes[0][2] is not None:
            n_moe += 1
            sums = [st if acc is None else {k: acc[k] + st[k] for k in st}
                    for acc, (_, _, st) in zip(sums, moes)]
    return xs, [None if acc is None else
                {k: v / n_moe for k, v in acc.items()} for acc in sums]


def tile_logits(params_list, tokens_list, cfg: TransformerConfig, attn_tiles,
                offsets) -> list:
    """Each tile's logits (B, T_i, vocab) through the lockstep forward of
    `tile_losses`, no dropout."""
    cast = [cast_params(p, cfg.compute_dtype) for p in params_list]
    xs, _ = _tile_blocks(cast, tokens_list, cfg, attn_tiles, offsets)
    return [head_logits(p, _norm(p["ln_f"], x, cfg), cfg)
            for p, x in zip(cast, xs)]


def tile_router_stats(params_list, tokens_list, cfg: TransformerConfig,
                      attn_tiles, offsets) -> list:
    """Each tile's MoE routing stats ({"load": (E,), "drop_fraction"},
    averaged over the layers; None for a dense config) through the
    lockstep forward of `tile_losses`, no dropout: each tile routes its
    own tokens."""
    cast = [cast_params({k: v for k, v in p.items() if k != "head"},
                        cfg.compute_dtype) for p in params_list]
    return _tile_blocks(cast, tokens_list, cfg, attn_tiles, offsets)[1]
