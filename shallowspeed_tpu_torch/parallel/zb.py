"""Hand-split transformer-block backward for zero-bubble pipelining —
counterpart of `shallowspeed_tpu/parallel/zb.py`.

The ZB-H1 schedule (`verify.simulate_zb`, `verify.zb_tables`) needs the
backward split into two separately schedulable passes:

- **B**, the input-cotangent pass: dy -> dx from the residuals F
  stashed, with no forward recompute. While walking the chain it peels
  off each dense product's output cotangent (the "taps") and the cheap
  norm-parameter gradients.
- **W**, the weight-gradient pass: dW = x^T g and db = sum g from F's
  stashed product inputs and B's taps; no chain, no attention.

These are plain functions on tensors, not autograd graphs, so that W
runs whenever the schedule places it. The arithmetic is
`models.transformer._block`'s dense path (f32 norm statistics, the
compute dtype everywhere else). The attention core is pluggable
(`make_attn_core`): under "flash" F runs K1 (`ops.flash_attention.
flash_fwd`) and stashes (o, lse), and B runs `attention_delta`, then
K2 (`flash_dq`) and K3 (`flash_dkv`) on that stash — K1 never runs
again; under "xla" B is the plain attention's own vjp (one attention
forward recomputed inside it). The elementwise derivatives (SwiGLU,
GELU, the embedding gather) take torch's local vjp of the same op, so
B + W equals autograd through `_block`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops import flash_attention as FA
from shallowspeed_tpu_torch.ops.attention import attention

_EPS = 1e-5  # T._layernorm / T._rmsnorm's


# ------------------------------------------------------------ norm split


def norm_fwd(p, x, kind: str):
    """(y, stats): `T._norm`'s output (f32 statistics, y in x's dtype)
    and the statistics the hand backward reads."""
    xf = x.float()
    g = p["g"].float()
    if kind == "rmsnorm":
        rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + _EPS)
        return (xf * rstd * g).to(x.dtype), {"rstd": rstd}
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mu) ** 2).mean(dim=-1, keepdim=True) + _EPS)
    y = (xf - mu) * rstd * g + p["b"].float()
    return y.to(x.dtype), {"mu": mu, "rstd": rstd}


def norm_bwd(p, x, stats, dy, kind: str):
    """(dx in dy's dtype, {"g", "b"} grads): computed in B, since
    deferring them would stash the full norm cotangents."""
    xf, dyf, g = x.float(), dy.float(), p["g"].float()
    rstd = stats["rstd"]
    if kind == "rmsnorm":
        xhat = xf * rstd
        dxh = dyf * g
        dg = (dyf * xhat).sum(dim=(0, 1))
        db = torch.zeros_like(p["b"])    # rmsnorm keeps b structurally
        dxf = rstd * (dxh - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    else:
        xhat = (xf - stats["mu"]) * rstd
        dxh = dyf * g
        dg = (dyf * xhat).sum(dim=(0, 1))
        db = dyf.sum(dim=(0, 1)).to(p["b"].dtype)
        dxf = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                      - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
    return dxf.to(dy.dtype), {"g": dg.to(p["g"].dtype),
                              "b": db.to(p["b"].dtype)}


# ------------------------------------------------------- attention cores


def make_attn_core(attn: str, window: int):
    """(fwd_save, bwd) of the block's attention. fwd_save(q, k, v) -> (o,
    res); bwd(q, k, v, o, res, do) -> (dq, dk, dv) in the inputs'
    dtypes. q (B, T, H, hd); k, v (B, T, Hkv, hd)."""
    w = int(window)
    if attn == "flash":
        def fwd_save(q, k, v):
            o, lse = FA.flash_fwd(q, k, v, causal=True, window=w)
            return o, {"lse": lse}

        def bwd(q, k, v, o, res, do):
            lse = res["lse"]
            delta = FA.attention_delta(do, o)
            dq = FA.flash_dq(q, k, v, do, lse, delta, causal=True,
                             window=w)
            dk, dv = FA.flash_dkv(q, k, v, do, lse, delta, causal=True,
                                  window=w)
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

        return fwd_save, bwd

    if attn != "xla":
        raise ValueError(f"attn={attn!r}: the split backward takes 'xla' "
                         f"or 'flash'")

    def fwd_save(q, k, v):
        return attention(q, k, v, causal=True, window=w), {}

    def bwd(q, k, v, o, res, do):
        # the interior is weightless, so its whole vjp is the B pass
        # (one attention forward recomputed; flash replays its stash)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention(*ins, causal=True, window=w)
            return torch.autograd.grad(out, ins, do)

    return fwd_save, bwd


# ------------------------------------------------------ block fwd / B / W


def block_fwd(blk, x, pos, cfg: T.TransformerConfig, attn_fwd):
    """One pre-norm block, saving the split backward's residuals. Returns
    (y, resb, resw): resb is freed at B (block inputs, norm statistics,
    q/k/v, lse), resw lives to W (each product's input, the attention
    output, the FFN pre-activations B's derivatives also read)."""
    b, t, d = x.shape
    h1, n1 = norm_fwd(blk["ln1"], x, cfg.norm)
    q, k, v = T._qkv(blk, h1, cfg)
    if cfg.rope:
        q = T.rope_rotate(q, pos, cfg.rope_theta)
        k = T.rope_rotate(k, pos, cfg.rope_theta)
    o, attn_res = attn_fwd(q, k, v)
    x2 = x + T._dense(blk["proj"], o.reshape(b, t, d))
    h2, n2 = norm_fwd(blk["ln2"], x2, cfg.norm)
    if "gate" in blk:
        sg, up = T._dense(blk["gate"], h2), T._dense(blk["up"], h2)
        u = F.silu(sg) * up
        ffn_res = {"sg": sg, "up": up}
    else:
        pre = T._dense(blk["up"], h2)
        u = F.gelu(pre, approximate="tanh")
        ffn_res = {"pre": pre}
    y = x2 + T._dense(blk["down"], u)
    resb = {"x": x, "n1": n1, "q": q, "k": k, "v": v, "x2": x2, "n2": n2,
            **attn_res}
    resw = {"h1": h1, "o": o, "h2": h2, **ffn_res}
    return y, resb, resw


def _act(resw):
    """The FFN activation u from its stashed pre-activations."""
    if "sg" in resw:
        return F.silu(resw["sg"]) * resw["up"]
    return F.gelu(resw["pre"], approximate="tanh")


def _act_vjp(resw, du):
    """The FFN activation's input cotangents, by torch's vjp of the same
    elementwise op the forward ran."""
    names = ("sg", "up") if "sg" in resw else ("pre",)
    with torch.enable_grad():
        ins = [resw[n].detach().requires_grad_(True) for n in names]
        u = (F.silu(ins[0]) * ins[1] if len(ins) == 2
             else F.gelu(ins[0], approximate="tanh"))
        return dict(zip(names, torch.autograd.grad(u, ins, du)))


def block_bwd_x(blk, resb, resw, dy, pos, cfg: T.TransformerConfig,
                attn_bwd):
    """The B pass of one block: (dx, taps, {"ln1", "ln2"} grads)."""
    b, t, d = dy.shape
    hd = cfg.head_dim
    # ---- FFN side
    du = dy @ blk["down"]["W"].T
    dpre = _act_vjp(resw, du)
    if "gate" in blk:
        dsg, dup = dpre["sg"], dpre["up"]
        dh2 = dsg @ blk["gate"]["W"].T + dup @ blk["up"]["W"].T
        taps_ffn = {"dsg": dsg, "dup": dup}
    else:
        dh2 = dpre["pre"] @ blk["up"]["W"].T
        taps_ffn = {"dpre": dpre["pre"]}
    dx2_n, dn2 = norm_bwd(blk["ln2"], resb["x2"], resb["n2"], dh2, cfg.norm)
    dx2 = dy + dx2_n
    # ---- attention side
    da = dx2 @ blk["proj"]["W"].T
    do = da.reshape(b, t, cfg.n_heads, hd)
    dq, dk, dv = attn_bwd(resb["q"], resb["k"], resb["v"], resw["o"],
                          {n: resb[n] for n in ("lse",) if n in resb}, do)
    if cfg.rope:    # the rotation is orthogonal: its transpose is -pos
        dq = T.rope_rotate(dq, -pos, cfg.rope_theta)
        dk = T.rope_rotate(dk, -pos, cfg.rope_theta)
    if "kv" in blk:
        dqf = dq.reshape(b, t, d)
        dkvf = torch.stack([dk, dv], dim=3).reshape(b, t,
                                                    cfg.kv_heads * 2 * hd)
        dh1 = dqf @ blk["q"]["W"].T + dkvf @ blk["kv"]["W"].T
        taps_attn = {"dq": dqf, "dkv": dkvf}
    else:
        dqkvf = torch.stack([dq, dk, dv], dim=3).reshape(b, t, 3 * d)
        dh1 = dqkvf @ blk["qkv"]["W"].T
        taps_attn = {"dqkv": dqkvf}
    dx1, dn1 = norm_bwd(blk["ln1"], resb["x"], resb["n1"], dh1, cfg.norm)
    taps = {**taps_attn, "dproj": dx2, **taps_ffn, "ddown": dy}
    return dx2 + dx1, taps, {"ln1": dn1, "ln2": dn2}


def block_bwd_w(resw, taps):
    """The W pass of one block: its dense leaves' grads, each dW the
    outer product of the product's stashed input and its tap over the
    (B, T) rows, each db the tap's row sum."""
    def outer(x, g):
        return x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])

    def dense(x, g):
        return {"W": outer(x, g), "b": g.sum(dim=(0, 1))}

    o = resw["o"]
    out = {"proj": dense(o.reshape(o.shape[0], o.shape[1], -1),
                         taps["dproj"]),
           "down": dense(_act(resw), taps["ddown"])}
    if "dqkv" in taps:
        out["qkv"] = dense(resw["h1"], taps["dqkv"])
    else:
        out["q"] = dense(resw["h1"], taps["dq"])
        out["kv"] = dense(resw["h1"], taps["dkv"])
    if "dsg" in taps:
        out["gate"] = dense(resw["h2"], taps["dsg"])
        out["up"] = dense(resw["h2"], taps["dup"])
    else:
        out["up"] = dense(resw["h2"], taps["dpre"])
    return out


# ------------------------------------------------------------ stage level


def stack_fwd(blocks, x, pos, cfg: T.TransformerConfig, attn_fwd):
    """A stage's blocks (a list of per-layer trees) forward, collecting
    each layer's residuals: (y, [resb], [resw])."""
    resb_s, resw_s = [], []
    for blk in blocks:
        x, resb, resw = block_fwd(blk, x, pos, cfg, attn_fwd)
        resb_s.append(resb)
        resw_s.append(resw)
    return x, resb_s, resw_s


def stack_bwd_x(blocks, resb_s, resw_s, dy, pos, cfg: T.TransformerConfig,
                attn_bwd):
    """The B pass over a stage's blocks, last layer first: (dx, [taps],
    [norm grads]) in layer order."""
    taps_s, dnorm_s = [None] * len(blocks), [None] * len(blocks)
    for j in reversed(range(len(blocks))):
        dy, taps_s[j], dnorm_s[j] = block_bwd_x(blocks[j], resb_s[j],
                                                resw_s[j], dy, pos, cfg,
                                                attn_bwd)
    return dy, taps_s, dnorm_s


def stack_bwd_w(resw_s, taps_s):
    """The W pass over a stage's blocks: [dense-leaf grads] per layer."""
    return [block_bwd_w(rw, tp) for rw, tp in zip(resw_s, taps_s)]
