"""Plain attention in torch arithmetic — counterpart of
`shallowspeed_tpu/ops/attention.py`: `attention`, and the sequence-
parallel substrates `ring_attention`, `ulysses_attention` and
`allgather_attention`.

This is the full-forward reference the serving path is held against,
so it deliberately repeats the JAX numerics instead of calling a fused
library operator: scores and softmax in float32 (the bf16 products are
exact in f32, so upcasting before the einsum equals JAX's
`preferred_element_type=f32`), the probabilities cast to V's dtype
before the PV product, the f32 sum cast back to q's dtype.
Attention-probability dropout lives here only, as in the reference: the
fused flash kernels do not take it.

The sequence-parallel substrates take one replica's gathered sequence
and the devices of its sp cells: the sequence is cut into one tile per
cell (`seq_tiles`), each tile placed on its cell, and what the
reference moves with `ppermute` or `all_to_all` is an explicit
`.to(cell device)` here (one controller drives every cell; on one card
every cell is that card). The result comes back whole on the home
cell.
"""

from __future__ import annotations

import torch

from shallowspeed_tpu_torch.ops.dropout import keep_mask
from shallowspeed_tpu_torch.telemetry import collectives as C

NEG = -1e30


def attention(q, k, v, causal: bool = True, window: int = 0,
              dropout: float = 0.0, dropout_key=None, q_offset: int = 0):
    """q: (B, T, H, D); k, v: (B, Tk, Hkv, D) with Hkv | H (native GQA:
    query head h reads kv head h // G, K/V are never repeated).
    `causal` lets position i see keys <= i; `window > 0` additionally
    limits it to [i - window + 1, i]. `dropout` with a `dropout_key`
    (`ops.dropout`) drops probabilities before the PV product, the kept
    ones scaled by 1 / (1 - dropout). `q_offset` is the position of
    q's first row in k's sequence (a query tile against the whole
    sequence's keys). Returns (B, T, H, D) in q's dtype."""
    b, tq, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"n_heads={h} is not a multiple of kv heads={kvh}")
    scale = 1.0 / float(d) ** 0.5
    qg = q.reshape(b, tq, kvh, h // kvh, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if causal or window > 0:
        tk = k.shape[1]
        iq = q_offset + torch.arange(tq, device=q.device)[:, None]
        ik = torch.arange(tk, device=q.device)[None, :]
        mask = iq >= ik if causal else torch.ones(tq, tk, dtype=torch.bool,
                                                  device=q.device)
        if window > 0:
            mask = mask & (ik > iq - window)
        s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    if dropout > 0.0 and dropout_key is not None:
        keep = 1.0 - dropout
        p = torch.where(keep_mask(p.shape, dropout, dropout_key, q.device),
                        p / keep, 0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, tq, h, d).to(q.dtype)


attention.supports_prob_dropout = True


def cell_devices(devices, like) -> list:
    """The sp cells' devices of one replica: a sequence of devices, or a
    count of cells that all lie on `like`'s device."""
    if isinstance(devices, int):
        return [like.device] * devices
    return list(devices)


def seq_tiles(x, devices) -> list:
    """x (B, T, ...) cut along T into one tile per cell, tile s placed on
    cell s (a view where the cell is x's device)."""
    n = len(devices)
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} does not split "
                         f"into {n} equal tiles")
    return [t.to(d) for t, d in zip(x.chunk(n, dim=1), devices)]


def ring_attention(q, k, v, devices, causal: bool = True, window: int = 0):
    """Blockwise ring attention — `shallowspeed_tpu/ops/attention.py::
    ring_attention` on the gathered sequence: q (B, T, H, D), k/v (B, T,
    Hkv, D), `devices` the replica's sp cells (or their count, all on
    q's device). Cell idx's query tile meets the K/V block of cell
    (idx - i) mod sp at hop i, in hop order, with the reference's f32
    online softmax (running max, normaliser, unnormalised output) and
    its masked entries zeroed explicitly (a fully masked block would
    otherwise add exp(0) = 1 to the normaliser). Differentiable by
    autograd, which runs the ring in reverse. Returns (B, T, H, D) in
    q's dtype on q's device."""
    devices = cell_devices(devices, q)
    n = len(devices)
    qs, ks, vs = (seq_tiles(x, devices) for x in (q, k, v))
    b, t, h, d = qs[0].shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"n_heads={h} is not a multiple of kv heads={kvh}")
    g = h // kvh
    scale = 1.0 / float(d) ** 0.5
    outs = []
    for idx, dev in enumerate(devices):
        q32 = qs[idx].float().reshape(b, t, kvh, g, d)
        qpos = idx * t + torch.arange(t, device=dev)
        o = torch.zeros(b, t, kvh, g, d, dtype=torch.float32, device=dev)
        m = torch.full((b, kvh, g, t, 1), NEG, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros(b, kvh, g, t, 1, dtype=torch.float32, device=dev)
        for i in range(n):
            src = (idx - i) % n
            kb, vb = ks[src].to(dev), vs[src].to(dev)
            if i and idx == n - 1:
                # hop i's ppermute of one cell's K/V block (and its
                # transpose in the backward), counted on the last cell
                kb, vb = C.tap(kb, "sp"), C.tap(vb, "sp")
            s = torch.einsum("bqhgd,bkhd->bhgqk", q32, kb.float()) * scale
            kpos = src * t + torch.arange(t, device=dev)
            if causal or window > 0:
                mask = (qpos[:, None] >= kpos[None, :] if causal else
                        torch.ones(t, t, dtype=torch.bool, device=dev))
                if window > 0:
                    mask = mask & (kpos[None, :] > qpos[:, None] - window)
                s = torch.where(mask, s, torch.full_like(s, NEG))
                valid = mask.expand(s.shape)
            else:
                valid = torch.ones_like(s, dtype=torch.bool)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
            alpha = torch.exp(m - m_new)
            lsum = lsum * alpha + p.sum(dim=-1, keepdim=True)
            alpha_o = alpha[..., 0].permute(0, 3, 1, 2)[..., None]
            o = o * alpha_o + torch.einsum("bhgqk,bkhd->bqhgd", p,
                                           vb.float())
            m = m_new
        l_o = lsum[..., 0].permute(0, 3, 1, 2)[..., None]
        out = (o / torch.clamp(l_o, min=1e-30)).reshape(b, t, h, d)
        outs.append(out.to(q.dtype).to(q.device))
    return torch.cat(outs, dim=1)


def ulysses_attention(q, k, v, devices, causal: bool = True, window: int = 0,
                      use_flash: bool = False):
    """All-to-all (Ulysses) attention — `shallowspeed_tpu/ops/
    attention.py::ulysses_attention` on the gathered sequence (q, k, v,
    `devices` as `ring_attention` takes them). The all-to-all is a head
    <-> sequence permutation: cell s gathers heads [s H/sp, (s+1) H/sp)
    of every tile, in tile order (its kv heads likewise: GQA groups stay
    whole), runs the plain attention, or with `use_flash` the K1/K2/K3
    kernels (`flash_attention`), on that head group of the whole
    sequence, and the reverse all-to-all puts the heads back together.
    Needs H and Hkv divisible by sp, with the reference's messages."""
    devices = cell_devices(devices, q)
    n = len(devices)
    h, kvh = q.shape[2], k.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses_attention needs heads ({h}) divisible by the 'sp' "
            f"axis size ({n}); use ring_attention otherwise")
    if kvh % n:
        raise ValueError(
            f"ulysses_attention with GQA needs kv_heads ({kvh}) divisible "
            f"by the 'sp' axis size ({n}); use ring_attention otherwise")
    if use_flash:
        from shallowspeed_tpu_torch.ops.flash_attention import (
            flash_attention as fn)
    else:
        fn = attention

    def tiles(x):
        # the all-to-all's operand (and its transpose's): one cell's tile
        ts = seq_tiles(x, devices)
        return [C.tap(ts[0], "sp")] + ts[1:] if n > 1 else ts

    def gather_seq(ts, s, dev):    # (B, T/n, H, D) tiles -> (B, T, H/n, D)
        w = ts[0].shape[2] // n
        return torch.cat([tile[:, :, s * w:(s + 1) * w].to(dev)
                          for tile in ts], dim=1)

    qt, kt, vt = tiles(q), tiles(k), tiles(v)
    outs = [fn(gather_seq(qt, s, dev), gather_seq(kt, s, dev),
               gather_seq(vt, s, dev), causal=causal, window=window)
            for s, dev in enumerate(devices)]
    if n > 1:
        outs[0] = C.tap(outs[0], "sp")
    # the reverse all-to-all: every position gets its heads back, in order
    return torch.cat([o.to(q.device) for o in outs], dim=2)


def allgather_attention(q, k, v, devices, causal: bool = True,
                        window: int = 0):
    """All-gather context parallelism — the attention of the reference's
    GSPMD engines under an 'sp' axis (`parallel/composite.py`,
    `parallel/expert.py`), where queries stay sharded over the sequence
    and K/V are all-gathered: q, k, v and `devices` as `ring_attention`
    takes them. Cell s takes its query tile and the whole K/V (the
    gather) and runs the plain `attention` with the causal mask offset
    by the tile's start; the outputs come back whole on q's device, in
    tile order."""
    devices = cell_devices(devices, q)
    n = len(devices)
    t = q.shape[1] // n
    if n > 1:
        # the K/V all-gather's operand is one cell's tile; its transpose
        # (the reduce-scatter of dK, dV) takes the whole gradient
        C.count("sp", C.tensor_bytes([k, v]) // n)
        k, v = C.tap(k, "sp", forward=False), C.tap(v, "sp", forward=False)
    outs = [attention(qs, k.to(dev), v.to(dev), causal=causal, window=window,
                      q_offset=s * t).to(q.device)
            for s, (qs, dev) in enumerate(zip(seq_tiles(q, devices),
                                              devices))]
    return torch.cat(outs, dim=1)
