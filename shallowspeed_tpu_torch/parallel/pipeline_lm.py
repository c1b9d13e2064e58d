"""Pipeline parallelism for the transformer LM — counterpart of
`shallowspeed_tpu/parallel/pipeline_lm.py::PipelineLMEngine`.

The reference runs one SPMD tick loop inside a `shard_map` over
("dp", "pp") or ("dp", "pp", "tp"): stage s is the mesh's pp
coordinate, activations hop right with `ppermute`, and the backward is
derived (GPipe), hand-scheduled with a per-tick `jax.vjp` (1F1B) or
split into B and W passes that follow verified tables (ZB-H1). Here one
process drives a `parallel.mesh.Grid` (`make_pipeline_mesh`; every cell
the card, or the CPU in the tests), as the GSPMD engines do, and
the schedules are loops over the same ticks:

- **Layout.** The blocks are stacked on a leading layer axis
  (`stack_blocks`) and cut over pp, so cell (r, s[, t]) holds stage s's
  layers; under tp each stage's leaves also take the Megatron placement
  (qkv / q / kv, up and gate column-parallel with their biases; proj
  and down row-parallel, their biases added once after the sum; norms
  whole). The embeddings, ln_f and the head are replicated: every cell
  holds a copy, and the head is not vocabulary-parallel. The optimizer
  state lives in this stacked layout, as the reference's does;
  `canon_export_tree` / `canon_import_tree` carry it to and from the
  canonical checkpoint layout.
- **A stage.** Stage s of replica r reads its cell's blocks (under FSDP
  the dp pieces gathered for the step and dropped after it), casts them
  to the compute dtype once and runs every microbatch on detached
  aliases of those casts, so each microbatch's gradient lands apart;
  `parallel.tensor`'s Megatron operators (`tp_block`) run the blocks
  under tp. The per-microbatch gradients are summed in f32 in the
  schedule's order (no bf16 partial sums), the hop to the next stage is
  an explicit `.to(device)` of its cell.
- **GPipe.** At tick t stage s runs microbatch t - s; inactive ticks
  are skipped, not masked. The backward runs the ticks in reverse, so
  each stage's microbatches come back in reverse order, as the
  transpose of the reference's scan returns them.
- **1F1B** (PipeDream-Flush). F(s, m) at tick 2m + s, B(s, m) at tick
  2m + 2pp - 1 - s. F runs without a graph and stashes only the stage
  input (at most min(pp, n_mu) in flight); B reruns the stage forward
  with grad from the stash and back-propagates the received cotangent,
  as the reference's per-tick `jax.vjp` does — so under flash K1 runs
  twice per layer and microbatch.
- **ZB-H1.** F, B and W follow `verify.zb_tables(n_mu, pp)`'s rounds.
  F stashes the blocks' residuals (`parallel.zb`), B walks dy -> dx
  with the head's and the embedding's own small vjps, W forms the
  dense weight gradients. Under flash, B replays K2 and K3 from the
  (o, lse) F stashed; K1 never runs again. The reference's carve-outs
  hold: ("dp", "pp") only, dense, no dropout, no remat.
- **The reduction.** Block leaves are summed over dp in rank order;
  the replicated leaves over (dp, pp) in rank order (only the first and
  last stage add terms, both when the embeddings are tied), so every
  pp and tp cell then updates its copy with the same gradient. ZeRO-1
  and ZeRO-2 slice each leaf over dp on the first dimension its spec
  leaves free, FSDP rests the parameters so (`parallel.gspmd`'s update,
  clipping and health pack).
- **The pipelined decode** (`generate`): each stage keeps its own
  layers' K/V cache on its cell; a token makes pp phases and the last
  stage's hidden state returns to stage 0, which samples. Plain
  attention, as the reference's decode.

Left for a later slice (`NotPorted`): interleaved virtual stages, an
sp axis in the pipeline, and MoE in the pipeline.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import (_block_decode, _embed,
                                                    prompt_bucket_len,
                                                    sample_rows)
from shallowspeed_tpu_torch.models.kv_cache import cache_write, init_kv_cache
from shallowspeed_tpu_torch.ops.attention import attention
from shallowspeed_tpu_torch.ops.dropout import dropout as _dropout
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.ops.flash_attention import flash_attention
from shallowspeed_tpu_torch.parallel import zb as ZB
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine, P, with_axis
from shallowspeed_tpu_torch.parallel.verify import zb_tables
from shallowspeed_tpu_torch.weights import leaves, map_tree

_NEXT = "Queue 1 item 5b, the rest of the LM pipeline"


def _stack(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def stack_blocks(params: dict) -> dict:
    """blocks: list of per-layer trees -> one tree with a leading layer
    axis on every leaf (the axis cut over pp); tensors or numpy."""
    stacked = map_tree(lambda *ls: _stack(ls), *params["blocks"])
    return {k: stacked if k == "blocks" else v for k, v in params.items()}


def unstack_blocks(params: dict, n_layers: int) -> dict:
    """Inverse of `stack_blocks` (the canonical checkpoint layout)."""
    blocks = [map_tree(lambda x, i=i: x[i], params["blocks"])
              for i in range(n_layers)]
    return {k: blocks if k == "blocks" else v for k, v in params.items()}


def _require(cond, msg) -> None:
    """The reference constructor's `assert`, as an AssertionError that
    python -O keeps."""
    if not cond:
        raise AssertionError(msg)


class _Stage:
    """Stage s of replica r for one step: the cast compute tensors its
    cells hold — `layers` one tree per layer (at tp > 1 a list of the tp
    cells' trees), `top` the replicated leaves it reads — the f32
    gradient sums `acc` and the attention substrate."""

    def __init__(self, s, device, n_layers, attn_fn):
        self.s, self.device, self.n_layers = s, device, n_layers
        self.layers, self.top = [], {}
        self.attn_fn = attn_fn
        self.leaf_of = {}           # id(compute leaf) -> (leaf i, t, layer)
        self.acc = {}               # (leaf i, t) -> f32 stage block

    def add(self, i, t, j, g) -> None:
        """Add the gradient `g` of layer j (None: a replicated leaf) of
        leaf i on tp cell t into the stage's f32 sum."""
        a = self.acc[(i, t)]
        (a if j is None else a[j]).add_(g.float())


class PipelineLMEngine(GSPMDEngine):
    """Pipeline-parallel transformer trainer over a ("dp", "pp") or
    ("dp", "pp", "tp") grid (`parallel.mesh.make_pipeline_mesh`):
    `schedule` "gpipe", "1f1b" or "zb", `attn` "xla" (the plain
    attention) or "flash" (K1/K2/K3), each dp replica's rows cut into
    `n_mubatches` microbatches. `params`, when given, is a canonical
    numpy tree to start from instead of drawing `init(cfg, seed)`."""

    canonical_opt_identity = False

    def __init__(self, cfg: T.TransformerConfig, optimizer, mesh,
                 n_mubatches: int = 4, seed: int = 0,
                 schedule: str = "gpipe", attn: str = "xla",
                 virtual_pp: int = 1, zero1: bool = False,
                 zero2: bool = False, fsdp: bool = False,
                 health: str = "off", *, params=None):
        names = mesh.axis_names
        _require(names in (("dp", "pp"), ("dp", "pp", "tp"),
                           ("dp", "pp", "sp"), ("dp", "pp", "ep")),
                 f"PipelineLMEngine expects a ('dp','pp'[,'tp'|'sp'|'ep']) "
                 f"mesh, got {names}")
        if names[2:] in (("sp",), ("ep",)):
            raise NotPorted(f"the pipeline over a {names} grid", _NEXT)
        _require(schedule in ("gpipe", "1f1b", "zb"), schedule)
        if schedule == "zb":
            _require(names == ("dp", "pp"),
                     "schedule='zb' runs on a ('dp','pp') mesh — tp/sp/ep "
                     "put collectives inside the per-round lax.switch "
                     "branches (the same de-sync hazard 1F1B documents for "
                     "cond-gated halves)")
            _require(virtual_pp == 1,
                     "schedule='zb' composes with vpp=1 (interleaved "
                     "chunks would need per-chunk B/W tables; not built)")
            _require(cfg.n_experts == 0,
                     "schedule='zb' needs the dense block family (the MoE "
                     "dispatch/combine backward is not hand-split)")
            _require(cfg.dropout == 0.0 and cfg.attn_dropout == 0.0,
                     "schedule='zb' trains without dropout (the "
                     "hand-split backward does not thread mask keys F->B)")
            _require(attn in ("xla", "flash"),
                     "schedule='zb' supports the xla/flash substrates "
                     "(sequence stays whole inside a stage)")
            _require(not cfg.remat,
                     "schedule='zb' IS the no-recompute schedule: it "
                     "stashes block residuals F->B by design (remat would "
                     "undo the B=1 cost the schedule needs)")
        _require(virtual_pp >= 1, virtual_pp)
        _require(attn in ("xla", "flash", "ring", "ring-flash",
                          "ulysses-flash"), attn)
        if attn not in ("xla", "flash"):
            _require(False,
                     f"attn={attn!r} collects over an 'sp' mesh axis; this "
                     f"mesh is {names} (use attn='xla' or 'flash')")
        _require(cfg.attn_dropout == 0.0,
                 "attention-probability dropout is not available in the "
                 "pipeline engine (plain-substrate only; see "
                 "TransformerConfig.attn_dropout)")
        has_tp = names[2:] == ("tp",)
        _require(cfg.n_experts == 0 or not has_tp,
                 "MoE x tp is not supported in the pipeline engine: the "
                 "Megatron placement has no expert-dimension rule, so tp "
                 "peers would each run the FULL routed FFN on identical "
                 "inputs — a correct program that silently wastes the tp "
                 "axis's FLOPs. Expert scaling is the ep axis's job (MoE "
                 "composes with dp/pp/sp here, dp/ep in parallel/expert.py)")
        if virtual_pp > 1:
            raise NotPorted("interleaved virtual stages (virtual_pp > 1)",
                            _NEXT)
        if cfg.n_experts > 0:
            raise NotPorted("MoE in the pipeline", _NEXT)
        sizes = mesh.shape
        pp, tp = sizes["pp"], sizes.get("tp", 1)
        _require(cfg.n_layers % pp == 0,
                 f"n_layers={cfg.n_layers} must be divisible by pp={pp}")
        _require(cfg.n_heads % tp == 0,
                 f"n_heads={cfg.n_heads} must be divisible by tp={tp}")
        _require(cfg.kv_heads % tp == 0,
                 f"n_kv_heads={cfg.kv_heads} must be divisible by tp={tp}")
        _require(cfg.ffn_dim % tp == 0, "")
        _require(sum((zero1, zero2, fsdp)) <= 1,
                 "pick ONE of zero1 / zero2 / fsdp (each subsumes the last)")
        if zero1 or zero2 or fsdp:
            _require(sizes["dp"] > 1,
                     "--zero1/--zero2/--fsdp shard over dp; need dp > 1")
        self.schedule, self.attn = schedule, attn
        self.n_mu = n_mubatches
        self.pp, self.vpp = pp, virtual_pp
        self.l_local = cfg.n_layers // pp
        self.zero1, self.zero2, self.fsdp = zero1, zero2, fsdp
        self.peak_stash = 0
        super().__init__(cfg, optimizer, seed, mesh=mesh, zero1=zero1,
                         zero2=zero2, health=health, params=params)
        self._tables = zb_tables(n_mubatches, pp) if schedule == "zb" else None
        # each leaf's compute dtype, by `cast_params`' own rule
        self._cast_to = [m.dtype for m in leaves(
            T.cast_params(self._template, cfg.compute_dtype))]

    # ------------------------------------------------ GSPMD surface

    def validate(self, cfg, mesh) -> None:
        self.tp = mesh.shape.get("tp", 1)

    def _layout(self, tree):
        return stack_blocks(tree)

    def _canonical(self, tree):
        return unstack_blocks(tree, self.cfg.n_layers)

    def param_specs(self, cfg: T.TransformerConfig) -> dict:
        """The reference's `_pspecs` over the stacked layout (its
        `_store_specs` under fsdp: 'dp' on each leaf's first free
        divisible dimension)."""
        blocks = self._template["blocks"]
        if self.tp > 1:
            col = {"W": P("pp", None, "tp"), "b": P("pp", "tp")}
            rowp = {"W": P("pp", "tp", None), "b": P("pp")}
            kinds = {"proj": rowp, "down": rowp}
            bspec = {k: (kinds.get(k, col) if k not in ("ln1", "ln2")
                         else {"g": P("pp"), "b": P("pp")})
                     for k in blocks}
        else:
            bspec = map_tree(lambda _: P("pp"), blocks)
        specs = {k: map_tree(lambda _: P(), v)
                 for k, v in self._template.items() if k != "blocks"}
        specs["blocks"] = bspec
        if self.fsdp:
            dp = self.mesh.shape["dp"]
            specs = map_tree(lambda s, m: with_axis(s, tuple(m.shape), dp),
                             specs, self._template)
        return specs

    def _per_cell_update(self) -> bool:
        """Without ZeRO or FSDP every cell updates its own blocks, as the
        reference's optimizer step runs inside its `shard_map` on each
        device's shards: Adafactor's RMS clipping and scaling then read
        each stage's (and tp cell's) block, not the whole leaf. Under
        ZeRO / FSDP the reference's update is a GSPMD program over whole
        leaves, and so is this one."""
        return (self.optimizer.elementwise
                or not (self.zero or self.fsdp))

    def _substrates(self, r: int):
        w = self.cfg.attn_window
        fn = flash_attention if self.attn == "flash" else attention
        return partial(fn, causal=True, window=w)

    # ------------------------------------------------------- cells

    def _pcell(self, r: int, s: int, t: int = 0) -> tuple:
        return (r, s, t) if self.tp > 1 else (r, s)

    def _leaf_block(self, i: int, r: int, s: int, t: int):
        """Leaf i's block as stage s of replica r on tp cell t reads it:
        its cell's block, or under FSDP the dp pieces gathered onto that
        cell."""
        spec = self._pspecs[i]
        t = t if "tp" in spec.axes() else 0
        dev = self._dev[self._pcell(r, s, t)]
        if "dp" not in spec.axes():
            return self._shards[self._pcell(r, s, t)][i]
        z = spec.padded(len(self._shapes[i])).index("dp")
        return torch.cat([self._shards[self._pcell(j, s, t)][i].to(dev)
                          for j in range(self.dp)], dim=z)

    def _top_names(self, s: int) -> tuple:
        """The replicated leaves stage s reads."""
        names = []
        if s == 0:
            names += ["tok_emb", "pos_emb"]
        if s == self.pp - 1:
            names += ["ln_f"]
            names += ([] if self.cfg.tie_embeddings else ["head"])
            if self.cfg.tie_embeddings and s != 0:
                names += ["tok_emb"]
        return tuple(names)

    def _cast_block(self, i: int, r: int, s: int, t: int = 0):
        """Leaf i's block at stage s of replica r (tp cell t), cast to
        the compute dtype as `transformer.cast_params` casts it."""
        return self._leaf_block(i, r, s, t).to(self._cast_to[i])

    @torch.no_grad()
    def _stage(self, r: int, s: int, grad: bool, sums: bool = True
               ) -> _Stage:
        """Stage s of replica r for this step: per layer (and tp cell)
        detached aliases of the cast blocks, with requires_grad when
        `grad`; a leaf no tp axis cuts is one alias for every tp cell.
        With `sums`, a zero f32 gradient sum per block it reads."""
        idx = self._index
        st = _Stage(s, self._dev[self._pcell(r, s)], self.l_local,
                    self._attn_fns[0])
        blocks, aliases = {}, {}

        def alias(i, t, j):
            t = t if "tp" in self._pspecs[i].axes() else 0
            a = aliases.get((i, t, j))
            if a is None:
                b = blocks.get((i, t))
                if b is None:
                    b = blocks[(i, t)] = self._cast_block(i, r, s, t)
                    if sums:
                        st.acc[(i, t)] = torch.zeros(
                            b.shape, dtype=torch.float32, device=b.device)
                a = b if j is None else b[j]
                a = a.detach().requires_grad_(grad)
                aliases[(i, t, j)] = a
                st.leaf_of[id(a)] = (i, t, j)
            return a

        trees = [[map_tree(lambda i, t=t, j=j: alias(i, t, j),
                           idx["blocks"]) for t in range(self.tp)]
                 for j in range(self.l_local)]
        st.layers = [ts[0] if self.tp == 1 else ts for ts in trees]
        for name in self._top_names(s):
            st.top[name] = map_tree(lambda i: alias(i, 0, None), idx[name])
        return st

    @staticmethod
    def _stage_inputs(st: _Stage) -> list:
        """The stage's compute leaves, each once."""
        seen, out = set(), []
        for x in leaves({"l": st.layers, "t": st.top}):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        return out

    @staticmethod
    def _accumulate(st: _Stage, inputs, grads) -> None:
        """Add each compute leaf's gradient into the stage's f32 sums."""
        for x, g in zip(inputs, grads):
            if g is not None:
                i, t, j = st.leaf_of[id(x)]
                st.add(i, t, j, g)

    # ------------------------------------------------------- forward

    def _keys(self, r: int, m: int, s: int):
        """(stage key, embedding key) of microbatch m of replica r at
        stage s: one key a step, folded with (m, r), then with s (or pp
        for the embedding), as the reference's `mu_key` derives them; the
        blocks fold their layer index in. (None, None) without dropout."""
        if self.cfg.dropout == 0.0:
            return None, None
        k = fold_key(fold_key(self.seed, self._step_count), m, r)
        return fold_key(k, s), fold_key(k, self.pp)

    def _block_fn(self):
        fn = T._block
        if self.tp > 1:
            from shallowspeed_tpu_torch.parallel.tensor import tp_block

            fn = tp_block
        if self.cfg.remat and torch.is_grad_enabled():
            return T._remat_block(self.cfg, fn)
        return fn

    def _embed_parts(self, top, tok):
        x = top["tok_emb"][tok]
        if not self.cfg.rope:
            x = x + top["pos_emb"][torch.arange(tok.shape[1],
                                                device=tok.device)]
        return x

    def _embed(self, st: _Stage, tok, key):
        return _dropout(self._embed_parts(st.top, tok), self.cfg.dropout,
                        key)

    def _head_nll(self, top, hf, tgt, train: bool = True):
        cfg = self.cfg
        if cfg.xent_chunk > 0:
            return T.chunked_token_loss(top, hf, tgt, cfg, train)
        return T.token_loss(T.head_logits(top, hf, cfg), tgt, cfg, train)

    def _stage_fwd(self, st: _Stage, x_in, tok, tgt, keys,
                   train: bool = True):
        """One stage's work on one microbatch: (h, nll on the last stage
        else None)."""
        cfg = self.cfg
        k_stage, k_emb = keys
        x = self._embed(st, tok, k_emb) if st.s == 0 else x_in
        pos = torch.arange(x.shape[1], device=x.device)
        attn = [st.attn_fn] * self.tp if self.tp > 1 else st.attn_fn
        block = self._block_fn()
        for j, layer in enumerate(st.layers):
            k = None if k_stage is None else fold_key(k_stage, j)
            x, _ = block(layer, x, cfg, pos, attn, k)
        if st.s != self.pp - 1:
            return x, None
        return x, self._head_nll(st.top, T._norm(st.top["ln_f"], x, cfg),
                                 tgt, train)

    def _split(self, tokens, targets):
        """Each replica's microbatches [(tok, tgt)] on its stage-0 cell,
        as the reference's `_split_mu` cuts a batch."""
        tok, tgt = (self.place(tokens), self.place(targets))
        b, t = tok.shape
        d = self.dp
        _require(b % (d * self.n_mu) == 0,
                 f"batch {b} must divide over dp*ep={d} x "
                 f"n_mubatches={self.n_mu}")
        out = []
        for r, (a, c) in enumerate(zip(tok.chunk(d), tgt.chunk(d))):
            dev = self._dev[self._pcell(r, 0)]
            out.append(list(zip(a.to(dev).chunk(self.n_mu),
                                c.to(dev).chunk(self.n_mu))))
        return out

    def _to(self, x, s: int, r: int):
        return None if x is None else x.to(self._dev[self._pcell(r, s)])

    # ----------------------------------------------------- schedules

    def _gpipe(self, r: int, mus, stages):
        """GPipe: every forward tick, then every backward tick in reverse.
        Returns the replica's summed microbatch NLL."""
        pp, n_mu = self.pp, self.n_mu
        saved = {}
        loss = None
        with torch.enable_grad():
            for tk in range(n_mu + pp - 1):
                for s in range(pp):
                    m = tk - s
                    if not 0 <= m < n_mu:
                        continue
                    x_in = None
                    if s > 0:
                        x_in = saved[(s - 1, m)][1].detach().to(
                            stages[s].device).requires_grad_(True)
                    tok, tgt = mus[m]
                    h, nll = self._stage_fwd(
                        stages[s], x_in, self._to(tok, s, r),
                        self._to(tgt, s, r), self._keys(r, m, s))
                    saved[(s, m)] = (x_in, h, nll)
                    if nll is not None:
                        d = nll.detach()
                        loss = d if loss is None else loss + d
        self.peak_stash = max(self.peak_stash, n_mu)
        dx = {}
        for tk in reversed(range(n_mu + pp - 1)):
            for s in reversed(range(pp)):
                m = tk - s
                if not 0 <= m < n_mu:
                    continue
                x_in, h, nll = saved.pop((s, m))
                g = self._backward(stages[s], x_in, h, nll,
                                   dx.pop((s, m), None))
                if g is not None:
                    dx[(s - 1, m)] = self._to(g, s - 1, r)
        return loss

    def _backward(self, st: _Stage, x_in, h, nll, dh):
        """Back-propagate one (stage, microbatch): the last stage's NLL
        seeded with 1 / n_mu, any other's output with the cotangent `dh`
        from the next stage; the parameter gradients go into the stage's
        f32 sums. Returns the input's cotangent (None on stage 0),
        the previous stage's to take."""
        ins = self._stage_inputs(st)
        first = [x_in] if x_in is not None else []
        if nll is not None:
            out, seed = nll, torch.full_like(nll, 1.0 / self.n_mu)
        else:
            out, seed = h, dh
        gs = torch.autograd.grad(out, first + ins, seed, allow_unused=True)
        self._accumulate(st, ins, gs[len(first):])
        return gs[0] if first else None

    def _1f1b(self, r: int, mus, stages):
        """PipeDream-Flush over 2 (n_mu + pp - 1) ticks."""
        pp, n_mu = self.pp, self.n_mu
        x_msg, g_msg = {}, {}
        stash = [dict() for _ in range(pp)]
        loss = None
        for tk in range(2 * (n_mu + pp - 1)):
            for s in range(pp):
                f_rel = tk - s
                if 0 <= f_rel < 2 * n_mu and f_rel % 2 == 0:
                    m = f_rel // 2
                    tok, tgt = mus[m]
                    x_in = x_msg.pop((s, m)) if s > 0 else None
                    with torch.no_grad():
                        h, nll = self._stage_fwd(
                            stages[s], x_in, self._to(tok, s, r),
                            self._to(tgt, s, r), self._keys(r, m, s))
                    stash[s][m] = x_in
                    self.peak_stash = max(self.peak_stash, len(stash[s]))
                    if nll is not None:
                        loss = nll if loss is None else loss + nll
                    else:
                        x_msg[(s + 1, m)] = self._to(h, s + 1, r)
                b_rel = tk - (2 * pp - 1 - s)
                if 0 <= b_rel < 2 * n_mu and b_rel % 2 == 0:
                    m = b_rel // 2
                    tok, tgt = mus[m]
                    x_saved = stash[s].pop(m)
                    with torch.enable_grad():
                        x_in = (None if x_saved is None
                                else x_saved.detach().requires_grad_(True))
                        h, nll = self._stage_fwd(
                            stages[s], x_in, self._to(tok, s, r),
                            self._to(tgt, s, r), self._keys(r, m, s))
                        dx = self._backward(stages[s], x_in, h, nll,
                                            g_msg.pop((s, m), None))
                    if dx is not None:
                        g_msg[(s - 1, m)] = self._to(dx, s - 1, r)
        return loss

    def _zb(self, r: int, mus, stages):
        """ZB-H1: one F, B or W per stage and round, as the tables say."""
        tb, cfg, pp = self._tables, self.cfg, self.pp
        fwd, bwd = ZB.make_attn_core(self.attn, cfg.attn_window)
        act, grad, resb, resw, taps = {}, {}, {}, {}, {}
        loss = None
        for rnd in range(tb.n_rounds):
            for s in range(pp):
                op, m = int(tb.op[rnd, s]), int(tb.mu[rnd, s])
                st = stages[s]
                tok, tgt = (self._to(x, s, r) for x in mus[m])
                pos = torch.arange(tok.shape[1], device=st.device)
                if op == 1:                                       # F
                    x0 = (self._embed(st, tok, None) if s == 0
                          else act.pop((s, m)))
                    h, rb, rw = ZB.stack_fwd(st.layers, x0, pos, cfg, fwd)
                    resb[(s, m)], resw[(s, m)] = (rb, h), rw
                    if s < pp - 1:
                        act[(s + 1, m)] = self._to(h, s + 1, r)
                    else:
                        nll = self._head_nll(
                            st.top, T._norm(st.top["ln_f"], h, cfg), tgt)
                        loss = nll if loss is None else loss + nll
                    self.peak_stash = max(self.peak_stash, sum(
                        1 for k in resw if k[0] == s))
                elif op == 2:                                     # B
                    rb, h = resb.pop((s, m))
                    dh = (self._head_bwd(st, h, tgt) if s == pp - 1
                          else grad.pop((s, m)))
                    dx, taps[(s, m)], dnorm = ZB.stack_bwd_x(
                        st.layers, rb, resw[(s, m)], dh, pos, cfg, bwd)
                    for layer, dn in zip(st.layers, dnorm):
                        self._add_tree(st, layer, dn)
                    if s == 0:
                        self._embed_bwd(st, tok, dx)
                    else:
                        grad[(s - 1, m)] = self._to(dx, s - 1, r)
                elif op == 3:                                     # W
                    dense = ZB.stack_bwd_w(resw.pop((s, m)),
                                           taps.pop((s, m)))
                    for layer, dw in zip(st.layers, dense):
                        self._add_tree(st, layer, dw)
        return loss

    def _add_tree(self, st: _Stage, params, grads) -> None:
        """Add a gradient tree (a subtree of `params`' structure) into the
        stage's sums."""
        for k, g in grads.items():
            if isinstance(g, dict):
                self._add_tree(st, params[k], g)
            else:
                i, t, j = st.leaf_of[id(params[k])]
                st.add(i, t, j, g)

    def _local_vjp(self, st: _Stage, names, fn, seed):
        """The vjp of `fn(tree)` — `tree` detached copies of the stage's
        replicated leaves `names` — seeded with `seed`, its gradients
        added into the stage's sums. Returns fn's other inputs'
        cotangents as fn's closure hands them back (see callers)."""
        with torch.enable_grad():
            tree = {n: map_tree(lambda x: x.detach().requires_grad_(True),
                                st.top[n]) for n in names}
            out, extra = fn(tree)
            ins = list(leaves(tree))
            gs = torch.autograd.grad(out, extra + ins, seed,
                                     allow_unused=True)
        self._accumulate(st, list(leaves({n: st.top[n] for n in names})),
                         gs[len(extra):])
        return gs[:len(extra)]

    def _head_bwd(self, st: _Stage, h, tgt):
        """zb's B on the last stage: the head's vjp (its weight gradients
        land here, not in W), seeded with 1 / n_mu; returns dh."""
        cfg = self.cfg
        names = ["ln_f", "tok_emb" if cfg.tie_embeddings else "head"]
        h_ = h.detach().requires_grad_(True)

        def head(tree):
            nll = self._head_nll(tree, T._norm(tree["ln_f"], h_, cfg), tgt)
            return nll, [h_]

        (dh,) = self._local_vjp(st, names, head,
                                torch.tensor(1.0 / self.n_mu,
                                             device=h.device))
        return dh

    def _embed_bwd(self, st: _Stage, tok, dx) -> None:
        """zb's B on stage 0: the embedding gather's vjp."""
        names = ["tok_emb"] + ([] if self.cfg.rope else ["pos_emb"])
        self._local_vjp(st, names, lambda tree: (self._embed_parts(
            tree, tok), []), dx)

    # --------------------------------------------------- the reduction

    def _reduced(self, tokens, targets):
        """(loss, reduced gradient), `red[i]` {update block key: f32
        gradient} as `GSPMDEngine._reduced` gives it: each replica's
        schedule run on its stages, the stage sums reduced over dp (block
        leaves) or (dp, pp) (the replicated leaves) in rank order and
        scaled by 1 / dp."""
        run = {"gpipe": self._gpipe, "1f1b": self._1f1b,
               "zb": self._zb}[self.schedule]
        red = [dict() for _ in self._pspecs]
        total = None
        for r, mus in enumerate(self._split(tokens, targets)):
            stages = [self._stage(r, s, grad=self.schedule != "zb")
                      for s in range(self.pp)]
            loss = run(r, mus, stages).detach().to(self.device)
            total = loss if total is None else total + loss
            for st in stages:
                for (i, t), g in sorted(st.acc.items()):
                    self._reduce_into(red, i, r, st.s, t, g)
            del stages
        total = total / (self.n_mu * self.dp)
        if self.dp > 1:
            for blocks in red:
                for g in blocks.values():
                    g.mul_(1.0 / self.dp)
        return total, [dict(sorted(b.items())) for b in red]

    def _reduce_into(self, red, i, r, s, t, g) -> None:
        us = self._uspecs[i]
        coord = {"dp": r, "pp": s, "tp": t}
        if "dp" in us.axes():
            z = us.padded(g.dim()).index("dp")
            parts = [(self._key(us, {**coord, "dp": j}), piece)
                     for j, piece in enumerate(g.chunk(self.dp, z))]
        else:
            parts = [(self._key(us, coord), g)]
        for key, piece in parts:
            mine = red[i].get(key)
            if mine is None:
                red[i][key] = piece.to(self._dev[self._src_cell(0, key)])
            else:
                mine.add_(piece.to(mine.device))

    # ----------------------------------------------------------- eval

    @torch.no_grad()
    def eval_loss(self, tokens, targets) -> float:
        """The mean NLL without label smoothing or dropout, no update."""
        total = None
        for r, mus in enumerate(self._split(tokens, targets)):
            stages = [self._stage(r, s, grad=False, sums=False)
                      for s in range(self.pp)]
            for tok, tgt in mus:
                x = None
                for st in stages:
                    x, nll = self._stage_fwd(
                        st, self._to(x, st.s, r), self._to(tok, st.s, r),
                        self._to(tgt, st.s, r), (None, None), train=False)
                nll = nll.to(self.device)
                total = nll if total is None else total + nll
        return float(total / (self.n_mu * self.dp))

    def logits(self, tokens):
        raise NotImplementedError(
            "PipelineLMEngine has no logits(); the reference's has none "
            "either (get_canonical_params() feeds the one-device forward)")

    # ------------------------------------------------ pipelined decode

    @torch.no_grad()
    def generate(self, prompt, max_new: int, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0) -> np.ndarray:
        """`max_new` tokens after `prompt` (B, Tp) on the pp-cut
        parameters: each stage keeps its own layers' K/V cache, a token
        makes pp phases, stage 0 samples. Returns (B, max_new) int32.
        Row b samples with seed + b as `models.generate.generate` does,
        so the streams equal its streams at any dp."""
        cfg = self.cfg
        _require(self.tp == 1,
                 "pipelined decode supports ('dp','pp') meshes (tp/sp/ep "
                 "size 1; ep decode would need the all-to-all inside "
                 "cond-gated phases — restore into an ep=1 pipeline to "
                 "sample)")
        _require(not self.fsdp,
                 "pipelined decode needs stage-resident params; restore "
                 "the checkpoint into a non-fsdp pipeline to sample")
        prompt = np.asarray(prompt)
        b, tp_len = prompt.shape
        _require(tp_len + max_new <= cfg.max_seq,
                 f"prompt {tp_len} + max_new {max_new} exceeds "
                 f"max_seq={cfg.max_seq}")
        pad = (-b) % self.dp
        if pad:   # dp shards the rows; the last row repeats to fit
            prompt = np.concatenate([prompt, np.repeat(prompt[-1:], pad,
                                                       axis=0)])
        tp_b = prompt_bucket_len(tp_len, max_new, cfg.max_seq)
        out = []
        rows = np.array_split(np.arange(prompt.shape[0]), self.dp)
        for r, idx in enumerate(rows):
            out.append(self._decode(r, prompt[idx], int(idx[0]), tp_len,
                                    tp_b, max_new, temperature, top_k,
                                    top_p, seed))
        return np.concatenate(out)[:b]

    def _decode(self, r, prompt, row0, tp_len, tp_b, max_new, temperature,
                top_k, top_p, seed):
        cfg = self.cfg
        stages = [self._stage(r, s, grad=False, sums=False)
                      for s in range(self.pp)]
        # stage 0 embeds and samples with its own copies
        top = {n: map_tree(lambda i: self._cast_block(i, r, 0),
                           self._index[n])
               for n in ("tok_emb", "pos_emb", "ln_f")
               + (() if cfg.tie_embeddings else ("head",))}
        dev0 = stages[0].device
        b = prompt.shape[0]
        tokens = torch.zeros((b, tp_b), dtype=torch.long, device=dev0)
        tokens[:, :tp_len] = torch.as_tensor(prompt, device=dev0).long()
        scfg = dataclasses.replace(cfg, n_layers=self.l_local)
        caches = [init_kv_cache(scfg, b, tp_b + max_new, device=st.device)
                  for st in stages]
        attn = partial(attention, causal=True, window=cfg.attn_window)
        temp, seeds = [temperature] * b, [seed + row0 + i for i in range(b)]

        def sample(x, i):
            hf = T._norm(top["ln_f"], x.to(dev0), cfg)
            logits = T.head_logits(top, hf, cfg).float()
            return sample_rows(logits, temp, seeds, [i] * b, top_k, top_p)

        x = _embed(top, tokens, 0, cfg)
        pos = torch.arange(tp_b, device=dev0)
        for st, cache in zip(stages, caches):
            x = x.to(st.device)
            for layer, cblk in zip(st.layers, cache):
                x, _, (k, v) = T._block(layer, x, cfg, pos.to(st.device),
                                        attn, with_kv=True)
                cache_write(cblk, k, v, 0)
        out = np.zeros((b, max_new), np.int32)
        out[:, 0] = sample(x[:, tp_len - 1], 0)
        for i in range(1, max_new):
            p = tp_len + i - 1
            tok = torch.from_numpy(out[:, i - 1]).to(dev0, torch.long)
            x = _embed(top, tok[:, None], p, cfg)
            for st, cache in zip(stages, caches):
                x = x.to(st.device)
                for layer, cblk in zip(st.layers, cache):
                    x = _block_decode(layer, x, cfg, cblk, p)
            out[:, i] = sample(x[:, 0], i)
        return out

    # -------------------------------------------- checkpoint interface

    def canon_export_tree(self, tree):
        """A params-shaped tree in the stacked layout (e.g. Adam's
        moments) -> the canonical layout, the transform params take into
        a checkpoint."""
        return self._canonical(tree)

    def canon_import_tree(self, tree):
        """Inverse of `canon_export_tree` (numpy or tensors)."""
        return self._layout(tree)
