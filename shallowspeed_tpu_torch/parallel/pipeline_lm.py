"""Pipeline parallelism for the transformer LM — counterpart of
`shallowspeed_tpu/parallel/pipeline_lm.py::PipelineLMEngine`.

The reference runs one SPMD tick loop inside a `shard_map` over
("dp", "pp") or ("dp", "pp", X), X one of "tp", "sp" and "ep": stage s
is the mesh's pp coordinate, activations hop right with `ppermute`, and
the backward is derived (GPipe), hand-scheduled with a per-tick
`jax.vjp` (1F1B) or split into B and W passes that follow verified
tables (ZB-H1). Here one process drives a `parallel.mesh.Grid`
(`make_pipeline_mesh`; every cell the card, or the CPU in the tests),
as the GSPMD engines do, and the schedules are loops over the same
ticks:

- **Layout.** The blocks are stacked on a leading layer axis
  (`stack_blocks`) and cut over pp, so cell (r, s[, x]) holds stage s's
  layers; under tp each stage's leaves also take the Megatron placement
  (qkv / q / kv, up and gate column-parallel with their biases; proj
  and down row-parallel, their biases added once after the sum; norms
  whole), under ep each stage's expert leaves are cut over ep (the
  router gate whole), and under sp every sp cell of a stage holds a
  copy of its blocks. The embeddings, ln_f and the head are
  replicated: every cell holds a copy, and the head is not
  vocabulary-parallel. The optimizer state lives in this stacked
  layout, as the reference's does; `canon_export_tree` /
  `canon_import_tree` carry it to and from the canonical checkpoint
  layout.
- **Interleaved virtual stages** (`virtual_pp` = vpp > 1). Cell d holds
  vpp chunks of Lc = n_layers / (pp vpp) layers; chunk v is logical
  stage v pp + d, so stacked position d (vpp Lc) + v Lc + j holds layer
  (v pp + d) Lc + j (the reference's permutation; the pp cut of cell d
  is its chunks in order, and the checkpoint transforms go through the
  inverse). The embedding runs at logical stage 0, the head at pp vpp -
  1, and an activation hops to the next cell, from the last cell back
  to cell 0's next chunk. A chunk's dropout key also folds in v.
- **A stage.** Stage s of a data replica reads its cell's blocks (under
  FSDP the dp pieces gathered for the step and dropped after it),
  casts them to the compute dtype once and runs every microbatch on
  detached aliases of those casts, so each microbatch's gradient lands
  apart; `parallel.tensor`'s Megatron operators (`tp_block`) run the
  blocks under tp. The per-microbatch gradients are summed in f32 in
  the schedule's order (no bf16 partial sums), the hop to the next
  stage is an explicit `.to(device)` of its cell.
- **Sequence parallelism** (an sp axis) lives inside the attention
  substrate, as in `parallel.context`: every other layer is
  position-wise, so a stage runs its microbatch's whole sequence on its
  home cell (r, s, 0) at global positions, and `ring`, `ring-flash` or
  `ulysses-flash` cuts q, k and v over the stage's sp cells. Each tile
  keeps its own loss (the last stage's NLL is the sum of its tiles'
  means; the objective divides by n_mu sp, the reference's mean of
  equal tiles), its own dropout keys, and under MoE its own routing:
  each T/sp tile routes as its own sequence with its own capacity
  (the tile count passed down to `ops.moe.moe_ffn` as `moe_tiles`).
- **MoE** (n_experts > 0). Expert leaves stack with the blocks. Every
  stage adds its blocks' weighted balance and z-losses to the
  objective, in every schedule, so every stage's backward is seeded
  (with 1 / (n_mu sp)), not only the last's. At ep > 1 each data
  replica's rows are its own: rows cut over dp x ep (dp-major), ep is
  a data axis for every non-expert leaf, and a stage routes its rows
  over all E experts and runs each ep cell's experts on its slots
  (`ops.moe.moe_ffn` with the ep cells' expert list, the reference's
  `moe_ffn_ep`); a replica's dropout key folds in its ep coordinate.
- **GPipe.** At tick t logical stage l runs microbatch t - l; inactive
  ticks are skipped, not masked. The backward runs the ticks in
  reverse, so each stage's microbatches come back in reverse order, as
  the transpose of the reference's scan returns them.
- **1F1B** (PipeDream-Flush). At vpp 1, F(s, m) at tick 2m + s, B(s, m)
  at tick 2m + 2pp - 1 - s; at vpp > 1 each cell follows
  `verify.interleaved_tables(n_mu, pp, vpp)` round by round (op, chunk
  and microbatch). F runs without a graph and stashes only the chunk
  input (at most min(pp, n_mu), at vpp > 1 the tables' n_stash_slots,
  in flight: `peak_stash`); B reruns the chunk forward with grad from
  the stash and back-propagates the received cotangent, as the
  reference's per-tick `jax.vjp` does — so under flash K1 runs twice
  per layer and microbatch. The reference runs both halves of every
  tick unmasked when an sp or ep axis puts collectives inside a stage
  (its collective schedule must match on every device); one controller
  has no such hazard, so inactive ticks are skipped there too, with
  the same values (ROADMAP Queue 3).
- **ZB-H1.** F, B and W follow `verify.zb_tables(n_mu, pp)`'s rounds.
  F stashes the blocks' residuals (`parallel.zb`), B walks dy -> dx
  with the head's and the embedding's own small vjps, W forms the
  dense weight gradients. Under flash, B replays K2 and K3 from the
  (o, lse) F stashed; K1 never runs again. The reference's carve-outs
  hold: ("dp", "pp") only, vpp 1, dense, no dropout, no remat.
- **The reduction.** Block leaves are summed over the data replicas
  (dp, and ep but for the expert leaves) in rank order; the replicated
  leaves also over pp (only the first and last stage add terms, both
  when the embeddings are tied), so every pp and model cell then
  updates its copy with the same gradient. ZeRO-1 and ZeRO-2 slice each
  leaf over dp on the first dimension its spec leaves free, FSDP rests
  the parameters so (`parallel.gspmd`'s update, clipping and health
  pack).
- **The pipelined decode** (`generate`): each cell keeps its own
  layers' K/V cache; a token makes pp vpp phases, chunks in logical
  order, and the last logical stage's hidden state returns to cell 0,
  which samples. Plain attention, as the reference's decode; a
  (dp, pp) or vpp layout only (no tp, sp or ep above 1), as in the
  reference.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.models.generate import (_block_decode, _embed,
                                                    prompt_bucket_len,
                                                    sample_rows)
from shallowspeed_tpu_torch.models.kv_cache import cache_write, init_kv_cache
from shallowspeed_tpu_torch.ops.attention import (attention, ring_attention,
                                                  ulysses_attention)
from shallowspeed_tpu_torch.ops.dropout import dropout as _dropout
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                        ring_flash_attention)
from shallowspeed_tpu_torch.parallel import zb as ZB
from shallowspeed_tpu_torch.parallel.gspmd import GSPMDEngine, P, with_axis
from shallowspeed_tpu_torch.parallel.verify import (interleaved_tables,
                                                    zb_tables)
from shallowspeed_tpu_torch.weights import leaves, map_tree

_SP_SUBSTRATES = ("ring", "ring-flash", "ulysses-flash")


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


def interleave_perm(n_layers: int, pp: int, vpp: int) -> np.ndarray:
    """The reference's placement permutation: stacked position d (vpp
    Lc) + v Lc + j holds layer (v pp + d) Lc + j, Lc = n_layers / (pp
    vpp); the identity at vpp 1."""
    lc = n_layers // (pp * vpp)
    return np.array([(v * pp + d) * lc + j for d in range(pp)
                     for v in range(vpp) for j in range(lc)])


def _take(x, idx):
    """x's rows `idx` along its first dimension (tensor or numpy)."""
    if isinstance(x, torch.Tensor):
        return x[torch.as_tensor(idx, device=x.device)]
    return np.asarray(x)[idx]


def _require(cond, msg) -> None:
    """The reference constructor's `assert`, as an AssertionError that
    python -O keeps."""
    if not cond:
        raise AssertionError(msg)


class _Stage:
    """Stage s of one data replica for one step: the cast compute
    tensors its cells hold — `layers` one tree per layer (at tp > 1 a
    list of the tp cells' trees; at ep > 1 each MoE layer's experts a
    list of the ep cells' shards), `top` the replicated leaves it reads
    — the f32 gradient sums `acc` and the attention substrate."""

    def __init__(self, s, device, attn_fn):
        self.s, self.device = s, device
        self.layers, self.top = [], {}
        self.attn_fn = attn_fn
        self.leaf_of = {}           # id(compute leaf) -> (leaf i, m, layer)
        self.acc = {}               # (leaf i, model index m) -> f32 block

    def add(self, i, m, j, g) -> None:
        """Add the gradient `g` of layer j (None: a replicated leaf) of
        leaf i on model index m into the stage's f32 sum."""
        a = self.acc[(i, m)]
        (a if j is None else a[j]).add_(g.float())


class PipelineLMEngine(GSPMDEngine):
    """Pipeline-parallel transformer trainer over a ("dp", "pp") or
    ("dp", "pp", X) grid, X one of "tp", "sp" and "ep"
    (`parallel.mesh.make_pipeline_mesh`): `schedule` "gpipe", "1f1b" or
    "zb", `virtual_pp` chunks per cell, `attn` "xla" (the plain
    attention) or "flash" (K1/K2/K3), and over an sp axis "ring",
    "ring-flash" or "ulysses-flash"; each data replica's rows cut into
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
        _require(attn in ("xla", "flash") + _SP_SUBSTRATES, attn)
        sizes = mesh.shape
        extra = names[2] if len(names) == 3 else None
        pp = sizes["pp"]
        tp, sp, ep = (sizes[a] if extra == a else 1
                      for a in ("tp", "sp", "ep"))
        if extra == "ep" and ep > 1:
            _require(cfg.n_experts > 0,
                     "an 'ep' mesh axis needs n_experts > 0")
            _require(cfg.n_experts % ep == 0,
                     f"n_experts={cfg.n_experts} must divide over ep={ep}")
            _require(attn in ("xla", "flash"),
                     f"ep composes with the xla/flash attention substrates "
                     f"(sequence stays whole inside the stage), got {attn!r}")
        if extra == "sp" and sp > 1:
            _require(attn in _SP_SUBSTRATES,
                     f"sp>1 needs a sequence-parallel attention substrate "
                     f"(ring / ring-flash / ulysses-flash), got {attn!r}")
        if attn in _SP_SUBSTRATES:
            _require(extra == "sp",
                     f"attn={attn!r} collects over an 'sp' mesh axis; this "
                     f"mesh is {names} (use attn='xla' or 'flash')")
        if attn == "ulysses-flash":
            _require(cfg.n_heads % sp == 0 and cfg.kv_heads % sp == 0,
                     "ulysses-flash needs head counts divisible by sp")
        _require(cfg.attn_dropout == 0.0,
                 "attention-probability dropout is not available in the "
                 "pipeline engine (plain-substrate only; see "
                 "TransformerConfig.attn_dropout)")
        _require(cfg.n_experts == 0 or extra != "tp",
                 "MoE x tp is not supported in the pipeline engine: the "
                 "Megatron placement has no expert-dimension rule, so tp "
                 "peers would each run the FULL routed FFN on identical "
                 "inputs — a correct program that silently wastes the tp "
                 "axis's FLOPs. Expert scaling is the ep axis's job (MoE "
                 "composes with dp/pp/sp here, dp/ep in parallel/expert.py)")
        if virtual_pp > 1:
            _require(sp == 1 and ep == 1,
                     "virtual_pp needs sp/ep-collective-free chunk bodies "
                     "(an sp ring / ep all-to-all inside a cond-gated chunk "
                     "de-syncs the collective schedule across branches; tp "
                     "composes — its psum peers share the gate predicate)")
            _require(cfg.n_layers % (pp * virtual_pp) == 0,
                     f"n_layers={cfg.n_layers} must divide over "
                     f"pp*virtual_pp={pp * virtual_pp}")
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
        if zero2 or fsdp:
            _require(extra != "ep",
                     "zero2/fsdp x pp support ('dp','pp'[,'tp'|'sp']) "
                     "meshes and virtual stages (no ep axis: expert-leaf "
                     "grads are ep-sharded, which the per-leaf ZeRO "
                     "dim/scatter rule does not describe)")
        self.schedule, self.attn = schedule, attn
        self.n_mu = n_mubatches
        self.pp, self.vpp = pp, virtual_pp
        self.depth = pp * virtual_pp
        self.l_local = cfg.n_layers // pp
        self.l_chunk = self.l_local // virtual_pp
        self._perm = interleave_perm(cfg.n_layers, pp, virtual_pp)
        self._inv_perm = np.argsort(self._perm)
        self.zero1, self.zero2, self.fsdp = zero1, zero2, fsdp
        self.peak_stash = 0
        super().__init__(cfg, optimizer, seed, mesh=mesh, zero1=zero1,
                         zero2=zero2, health=health, params=params)
        self.n_rep = self.dp * self.ep
        self._tables = (zb_tables(n_mubatches, pp) if schedule == "zb" else
                        interleaved_tables(n_mubatches, pp, virtual_pp)
                        if schedule == "1f1b" and virtual_pp > 1 else None)
        # each leaf's compute dtype, by `cast_params`' own rule
        self._cast_to = [m.dtype for m in leaves(
            T.cast_params(self._template, cfg.compute_dtype))]

    # ------------------------------------------------ GSPMD surface

    def validate(self, cfg, mesh) -> None:
        self.xaxis = mesh.axis_names[2] if len(mesh.axis_names) == 3 \
            else None
        if self.xaxis is not None:
            setattr(self, self.xaxis, mesh.shape[self.xaxis])

    def _layout(self, tree):
        tree = stack_blocks(tree)
        if self.vpp == 1:
            return tree
        return {**tree, "blocks": map_tree(lambda x: _take(x, self._perm),
                                           tree["blocks"])}

    def _canonical(self, tree):
        if self.vpp > 1:
            tree = {**tree, "blocks": map_tree(
                lambda x: _take(x, self._inv_perm), tree["blocks"])}
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
            if self.xaxis == "ep" and "moe" in blocks:
                bspec["moe"] = {"gate": P("pp"), **{
                    k: P("pp", "ep") for k in ("wi", "bi", "wo", "bo")}}
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
        each stage's (and model cell's) block, not the whole leaf. Under
        ZeRO / FSDP the reference's update is a GSPMD program over whole
        leaves, and so is this one."""
        return (self.optimizer.elementwise
                or not (self.zero or self.fsdp))

    def _substrates(self, r: int) -> list:
        """Replica r's attention per stage: over an sp axis the ring or
        all-to-all among the stage's sp cells."""
        w = self.cfg.attn_window
        fns = []
        for s in range(self.pp):
            cells = ([self._dev[(r, s, x)] for x in range(self.sp)]
                     if self.xaxis == "sp" else None)
            fns.append({
                "xla": partial(attention, causal=True, window=w),
                "flash": partial(flash_attention, causal=True, window=w),
                "ring": partial(ring_attention, devices=cells, causal=True,
                                window=w),
                "ring-flash": partial(ring_flash_attention, devices=cells,
                                      causal=True, window=w),
                "ulysses-flash": partial(ulysses_attention, devices=cells,
                                         causal=True, window=w,
                                         use_flash=True)}[self.attn])
        return fns

    # ------------------------------------------------------- cells

    def _pcell(self, q: int, s: int, m: int | None = None) -> tuple:
        """The cell of data replica q's stage s at model index m (default
        the replica's own: its ep coordinate, else 0)."""
        r, e = divmod(q, self.ep)
        if self.xaxis is None:
            return (r, s)
        return (r, s, e if m is None else m)

    def _model_index(self, i: int, q: int, m: int | None) -> int:
        """The model index replica q reads leaf i at: m where the grid's
        third axis cuts the leaf, else the replica's own."""
        if m is not None and self.xaxis in self._pspecs[i].axes():
            return m
        return q % self.ep

    def _leaf_block(self, i: int, q: int, s: int, m: int | None = None):
        """Leaf i's block as data replica q's stage s reads it at model
        index m: its cell's block, or under FSDP the dp pieces gathered
        onto that cell."""
        spec = self._pspecs[i]
        c = self._pcell(q, s, self._model_index(i, q, m))
        if "dp" not in spec.axes():
            return self._shards[c][i]
        z = spec.padded(len(self._shapes[i])).index("dp")
        return torch.cat([self._shards[(j,) + c[1:]][i].to(self._dev[c])
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

    def _cast_block(self, i: int, q: int, s: int, m: int | None = None):
        """Leaf i's block at data replica q's stage s (model index m),
        cast to the compute dtype as `transformer.cast_params` casts
        it."""
        return self._leaf_block(i, q, s, m).to(self._cast_to[i])

    @torch.no_grad()
    def _stage(self, q: int, s: int, grad: bool, sums: bool = True
               ) -> _Stage:
        """Stage s of data replica q for this step: per layer (and model
        cell) detached aliases of the cast blocks, with requires_grad
        when `grad`; a leaf the model axis does not cut is one alias for
        every model cell. With `sums`, a zero f32 gradient sum per block
        it reads."""
        idx = self._index
        st = _Stage(s, self._dev[self._pcell(q, s)],
                    self._attn_fns[q // self.ep][s])
        blocks, aliases = {}, {}

        def alias(i, m, j):
            m = self._model_index(i, q, m)
            a = aliases.get((i, m, j))
            if a is None:
                b = blocks.get((i, m))
                if b is None:
                    b = blocks[(i, m)] = self._cast_block(i, q, s, m)
                    if sums:
                        st.acc[(i, m)] = torch.zeros(
                            b.shape, dtype=torch.float32, device=b.device)
                a = b if j is None else b[j]
                a = a.detach().requires_grad_(grad)
                aliases[(i, m, j)] = a
                st.leaf_of[id(a)] = (i, m, j)
            return a

        def layer(j):
            if self.tp > 1:
                return [map_tree(lambda i, t=t: alias(i, t, j),
                                 idx["blocks"]) for t in range(self.tp)]
            tree = map_tree(lambda i: alias(i, None, j), idx["blocks"])
            if "moe" in tree and self.ep > 1:
                im = idx["blocks"]["moe"]
                tree["moe"] = {"gate": tree["moe"]["gate"], "experts": [
                    {k: alias(im[k], c, j) for k in ("wi", "bi", "wo", "bo")}
                    for c in range(self.ep)]}
            return tree

        st.layers = [layer(j) for j in range(self.l_local)]
        for name in self._top_names(s):
            st.top[name] = map_tree(lambda i: alias(i, None, None),
                                    idx[name])
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
                i, m, j = st.leaf_of[id(x)]
                st.add(i, m, j, g)

    # ------------------------------------------------------- forward

    def _keys(self, q: int, m: int, s: int, v: int = 0):
        """(stage key, embedding key) of microbatch m of data replica q
        at chunk v of stage s: one key a step, folded with (m, r) and at
        ep > 1 the replica's ep coordinate, then with s (or pp for the
        embedding), and at vpp > 1 with v, as the reference's `mu_key`
        derives them; at sp > 1 a tuple of per-tile keys. The blocks
        fold their layer index in. (None, None) without dropout."""
        if self.cfg.dropout == 0.0:
            return None, None
        r, e = divmod(q, self.ep)
        k = fold_key(fold_key(self.seed, self._step_count), m, r)
        if self.ep > 1:
            k = fold_key(k, e)
        if self.sp > 1:
            k = tuple(fold_key(k, tile) for tile in range(self.sp))
        k_stage = fold_key(k, s)
        if self.vpp > 1:
            k_stage = fold_key(k_stage, v)
        return k_stage, fold_key(k, self.pp)

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
        """The token loss of a microbatch: the mean NLL, at sp > 1 the
        sum of its tiles' means in tile order."""
        cfg = self.cfg

        def nll(h, g):
            if cfg.xent_chunk > 0:
                return T.chunked_token_loss(top, h, g, cfg, train)
            return T.token_loss(T.head_logits(top, h, cfg), g, cfg, train)

        if self.sp == 1:
            return nll(hf, tgt)
        total = None
        for h, g in zip(hf.chunk(self.sp, dim=1), tgt.chunk(self.sp, dim=1)):
            part = nll(h, g)
            total = part if total is None else total + part
        return total

    def _stage_fwd(self, st: _Stage, x_in, tok, tgt, keys, v: int = 0,
                   train: bool = True):
        """Chunk v of one stage on one microbatch (the stage's layers at
        vpp 1): (h, its objective term — the NLL on the last logical
        stage plus, for MoE, its blocks' weighted balance and z-losses —
        or None)."""
        cfg = self.cfg
        ls = v * self.pp + st.s
        k_stage, k_emb = keys
        x = self._embed(st, tok, k_emb) if ls == 0 else x_in
        pos = torch.arange(x.shape[1], device=x.device)
        attn = [st.attn_fn] * self.tp if self.tp > 1 else st.attn_fn
        block = self._block_fn()
        # a MoE layer routes each sp tile as its own sequence
        tiles = ({"moe_tiles": self.sp}
                 if self.sp > 1 and cfg.n_experts > 0 else {})
        obj = None
        for j in range(self.l_chunk):
            k = None if k_stage is None else fold_key(k_stage, j)
            x, (aux, z, stats) = block(st.layers[v * self.l_chunk + j], x,
                                       cfg, pos, attn, k, **tiles)
            if stats is not None:
                w = cfg.moe_aux_weight * aux + cfg.moe_z_weight * z
                obj = w if obj is None else obj + w
        if ls == self.depth - 1:
            nll = self._head_nll(st.top, T._norm(st.top["ln_f"], x, cfg),
                                 tgt, train)
            obj = nll if obj is None else nll + obj
        return x, obj

    def _split(self, tokens, targets):
        """Each data replica's microbatches [(tok, tgt)] on its stage-0
        cell, as the reference's `_split_mu` cuts a batch: rows over dp x
        ep (dp-major), each replica's rows over the microbatches."""
        tok, tgt = (self.place(tokens), self.place(targets))
        b, t = tok.shape
        n = self.n_rep
        _require(b % (n * self.n_mu) == 0,
                 f"batch {b} must divide over dp*ep={n} x "
                 f"n_mubatches={self.n_mu}")
        _require(t % self.sp == 0,
                 f"sequence length {t} must divide over sp={self.sp}")
        out = []
        for q, (a, c) in enumerate(zip(tok.chunk(n), tgt.chunk(n))):
            dev = self._dev[self._pcell(q, 0)]
            out.append(list(zip(a.to(dev).chunk(self.n_mu),
                                c.to(dev).chunk(self.n_mu))))
        return out

    def _to(self, x, s: int, q: int):
        return None if x is None else x.to(self._dev[self._pcell(q, s)])

    def _add_loss(self, loss, obj):
        if obj is None:
            return loss
        obj = obj.detach().to(self.device)
        return obj if loss is None else loss + obj

    # ----------------------------------------------------- schedules

    def _gpipe(self, q: int, mus, stages):
        """GPipe over the logical stages: every forward tick, then every
        backward tick in reverse. Returns the replica's summed
        objective."""
        pp, n_mu, depth = self.pp, self.n_mu, self.depth
        saved = {}
        loss = None
        with torch.enable_grad():
            for tk in range(n_mu + depth - 1):
                for ls in range(depth):
                    m = tk - ls
                    if not 0 <= m < n_mu:
                        continue
                    st, v = stages[ls % pp], ls // pp
                    x_in = None
                    if ls > 0:
                        x_in = saved[(ls - 1, m)][1].detach().to(
                            st.device).requires_grad_(True)
                    tok, tgt = mus[m]
                    h, obj = self._stage_fwd(
                        st, x_in, self._to(tok, st.s, q),
                        self._to(tgt, st.s, q), self._keys(q, m, st.s, v), v)
                    saved[(ls, m)] = (x_in, h, obj)
                    loss = self._add_loss(loss, obj)
        self.peak_stash = max(self.peak_stash, n_mu * self.vpp)
        dx = {}
        for tk in reversed(range(n_mu + depth - 1)):
            for ls in reversed(range(depth)):
                m = tk - ls
                if not 0 <= m < n_mu:
                    continue
                x_in, h, obj = saved.pop((ls, m))
                g = self._backward(stages[ls % pp], x_in, h, obj,
                                   dx.pop((ls, m), None))
                if g is not None:
                    dx[(ls - 1, m)] = self._to(g, (ls - 1) % pp, q)
        return loss

    def _backward(self, st: _Stage, x_in, h, obj, dh):
        """Back-propagate one (chunk, microbatch): its objective term
        seeded with 1 / (n_mu sp), its output with the cotangent `dh`
        from the next logical stage (None on the last); the parameter
        gradients go into the stage's f32 sums. Returns the input's
        cotangent (None on logical stage 0), the previous stage's to
        take."""
        ins = self._stage_inputs(st)
        first = [x_in] if x_in is not None else []
        outs, seeds = [], []
        if dh is not None:
            outs.append(h)
            seeds.append(dh)
        if obj is not None:
            outs.append(obj)
            seeds.append(torch.full_like(obj, 1.0 / (self.n_mu * self.sp)))
        gs = torch.autograd.grad(outs, first + ins, seeds, allow_unused=True)
        self._accumulate(st, ins, gs[len(first):])
        return gs[0] if first else None

    def _f_half(self, q, st, v, m, mus, x_in):
        """1F1B's F: chunk v of stage st on microbatch m without a
        graph. Returns (h, objective term)."""
        tok, tgt = mus[m]
        with torch.no_grad():
            return self._stage_fwd(st, x_in, self._to(tok, st.s, q),
                                   self._to(tgt, st.s, q),
                                   self._keys(q, m, st.s, v), v)

    def _b_half(self, q, st, v, m, mus, x_saved, dh):
        """1F1B's B: chunk v rerun with grad from its stashed input, then
        back-propagated. Returns the input's cotangent."""
        tok, tgt = mus[m]
        with torch.enable_grad():
            x_in = (None if x_saved is None
                    else x_saved.detach().requires_grad_(True))
            h, obj = self._stage_fwd(st, x_in, self._to(tok, st.s, q),
                                     self._to(tgt, st.s, q),
                                     self._keys(q, m, st.s, v), v)
            return self._backward(st, x_in, h, obj, dh)

    def _1f1b(self, q: int, mus, stages):
        """PipeDream-Flush over 2 (n_mu + pp - 1) ticks (vpp 1)."""
        pp, n_mu = self.pp, self.n_mu
        x_msg, g_msg = {}, {}
        stash = [dict() for _ in range(pp)]
        loss = None
        for tk in range(2 * (n_mu + pp - 1)):
            for s in range(pp):
                f_rel = tk - s
                if 0 <= f_rel < 2 * n_mu and f_rel % 2 == 0:
                    m = f_rel // 2
                    x_in = x_msg.pop((s, m)) if s > 0 else None
                    h, obj = self._f_half(q, stages[s], 0, m, mus, x_in)
                    stash[s][m] = x_in
                    self.peak_stash = max(self.peak_stash, len(stash[s]))
                    loss = self._add_loss(loss, obj)
                    if s < pp - 1:
                        x_msg[(s + 1, m)] = self._to(h, s + 1, q)
                b_rel = tk - (2 * pp - 1 - s)
                if 0 <= b_rel < 2 * n_mu and b_rel % 2 == 0:
                    m = b_rel // 2
                    dx = self._b_half(q, stages[s], 0, m, mus,
                                      stash[s].pop(m),
                                      g_msg.pop((s, m), None))
                    if dx is not None:
                        g_msg[(s - 1, m)] = self._to(dx, s - 1, q)
        return loss

    def _1f1b_virtual(self, q: int, mus, stages):
        """Interleaved PipeDream-Flush: each cell runs the op, chunk and
        microbatch `verify.interleaved_tables` gives it in each round."""
        tb, pp, depth = self._tables, self.pp, self.depth
        x_msg, g_msg = {}, {}
        stash = [dict() for _ in range(pp)]
        loss = None
        for rnd in range(tb.n_rounds):
            for d in range(pp):
                op = int(tb.op[rnd, d])
                if op == 0:
                    continue
                v, m = int(tb.chunk[rnd, d]), int(tb.mu[rnd, d])
                ls = v * pp + d
                if op == 1:                                       # F
                    x_in = x_msg.pop((ls, m)) if ls > 0 else None
                    h, obj = self._f_half(q, stages[d], v, m, mus, x_in)
                    stash[d][(ls, m)] = x_in
                    self.peak_stash = max(self.peak_stash, len(stash[d]))
                    loss = self._add_loss(loss, obj)
                    if ls < depth - 1:
                        x_msg[(ls + 1, m)] = self._to(h, (ls + 1) % pp, q)
                else:                                             # B
                    dx = self._b_half(q, stages[d], v, m, mus,
                                      stash[d].pop((ls, m)),
                                      g_msg.pop((ls, m), None))
                    if dx is not None:
                        g_msg[(ls - 1, m)] = self._to(dx, (ls - 1) % pp, q)
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
        gradient} as `GSPMDEngine._reduced` gives it: each data
        replica's schedule run on its stages, the stage sums reduced
        over the data replicas (block leaves) and pp (the replicated
        leaves) in rank order and scaled by 1 / (dp ep)."""
        run = {"gpipe": self._gpipe,
               "1f1b": self._1f1b_virtual if self.vpp > 1 else self._1f1b,
               "zb": self._zb}[self.schedule]
        red = [dict() for _ in self._pspecs]
        total = None
        for q, mus in enumerate(self._split(tokens, targets)):
            stages = [self._stage(q, s, grad=self.schedule != "zb")
                      for s in range(self.pp)]
            loss = run(q, mus, stages).detach().to(self.device)
            total = loss if total is None else total + loss
            for st in stages:
                for (i, m), g in sorted(st.acc.items()):
                    self._reduce_into(red, i, q, st.s, m, g)
            del stages
        total = total / (self.n_mu * self.n_rep * self.sp)
        if self.n_rep > 1:
            for blocks in red:
                for g in blocks.values():
                    g.mul_(1.0 / self.n_rep)
        return total, [dict(sorted(b.items())) for b in red]

    def _reduce_into(self, red, i, q, s, m, g) -> None:
        us = self._uspecs[i]
        coord = {"dp": q // self.ep, "pp": s}
        if self.xaxis is not None:
            coord[self.xaxis] = m
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
        """The mean objective without label smoothing or dropout (the
        MoE balance and z-losses included, as the reference's), no
        update."""
        total = None
        for q, mus in enumerate(self._split(tokens, targets)):
            stages = [self._stage(q, s, grad=False, sums=False)
                      for s in range(self.pp)]
            for tok, tgt in mus:
                x = None
                for ls in range(self.depth):
                    st = stages[ls % self.pp]
                    x, obj = self._stage_fwd(
                        st, self._to(x, st.s, q), self._to(tok, st.s, q),
                        self._to(tgt, st.s, q), (None, None), ls // self.pp,
                        train=False)
                    total = self._add_loss(total, obj)
        return float(total / (self.n_mu * self.n_rep * self.sp))

    def logits(self, tokens):
        raise NotImplementedError(
            "PipelineLMEngine has no logits(); the reference's has none "
            "either (get_canonical_params() feeds the one-device forward)")

    def router_stats(self, tokens):
        raise NotImplementedError(
            "PipelineLMEngine has no router_stats(); the reference's has "
            "none either")

    # ------------------------------------------------ pipelined decode

    @torch.no_grad()
    def generate(self, prompt, max_new: int, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0,
                 seed: int = 0) -> np.ndarray:
        """`max_new` tokens after `prompt` (B, Tp) on the pp-cut
        parameters: each cell keeps its own layers' K/V cache, a token
        makes pp vpp phases, cell 0 samples. Returns (B, max_new) int32.
        Row b samples with seed + b as `models.generate.generate` does,
        so the streams equal its streams at any dp."""
        cfg = self.cfg
        _require(self.tp == 1 and self.sp == 1 and self.ep == 1,
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
        cfg, pp, lc = self.cfg, self.pp, self.l_chunk
        stages = [self._stage(r, s, grad=False, sums=False)
                  for s in range(pp)]
        # cell 0 embeds and samples with its own copies
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
        # the logical stages in order: (cell's stage, its layer indices)
        chain = [(stages[ls % pp], range((ls // pp) * lc, (ls // pp + 1) * lc))
                 for ls in range(self.depth)]

        def sample(x, i):
            hf = T._norm(top["ln_f"], x.to(dev0), cfg)
            logits = T.head_logits(top, hf, cfg).float()
            return sample_rows(logits, temp, seeds, [i] * b, top_k, top_p)

        x = _embed(top, tokens, 0, cfg)
        pos = torch.arange(tp_b, device=dev0)
        for st, js in chain:
            x = x.to(st.device)
            for j in js:
                x, _, (k, v) = T._block(st.layers[j], x, cfg,
                                        pos.to(st.device), attn,
                                        with_kv=True)
                cache_write(caches[st.s][j], k, v, 0)
        out = np.zeros((b, max_new), np.int32)
        out[:, 0] = sample(x[:, tp_len - 1], 0)
        for i in range(1, max_new):
            p = tp_len + i - 1
            tok = torch.from_numpy(out[:, i - 1]).to(dev0, torch.long)
            x = _embed(top, tok[:, None], p, cfg)
            for st, js in chain:
                x = x.to(st.device)
                for j in js:
                    x = _block_decode(st.layers[j], x, cfg, caches[st.s][j],
                                      p)
            out[:, i] = sample(x[:, 0], i)
        return out

    # -------------------------------------------- checkpoint interface

    def canon_export_tree(self, tree):
        """A params-shaped tree in the engine's layout (e.g. Adam's
        moments) -> the canonical layout, the transform params take into
        a checkpoint (the stack undone, through the inverse interleave
        permutation at vpp > 1)."""
        return self._canonical(tree)

    def canon_import_tree(self, tree):
        """Inverse of `canon_export_tree` (numpy or tensors)."""
        return self._layout(tree)
