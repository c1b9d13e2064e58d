"""Single-device LM trainer — the dp = 1, sp = 1 counterpart of
`shallowspeed_tpu/parallel/context.py::ContextParallelEngine`.

It holds the f32 master parameters (`init(cfg, seed)`, the reference's
draw) and the optimizer state; each step runs `transformer.loss` with
torch autograd (the forward casts to `cfg.compute_dtype` as
`cast_params` does, and the gradients come back to the f32 masters
through that cast), then the optimizer's in-place update. `attn`
selects the attention substrate:

- "flash": `ops.flash_attention.flash_attention` — the hand-written
  K1/K2/K3 CUDA kernels on the card, their plain versions on the CPU;
- "ring": the plain `ops.attention.attention` under torch autograd,
  which is what the reference's ring substrate computes at sp = 1 (and
  the only substrate that takes cfg.attn_dropout).

`accum > 1` splits each batch's rows into that many microbatches, each
with its own forward and backward (one microbatch's activations alive
at a time); the f32 gradients are summed and scaled by 1 / accum and
the reported loss is the microbatches' mean, as the reference's scan
computes them. The config's dropout draws its masks from keys derived
from (seed, step, microbatch) (`ops.dropout.fold_key`).

With `health` "monitor" or "guard" each step also computes the health
pack (`telemetry/health.py`) on the step's gradients; under "guard"
the update is gated on its `nonfinite == 0` (`guarded_step`). ZeRO,
comm overlap and every multi-device mesh are not ported yet and raise
`NotPorted`.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from shallowspeed_tpu_torch import NotPorted, resolve_device
from shallowspeed_tpu_torch.models import transformer as T
from shallowspeed_tpu_torch.ops.attention import attention
from shallowspeed_tpu_torch.ops.dropout import fold_key
from shallowspeed_tpu_torch.ops.flash_attention import flash_attention
from shallowspeed_tpu_torch.telemetry.health import (check_mode,
                                                     engine_snapshot,
                                                     note_step,
                                                     step_with_health)
from shallowspeed_tpu_torch.weights import (leaves, map_tree,
                                            params_from_numpy, placed_copy,
                                            unflatten)

_LATER = "Queue 1, multi-device LM engines"


class ContextParallelEngine:
    """One-device trainer for the transformer LM family. `params`, when
    given, is a numpy tree to start from instead of drawing
    `init(cfg, seed)` again (a caller that already holds the draw)."""

    # params and optimizer state are already in the checkpoint's
    # canonical (one-device) layout, as the reference's engine declares
    canonical_opt_identity = True

    def __init__(self, cfg: T.TransformerConfig, optimizer, seed: int = 0,
                 attn: str = "flash", device=None, *, accum: int = 1,
                 zero1: bool = False, zero2: bool = False,
                 health: str = "off", overlap=None, params=None):
        if accum < 1:
            raise ValueError(f"accum must be >= 1, got {accum}")
        if zero1 or zero2:
            raise NotPorted("ZeRO-1/2 optimizer sharding", _LATER)
        check_mode(health)
        if overlap is not None:
            raise NotPorted("communication overlap", _LATER)
        if attn not in ("flash", "ring"):
            raise NotPorted(f"attn={attn!r} (sequence-parallel substrates)",
                            _LATER)
        if cfg.attn_dropout > 0.0 and attn != "ring":
            raise ValueError(
                "cfg.attn_dropout needs the plain attention substrate "
                "(sp=1, --attn ring); fused substrates cannot mask "
                "probabilities")
        self.cfg = cfg
        self.optimizer = optimizer
        self.health = health
        self.last_health = None
        self.accum = accum
        self.seed = seed
        self.device = resolve_device(device)
        fn = flash_attention if attn == "flash" else attention
        self.attn_fn = partial(fn, causal=True, window=cfg.attn_window)
        self.params = params_from_numpy(
            T.init_numpy(cfg, seed) if params is None else params,
            self.device)
        for p in leaves(self.params):
            p.requires_grad_(True)
        self.opt_state = optimizer.init(self.params)
        self._step_count = 0

    def place(self, arr) -> torch.Tensor:
        """A (B, T) token batch (numpy, or a tensor a prefetcher already
        placed) as int64 on the engine's device."""
        t = (arr if isinstance(arr, torch.Tensor)
             else torch.as_tensor(np.asarray(arr))).to(self.device,
                                                       torch.long)
        if t.dim() != 2 or t.shape[1] > self.cfg.max_seq:
            raise ValueError(f"token batch {tuple(t.shape)} must be (B, T) "
                             f"with T <= max_seq={self.cfg.max_seq}")
        return t

    def dropout_key(self, microbatch: int = 0):
        """The dropout key of this step's `microbatch` (None when the
        config has no dropout): a pure function of (seed, step,
        microbatch), so a resumed run draws the same masks."""
        if self.cfg.dropout == 0.0 and self.cfg.attn_dropout == 0.0:
            return None
        return fold_key(self.seed, self._step_count, microbatch)

    def loss_and_grads(self, tokens, targets):
        """(loss, gradient tree) of one (B, T) batch at the current
        parameters, without updating them: `accum` microbatches of B /
        accum rows, each its own forward and backward, the f32
        gradients summed and scaled by 1 / accum, the loss their
        mean."""
        tok, tgt = self.place(tokens), self.place(targets)
        b = tok.shape[0]
        if b % self.accum:
            raise ValueError(
                f"--accum {self.accum} must divide the per-device batch "
                f"rows ({b} here = batch / dp; sp shards the sequence "
                f"dim, not rows)")
        flat = list(leaves(self.params))
        loss_sum, gsum = None, None
        for mu, (tok_mu, tgt_mu) in enumerate(zip(tok.chunk(self.accum),
                                                  tgt.chunk(self.accum))):
            with torch.enable_grad():
                loss = T.loss(self.params, tok_mu, tgt_mu, self.cfg,
                              attn_fn=self.attn_fn,
                              dropout_key=self.dropout_key(mu))
                # unused leaves (pos_emb under rope, norm biases under
                # rmsnorm) get zero gradients, as jax.grad gives them
                grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                            materialize_grads=True)
            loss = loss.detach()
            if gsum is None:
                loss_sum, gsum = loss, [g.float() for g in grads]
            else:
                loss_sum = loss_sum + loss
                for acc, g in zip(gsum, grads):
                    acc.add_(g)
            del grads
        if self.accum > 1:
            loss_sum = loss_sum / self.accum
            for acc in gsum:
                acc.mul_(1.0 / self.accum)
        return loss_sum, unflatten(self.params, gsum)

    def train_batch(self, tokens, targets) -> float:
        """One optimizer step on a (B, T) int token batch; returns the
        loss before the update."""
        loss, grads = self.loss_and_grads(tokens, targets)
        if self.health == "off":
            self.params, self.opt_state = self.optimizer.step(
                self.params, grads, self.opt_state)
        else:
            self.params, self.opt_state, pack = step_with_health(
                self.optimizer, self.params, grads, self.opt_state,
                self.health)
            note_step(self, pack)
        self._step_count += 1
        return float(loss)

    def health_snapshot(self) -> dict | None:
        """The last step's health pack and the cumulative counters as a
        host dict (call at log points); None before the first step or
        with health='off'."""
        return engine_snapshot(self)

    @torch.no_grad()
    def eval_loss(self, tokens, targets) -> float:
        """Plain NLL (no label smoothing) of a batch, no update."""
        return float(T.loss(self.params, self.place(tokens),
                            self.place(targets), self.cfg,
                            attn_fn=self.attn_fn, train=False))

    @torch.no_grad()
    def logits(self, tokens) -> torch.Tensor:
        return T.forward(self.params, self.place(tokens), self.cfg,
                         attn_fn=self.attn_fn)

    # -------------------------------------------- checkpoint interface

    def get_canonical_params(self):
        return self.params

    def set_canonical_params(self, params):
        """Replace the parameters by a tree of tensors or numpy arrays
        (the JAX package's layout) of the same structure. The new tree
        keeps the current one's key order (a checkpoint's dicts come
        back key-sorted), which the optimizer's and the gradient
        clipping's leaf order follow."""
        def conv(_, x):
            t = (x.detach() if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(x)))
            return t.to(self.device, copy=True).requires_grad_(True)

        self.params = map_tree(conv, self.params, params)

    def set_opt_state(self, state):
        """Install an optimizer state in the JAX package's layout (numpy
        leaves, `t` a 0-d int32 array, as a checkpoint holds it) or this
        package's: leaves placed on the engine's device, `t` a Python
        int, in the current state's key order."""
        if isinstance(state, (dict, list, tuple)) and any(
                isinstance(x, np.ndarray) for x in leaves(state)):
            state = placed_copy(state, self.device)
        self.opt_state = map_tree(lambda _, x: x, self.opt_state, state)
