"""Pure stateless ops of the MLP path, with hand-written VJPs —
counterpart of `shallowspeed_tpu/ops/functional.py`.

Plain functions on tensors. The reference computes this layer with
`jax.numpy` (no Pallas kernel), so here each op is a torch call; the
hand-written gradients are kept because they define the MLP's manual
backward (no autograd), term for term in the reference's order.

Numerics kept from the reference:
- `softmax` subtracts the *global* max of the block (not per-row) and
  adds 1e-7 to the denominator. A block is one replica's microbatch, so
  callers must never concatenate replicas before it.
- `mse_loss` / `mse_loss_grad` divide by the caller-supplied **global**
  batch size, which makes the sum over microbatches and over DP
  replicas equal the serial global-batch gradient.
"""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0)."""
    return torch.clamp_min(x, 0.0)


def relu_grad(dout: torch.Tensor, bitmask: torch.Tensor) -> torch.Tensor:
    """VJP of relu given the cached `x > 0` bitmask."""
    return dout * bitmask


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """y = x @ W.T + b, weight (out_dims, in_dims), bias (1, out_dims);
    one GEMM with the bias as its addend."""
    return torch.addmm(bias, x, weight.T)


def linear_grad(dout: torch.Tensor, x: torch.Tensor, weight: torch.Tensor):
    """VJP of `linear`: returns (dx, dW, db)."""
    return dout @ weight, dout.T @ x, dout.sum(dim=0, keepdim=True)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Row softmax with the block's global max-shift and a 1e-7
    denominator epsilon."""
    shifted = torch.exp(x - torch.max(x))
    return shifted / (shifted.sum(dim=1, keepdim=True) + 1e-7)


def softmax_grad(dout: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """VJP of `softmax`, recomputed from the cached *input*."""
    out = softmax(x)
    g = out * dout
    return g - out * g.sum(dim=-1, keepdim=True)


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             batch_size: int) -> torch.Tensor:
    """Sum of squared errors divided by the *global* batch size."""
    assert pred.shape == target.shape, (pred.shape, target.shape)
    return ((target - pred) ** 2).sum() / batch_size


def mse_loss_grad(pred: torch.Tensor, target: torch.Tensor,
                  batch_size: int) -> torch.Tensor:
    """d/dpred of `mse_loss` (global batch size, so microbatch and
    replica sums give the serial global-batch gradient)."""
    return -2.0 * (target - pred) / batch_size
