"""The port's CUDA kernels on the card, against their plain torch
versions. Every test here carries the `cuda` marker and skips without
a GPU. This file imports neither jax nor the JAX package, so it also
runs on a GPU machine without JAX:

    pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from shallowspeed_tpu_torch.ops import flash_attention as FA


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kvh,window", [(16, 0), (4, 0), (16, 100)],
                         ids=["mha", "gqa", "window"])
def test_cuda_kernel_matches_plain_version(cuda, dtype, tol, kvh, window):
    """The kernel on the card against its plain version at the serving
    shapes (f32: summation order only; bf16: the output is rounded once
    and the plain version rounds P before PV)."""
    rng = np.random.default_rng(kvh + window)
    s, h, hd, bs, w = 8, 16, 128, 16, 64
    n = s * w + 1
    bt = torch.from_numpy(rng.permutation(np.arange(1, n)).reshape(s, w)
                          .astype(np.int32)).to(cuda)
    pos = torch.from_numpy(rng.integers(0, w * bs, s).astype(np.int32)
                           ).to(cuda)
    pool = {"k": torch.randn(n, kvh, bs, hd, device=cuda).to(dtype),
            "v": torch.randn(n, kvh, bs, hd, device=cuda).to(dtype)}
    q = torch.randn(s, h, hd, device=cuda).to(dtype)
    before = FA.paged_flash_decode.launches
    got = FA.paged_flash_decode(q, pool, bt, pos, window=window).float()
    ref = FA.paged_flash_decode_reference(q, pool, bt, pos,
                                          window=window).float()
    assert FA.paged_flash_decode.launches == before + 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol
