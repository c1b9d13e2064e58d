"""Dataset with strided DP sharding and microbatch slicing — the MLP
path's L0. A copy of `shallowspeed_tpu/data/dataset.py` (the port
imports nothing of the JAX package), numpy only, so both packages cut
the same batches from the same files:

- drop-last to a multiple of the **global** batch size;
- **strided** DP shard `input_X[rank:end:size].copy()` (the copy keeps
  shards C-contiguous);
- microbatch slicing by `(batch_id, mubatch_id)` offsets into the
  local shard;
- `load_mubatch_stack` / `stack_epoch` return whole (n_mu, mubs, d) /
  (n_batches, dp, n_mu, mubs, d) stacks, so an engine places a batch,
  or a whole epoch, on the device in one copy;
- `load_batch` is the fault plan's data-loader point
  (`chaos.on_data_load`, by batch id), as in the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from shallowspeed_tpu_torch import chaos


class Dataset:
    """One DP rank's view of the on-disk dataset.

    `Dataset(save_dir, global_batch_size, mubatch_size, validation=False)`
    then `.load(DP_rank, DP_size)` (returns self).
    """

    def __init__(self, save_dir, global_batch_size: int, mubatch_size: int,
                 validation: bool = False):
        self.save_dir = Path(save_dir)
        self.global_batch_size = global_batch_size
        self.mubatch_size = mubatch_size
        self.validation = validation
        self.input_X: np.ndarray | None = None
        self.target_Y: np.ndarray | None = None
        self._local_bs: int | None = None

    # ---------------------------------------------------------------- load

    def load(self, DP_rank: int, DP_size: int) -> "Dataset":
        assert self.global_batch_size % DP_size == 0, (
            f"global batch {self.global_batch_size} not divisible by "
            f"DP={DP_size}")
        local_bs = self.global_batch_size // DP_size
        assert local_bs % self.mubatch_size == 0, (
            f"local batch {local_bs} not divisible by microbatch "
            f"{self.mubatch_size}")
        self._local_bs = local_bs

        split = "val" if self.validation else "train"
        x = np.load(self.save_dir / f"x_{split}.npy").astype(np.float32)
        y = np.load(self.save_dir / f"y_{split}.npy").astype(np.float32)

        # drop-last to a multiple of the global batch
        n_full = len(x) - (len(x) % self.global_batch_size)
        # strided shard; .copy() for contiguity
        self.input_X = x[DP_rank:n_full:DP_size].copy()
        self.target_Y = y[DP_rank:n_full:DP_size].copy()
        return self

    # ------------------------------------------------------------- queries

    def __len__(self) -> int:
        assert self.input_X is not None, "call .load() first"
        return len(self.input_X)

    def get_num_batches(self) -> int:
        return len(self) // self._local_bs

    def get_num_mubatches(self) -> int:
        return self._local_bs // self.mubatch_size

    # ------------------------------------------------------------- slicing

    def _mubatch_slice(self, batch_id: int, mubatch_id: int) -> slice:
        start = batch_id * self._local_bs + mubatch_id * self.mubatch_size
        return slice(start, start + self.mubatch_size)

    def load_micro_batch_input(self, batch_id: int, mubatch_id: int) -> np.ndarray:
        return self.input_X[self._mubatch_slice(batch_id, mubatch_id)]

    def load_micro_batch_target(self, batch_id: int, mubatch_id: int) -> np.ndarray:
        return self.target_Y[self._mubatch_slice(batch_id, mubatch_id)]

    def load_batch(self, batch_id: int) -> tuple[np.ndarray, np.ndarray]:
        """The whole local batch: (local_bs, 784), (local_bs, 10)."""
        # a chaos stall fault sleeps here (once a plan): a wedged loader
        # must show in the goodput ledger and the hang detection
        chaos.on_data_load(batch_id)
        s = slice(batch_id * self._local_bs, (batch_id + 1) * self._local_bs)
        return self.input_X[s], self.target_Y[s]

    def load_mubatch_stack(self, batch_id: int) -> tuple[np.ndarray, np.ndarray]:
        """(n_mu, mubs, d_in), (n_mu, mubs, d_out) — one copy per batch."""
        x, y = self.load_batch(batch_id)
        n_mu = self.get_num_mubatches()
        return (x.reshape(n_mu, self.mubatch_size, -1),
                y.reshape(n_mu, self.mubatch_size, -1))


def stack_epoch(datasets: list[Dataset], n_batches: int | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Stack an epoch across DP shards: (n_batches, dp, n_mu, mubs, d),
    so the engines place the whole epoch on the device in one copy."""
    if n_batches is None:
        n_batches = datasets[0].get_num_batches()
    xs, ys = [], []
    for b in range(n_batches):
        stacks = [ds.load_mubatch_stack(b) for ds in datasets]
        xs.append(np.stack([s[0] for s in stacks]))
        ys.append(np.stack([s[1] for s in stacks]))
    return np.stack(xs), np.stack(ys)
