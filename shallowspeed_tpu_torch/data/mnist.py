"""MNIST-784 preparation for the MLP path — a copy of
`shallowspeed_tpu/data/mnist.py` (the port imports nothing of the JAX
package): the same deterministic synthetic MNIST-784 and the same
shuffle and 85/15 train/val split, so both packages write the same
bytes from the same settings.

The one divergence: the reference tries the OpenML fetch first and
falls back to the synthetic set; this copy never fetches. The hosts
the port runs on have no network, and a run must never wait on one.
`prepare_mnist(synthetic=None)` and `ensure_mnist` synthesize, and
`synthetic=False` (OpenML only) raises.

Files written (the reference's npy layout):
    x_train.npy  (n_train, 784) float32
    y_train.npy  (n_train, 10)  float32 one-hot
    x_val.npy    (n_val, 784)   float32
    y_val.npy    (n_val, 10)    float32 one-hot
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FILES = ("x_train.npy", "y_train.npy", "x_val.npy", "y_val.npy")
VAL_FRACTION = 0.15


def synthesize_mnist(n_samples: int = 70000) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic MNIST-784: (x (n,784) f32, y (n,10) one-hot f32).

    Class prototypes are fixed by a hard-coded seed, so two calls with the
    same `n_samples` produce bit-identical arrays (and the same arrays as
    the reference's `synthesize_mnist`).
    """
    rng = np.random.default_rng(20240202)
    prototypes = rng.normal(0.0, 0.35, (10, 784)).astype(np.float32)
    labels = rng.integers(0, 10, n_samples)
    noise = rng.normal(0.0, 0.25, (n_samples, 784)).astype(np.float32)
    x = prototypes[labels] + noise
    # match the real data's normalization envelope (x/255 - mean ≈ zero-mean,
    # unit-ish scale after the prototypes' spread)
    x = (x - x.mean(axis=0, keepdims=True)).astype(np.float32)
    y = np.zeros((n_samples, 10), np.float32)
    y[np.arange(n_samples), labels] = 1.0
    return x, y


def prepare_mnist(save_dir, synthetic: bool | None = None,
                  n_samples: int = 70000) -> Path:
    """Write the four dataset files under `save_dir` and return it.

    synthetic=True or None -> synthesize (this package never fetches);
    synthetic=False        -> the reference's OpenML-only mode: raises.
    """
    if synthetic is False:
        raise RuntimeError(
            "prepare_mnist(synthetic=False) asks for the OpenML fetch, "
            "which shallowspeed_tpu_torch does not have (no network); "
            "use the synthetic set")
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    x, y = synthesize_mnist(n_samples)

    n = len(x)
    n_val = int(n * VAL_FRACTION)
    n_train = n - n_val
    # deterministic shuffle before the split (the reference's
    # train_test_split(random_state=42) stand-in)
    perm = np.random.default_rng(42).permutation(n)
    x, y = x[perm], y[perm]
    np.save(save_dir / "x_train.npy", x[:n_train])
    np.save(save_dir / "y_train.npy", y[:n_train])
    np.save(save_dir / "x_val.npy", x[n_train:])
    np.save(save_dir / "y_val.npy", y[n_train:])
    return save_dir


def ensure_mnist(save_dir) -> Path:
    """Idempotent prepare: reuse existing files, else synthesize them."""
    save_dir = Path(save_dir)
    if all((save_dir / f).exists() for f in FILES):
        return save_dir
    return prepare_mnist(save_dir)
