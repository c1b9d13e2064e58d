"""The data layer — counterpart of `shallowspeed_tpu/data/`: for text,
the byte-level BPE tokenizer, the memmapped token-shard corpus with its
held-out split, and the background prefetcher; for the MLP path, the
synthetic MNIST-784 files and the strided, microbatched `Dataset`."""

from shallowspeed_tpu_torch.data.dataset import Dataset, stack_epoch
from shallowspeed_tpu_torch.data.mnist import ensure_mnist, prepare_mnist
from shallowspeed_tpu_torch.data.prefetch import (DevicePrefetcher, place_on,
                                                  prefetch_to_device,
                                                  sync_every)
from shallowspeed_tpu_torch.data.token_shards import (TokenShards, ValSplit,
                                                      build_shards)
from shallowspeed_tpu_torch.data.tokenizer import ByteBPE, train_bpe

__all__ = [
    "ByteBPE",
    "Dataset",
    "DevicePrefetcher",
    "TokenShards",
    "ValSplit",
    "build_shards",
    "ensure_mnist",
    "place_on",
    "prefetch_to_device",
    "prepare_mnist",
    "stack_epoch",
    "sync_every",
    "train_bpe",
]
