"""The LM family's data layer — counterpart of `shallowspeed_tpu/data/`
for text: the byte-level BPE tokenizer, the memmapped token-shard
corpus with its held-out split, and the background prefetcher. The
MNIST modules of the reference's data layer come with the MLP path."""

from shallowspeed_tpu_torch.data.prefetch import (DevicePrefetcher, place_on,
                                                  prefetch_to_device,
                                                  sync_every)
from shallowspeed_tpu_torch.data.token_shards import (TokenShards, ValSplit,
                                                      build_shards)
from shallowspeed_tpu_torch.data.tokenizer import ByteBPE, train_bpe

__all__ = [
    "ByteBPE",
    "DevicePrefetcher",
    "TokenShards",
    "ValSplit",
    "build_shards",
    "place_on",
    "prefetch_to_device",
    "sync_every",
    "train_bpe",
]
