"""Background input pipeline — counterpart of
`shallowspeed_tpu/data/prefetch.py` (`DevicePrefetcher`,
`prefetch_to_device` and `sync_every` are copies of the reference's),
plus `place_on`, the placement for a torch device.

If the host only starts building batch N+1 after step N returns, the
device idles for the whole host time every step. `DevicePrefetcher`
overlaps the stages:

- a daemon thread pulls from the (host-side) batch iterator and
  immediately *places* each batch;
- a bounded queue keeps up to `depth` placed batches in flight (depth
  2 = classic double buffering: one computing, one transferring).

Producer exceptions are captured and re-raised at the consuming end, so
error behavior matches the synchronous loop. The batch order is the
iterator's; the prefetcher keeps no step counter of its own, so a
resumed run that starts the iterator at its step sees the same stream.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

_DONE = object()


class DevicePrefetcher:
    """Iterate `it`, applying `place` to each item `depth` items ahead.

    `place` maps one host batch (any pytree of numpy arrays) to its placed
    form; it runs on the producer thread. Iteration order is preserved.
    """

    def __init__(self, it: Iterable[Any], place: Callable[[Any], Any],
                 depth: int = 2):
        assert depth >= 1
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._done = False
        self._stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up when close() signals; returns
            False to end the producer."""
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for item in it:
                    if self._stop.is_set() or not put(place(item)):
                        return
            except BaseException as e:  # re-raised on the consumer side
                self._err = e
            finally:
                put(_DONE)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the producer and release queued (device) batches. Safe to
        call any time; consumers abandoning iteration early (errors,
        breaks) should close() — e.g. in a `finally:` — so up-to-`depth`
        placed batches don't stay pinned in device memory."""
        self._stop.set()
        self._done = True

        def drain():
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    return

        drain()  # unblock a producer parked in put()
        self._thread.join(timeout=5)
        drain()  # a pending put may have slipped in before the stop check

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._done:  # exhausted (or errored): stay terminated, never
            raise StopIteration  # block on a queue no producer feeds
        item = self._q.get()
        if item is _DONE:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch_to_device(it: Iterable[Any], place: Callable[[Any], Any],
                       depth: int = 2) -> Iterator[Any]:
    """Functional spelling of `DevicePrefetcher` (depth<=0 disables —
    returns the plain mapped iterator, same semantics, no thread)."""
    if depth <= 0:
        return (place(item) for item in it)
    return DevicePrefetcher(it, place, depth)


def place_on(device) -> Callable[[Any], Any]:
    """`place` for a torch device: each array of a batch tuple as an
    int64 tensor (the embedding's index type) on `device`.

    On a CUDA device the copy is synchronous on the producer thread and
    runs on the device's default stream, the stream the training step
    runs on too (a torch stream context is per thread, and the producer
    sets none). So the copy is ordered before any step that reads the
    tensor, and the tensor is allocated and freed on that one stream:
    no `record_stream` is needed. A batch of 4 x 2048 ids is 64 KB, so
    a pinned asynchronous copy on a side stream would gain nothing."""
    dev = torch.device(device)

    def place(batch):
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int64)
                                      ).to(dev) for a in batch)

    return place


def sync_every(step: int, every: int, total: int) -> bool:
    """Whether `step` is a log point (every `every` steps, and the
    final step)."""
    return step % every == 0 or step == total - 1


__all__ = ["DevicePrefetcher", "place_on", "prefetch_to_device",
           "sync_every"]
