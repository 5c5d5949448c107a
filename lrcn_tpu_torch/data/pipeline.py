"""Host -> device input feed (counterpart of ``lrcn_tpu/data/pipeline.py``).

The reference copies features into the device batch row by row inside the
training loop (lrcn.jl:369-376), serializing host work with device compute.
Here batches are staged to the device ahead of use with a small prefetch
ring: while the card runs step N, the host gathers and copies step N+1.
For a feature store too large to keep on the card; the port's ``Trainer``
keeps its table on the device and gathers rows there.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


def _map(fn, item):
    """``fn`` over the leaves of a tuple / list / dict nest."""
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    return fn(item)


def prefetch_to_device(iterator: Iterable[Any], size: int = 2,
                       device=None,
                       transform: Callable[[Any], Any] | None = None
                       ) -> Iterator[Any]:
    """Double-buffered (by default) device prefetch.

    ``transform`` runs on the host (e.g. feature gather + padding) before
    the copy.  Each numpy array or tensor leaf of an item becomes a tensor
    on ``device``: on a CUDA device through a pinned host buffer and a
    ``non_blocking`` copy, which returns at once and overlaps the
    consumer's compute; ``size`` items are in flight.  The pinned buffers
    of an item are held until the consumer asks for the next one, and the
    caching host allocator does not hand a pinned block out again before
    the copy that read it has finished.  On the CPU (or ``device=None``)
    items pass through as tensors, in order.
    """
    device = torch.device(device) if device is not None else None
    cuda = device is not None and device.type == "cuda"
    queue: collections.deque = collections.deque()
    it = iter(iterator)

    def put(item) -> tuple[Any, list]:
        pinned = []

        def leaf(x):
            t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
            if not isinstance(t, torch.Tensor):
                return t
            if not cuda:
                return t if device is None else t.to(device)
            if t.device.type == "cpu":
                t = t.pin_memory()
                pinned.append(t)
            return t.to(device, non_blocking=True)

        return _map(leaf, item), pinned

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                item = next(it)
            except StopIteration:
                return
            if transform is not None:
                item = transform(item)
            queue.append(put(item))

    enqueue(size)
    while queue:
        item, held = queue.popleft()
        yield item
        del held        # the consumer asked for the next item
        enqueue(1)
