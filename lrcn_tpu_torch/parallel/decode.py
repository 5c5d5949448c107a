"""Batch-sharded caption decoding over a mesh, in one process
(counterpart of ``lrcn_tpu/parallel/decode.py``).

Decoding is embarrassingly parallel over images: the decoder (and the VGG
encoder, where there is one) is replicated once per distinct device, a
batch splits into ``mesh.shape["data"]`` equal contiguous slices, and each
slice runs the whole search on its shard's device, on a CUDA stream of its
own, so no collective appears in the loop.  Every shard launches the
fused LSTM kernel twice a step and the top-k kernel once, as a one-device
search does.  Two shards may sit on one device (a mesh that lists it
twice): each then runs on its own stream of that device.  On a card each
shard's search and encoder batch is one CUDA graph replay called from its
stream: a graph belongs to the stream that calls it (``utils/graphs.py``),
so two shards that share a device, and so a replica, still replay graphs
of their own.  The shards' streams are the same for every ``DataShards``
over a device layout (``shard_stream``), so a graph captured for one
search replays in the next, as the service's do.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import numpy as np
import torch

from lrcn_tpu_torch.decode.beam import search
from lrcn_tpu_torch.models.lrcn import LRCNDecoder
from lrcn_tpu_torch.parallel.mesh import Mesh
from lrcn_tpu_torch.utils import graphs


def replicate(obj, device: torch.device):
    """``obj`` (a module with a ``device`` or a tensor) on ``device``:
    the object itself where it is there already, else a copy."""
    here = obj.device if hasattr(obj, "device") else None
    if here == device:
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return copy.deepcopy(obj).to(device)


_streams: dict = {}


def shard_stream(device: torch.device, index: int) -> torch.cuda.Stream:
    """The CUDA stream of data shard ``index`` on ``device``, made at the
    first call and the same after: a search's graphs belong to the stream
    they replay on (``utils/graphs.py``), so a new stream for every
    search would capture every search anew.  ``graphs.new_stream`` keeps
    it apart from the graphs' own streams."""
    key = (device, index)
    if key not in _streams:
        _streams[key] = graphs.new_stream(device)
    return _streams[key]


class DataShards:
    """The data shards of a mesh in this process: each has a device and,
    on a card, a CUDA stream of its own (``shard_stream``).  ``run`` calls
    a function per shard on its stream; ``to_host`` queues each shard's
    result's copy to one pinned host tensor right behind it, with an event
    per shard."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = mesh.data_devices()
        self.n = len(self.devices)
        self.streams = [shard_stream(d, i) if d.type == "cuda" else None
                        for i, d in enumerate(self.devices)]
        self._copies: dict = {}

    def replicate(self, obj) -> list:
        """``obj`` on every shard's device (one copy per distinct
        device), taken at the first call for ``obj``: a later change to
        ``obj`` in place does not reach the copies."""
        out = []
        for dev in self.devices:
            key = (id(obj), dev)
            # the source is kept beside its copy, so its id is not reused
            if key not in self._copies or self._copies[key][0] is not obj:
                self._copies[key] = (obj, replicate(obj, dev))
            out.append(self._copies[key][1])
        return out

    def split(self, n_rows: int) -> list[slice]:
        """Equal contiguous slices of ``n_rows`` rows, one per shard."""
        if n_rows % self.n:
            raise ValueError(f"{n_rows} rows do not split over the mesh's "
                             f"data axis ({self.n})")
        size = n_rows // self.n
        return [slice(i * size, (i + 1) * size) for i in range(self.n)]

    def run(self, fn: Callable, parts: Sequence) -> list:
        """``fn(i, part)`` for shard i, on its device and stream, after the
        work already queued on that device's current stream."""
        outs = []
        for i, (dev, stream, part) in enumerate(zip(self.devices,
                                                    self.streams, parts)):
            if stream is None:
                outs.append(fn(i, part))
                continue
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                outs.append(fn(i, part))
        return outs

    def join(self) -> None:
        """Make each device's current stream wait for its shards' work."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)

    def to_host(self, results: Sequence[torch.Tensor]):
        """The shards' results, concatenated, on the host: ``(host,
        events)``, each shard's copy queued on its stream behind its
        work and marked by an event (none on the CPU)."""
        if all(s is None for s in self.streams):
            return torch.cat([r.cpu() for r in results]), []
        rows = sum(r.shape[0] for r in results)
        host = torch.empty((rows, *results[0].shape[1:]),
                           dtype=results[0].dtype, pin_memory=True)
        events, lo = [], 0
        for stream, r in zip(self.streams, results):
            with torch.cuda.stream(stream):
                host[lo:lo + r.shape[0]].copy_(r, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            events.append(done)
            lo += r.shape[0]
        return host, events


def shard_for_decode(params: LRCNDecoder, feats, mesh: Mesh,
                     shards: DataShards | None = None
                     ) -> list[tuple[LRCNDecoder, torch.Tensor]]:
    """Replicate the decoder over the mesh's data shards and split the
    feature batch into their equal contiguous slices, each on its shard's
    device: a ``(decoder, feats)`` pair per shard.

    The batch must be divisible by the size of the ``data`` axis."""
    shards = shards or DataShards(mesh)
    feats = torch.as_tensor(np.asarray(feats, np.float32)
                            if not isinstance(feats, torch.Tensor) else feats)
    if feats.dtype not in (torch.float32, params.compute_dtype):
        feats = feats.float()
    decoders = shards.replicate(params)
    return [(dec, feats[rows].to(dec.device, non_blocking=True))
            for dec, rows in zip(decoders, shards.split(feats.shape[0]))]


def sharded_beam_search(params: LRCNDecoder, feats, mesh: Mesh, *,
                        beam_width: int = 3, max_words: int = 30
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search (greedy for ``beam_width == 1``) with the batch split
    over the mesh's data axis; returns the tokens and scores of the whole
    batch, in order, on the first shard's device."""
    shards = DataShards(mesh)
    pairs = shard_for_decode(params, feats, mesh, shards)
    outs = shards.run(lambda i, pair: search(pair[0], pair[1],
                                             beam_width=beam_width,
                                             max_words=max_words), pairs)
    shards.join()
    first = shards.devices[0]
    return (torch.cat([t.to(first) for t, _ in outs]),
            torch.cat([s.to(first) for _, s in outs]))
