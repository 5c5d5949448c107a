"""One captured CUDA graph per call signature: the port's counterpart of
``jax.jit``'s trace cache.

The JAX package runs each search and each encoder batch as one compiled
device program (``jax.jit`` around a fixed-trip ``lax.scan``), so the
host pays one dispatch a call.  The port's searches are eager loops that
launch some 30 kernels a step from Python.  :func:`run` gives them the
same property on a card: the first call of a signature runs the body
eagerly, and the second warms it up and captures it into a
``torch.cuda.CUDAGraph``; every call from the second on copies its inputs
into the graph's static buffers and replays it, one launch of the whole
program.  A signature called once (``caption``, a one-shot ``generate``)
so pays no capture, and a service warms each shape up twice.  On CPU
tensors :func:`run` calls the eager body, as ``jit`` on the CPU backend
runs the same function.

- **Signature**: the caller's static key (function and static
  arguments), the current CUDA stream, the shapes, dtypes and devices of
  the inputs, and the address, shape and dtype of every tensor the graph
  reads in place: the module's buffers and any extra (a feature table).
  JAX passes weights as arguments, so new weights just work there; here a
  module whose weights were replaced, or a new table, captures anew and
  never replays a stale graph, while an in-place ``load_state_dict``
  keeps the addresses and replays.  The stream is part of it because a
  mesh that lists one card twice runs one module on two streams at once
  (``parallel/decode.py``): each stream replays graphs of its own, from a
  memory pool of its own.
- **Graph streams**: each stream that calls :func:`run` has a graph
  stream (:func:`new_stream`), and its graphs are captured and replayed
  on it, behind and ahead of the caller's stream by stream waits.  cuBLAS
  keeps a workspace per stream, and a captured product writes its capture
  stream's workspace at every replay; as each graph replays on the stream
  it was captured on, every write to that workspace is ordered on one
  stream, even where the stream pool hands one CUDA stream out twice.
  :func:`new_stream` hands out streams distinct from those it gave
  before while the pool has one, so graphs of two callers' streams still
  run at once.
- **Cache**: on the module (``owner``), so dropping the module frees its
  graphs and their pools.  Graphs of one module and one stream share one
  pool (``torch.cuda.graph_pool_handle``): they run one after another on
  their graph stream, so one may reuse another's scratch memory.
- **Capture**: the body runs once eagerly on the graph stream first (the
  stream's cuBLAS workspace exists before capture), then is captured
  there with ``capture_error_mode="thread_local"``: other threads (the
  service's dispatchers, the native pump) go on using the card.  One
  capture runs at a time in the process.  A capture that fails raises;
  nothing falls back to the eager loop.
- **Calls**: a lock per module spans the copy into the static inputs, the
  replay and the copy out of the static outputs, so two threads never
  interleave writes into one graph's inputs.  Each call returns fresh
  tensors, copied from the static outputs on the caller's stream, so a
  result outlives the next replay (``generate_captions`` holds several
  before it reads them).
- **Launch counts**: the first, eager call counts its launches as any
  eager call does; the warm-up and the capture count nothing; each
  replay adds the kernel launches recorded at capture
  (``ops/kernels/launches.py``), so a call counts each launch once.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Sequence

import torch

from lrcn_tpu_torch.ops.kernels import launches

# torch hands out the streams of a pool of 32 a device and priority, in turn
POOL_STREAMS = 32

_capture_lock = threading.Lock()
_streams_lock = threading.Lock()
# (device index, caller's stream handle) -> its graph stream
_graph_streams: dict = {}
# the handles new_stream has handed out
_handed: set = set()
_stats_lock = threading.Lock()
# captures and replays in this process, over every module
stats = {"captures": 0, "replays": 0}


@dataclasses.dataclass
class Graph:
    """One captured graph: its static buffers and the launches one replay
    makes."""

    key: tuple
    stream: int                 # the caller's stream handle
    side: object                # the graph stream it is captured and
                                # replayed on
    graph: object
    inputs: tuple
    outputs: tuple
    single: bool                # the body returned one tensor, not a tuple
    launches: dict
    replays: int = 0


class GraphCache:
    """The captured graphs of one module, by signature.  A copy of the
    module (``copy.deepcopy``, as ``parallel/decode.py`` makes a replica)
    starts with an empty cache."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seen: set = set()          # signatures called once, eagerly
        self.graphs: dict = {}
        self.pools: dict = {}           # graph stream handle -> pool handle

    def __deepcopy__(self, memo):
        return GraphCache()


def enabled(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` runs as a graph: a CUDA tensor.  (The
    bodies that ``torch.export`` traces are the eager ones, never a
    graphed entry point.)"""
    return x.is_cuda


def cache_of(owner) -> GraphCache:
    cache = owner.__dict__.get("_graph_cache")
    if cache is None:
        cache = owner.__dict__.setdefault("_graph_cache", GraphCache())
    return cache


def graphs(owner) -> list[Graph]:
    """The graphs ``owner`` has captured, in capture order."""
    return list(cache_of(owner).graphs.values())


def new_stream(device: torch.device) -> torch.cuda.Stream:
    """A stream of ``device``'s pool that no earlier call handed out, while
    the pool holds one (else the last one drawn: work on one stream is
    ordered, so sharing one costs overlap, never a race)."""
    with _streams_lock:
        for _ in range(POOL_STREAMS):
            stream = torch.cuda.Stream(device)
            if stream.cuda_stream not in _handed:
                break
        _handed.add(stream.cuda_stream)
        return stream


def _graph_stream(device: torch.device, stream) -> torch.cuda.Stream:
    key = (device.index, stream.cuda_stream)
    side = _graph_streams.get(key)
    if side is None:
        with _streams_lock:
            _handed.add(stream.cuda_stream)
        side = _graph_streams.setdefault(key, new_stream(device))
    return side


def run(owner: torch.nn.Module, key: tuple, fn: Callable,
        inputs: Sequence[torch.Tensor], reads: Sequence[torch.Tensor] = (),
        *, graph: bool = True):
    """``fn(*inputs)``: on CUDA tensors (unless ``graph`` is False) as a
    replay of the graph captured for this signature, captured now at the
    signature's second call, returning fresh tensors in the structure
    ``fn`` returns (one tensor or a tuple); else, and at a signature's
    first call, ``fn`` itself, eagerly, under ``torch.inference_mode``
    on a card.

    ``fn`` must be the eager body: it may read ``owner``'s buffers and
    ``reads`` in place, must not wait for the device, and is called twice
    at capture (warm-up, capture).  The inputs share one device.
    """
    if not (graph and enabled(inputs[0])):
        return fn(*inputs)
    device = inputs[0].device
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return run(owner, key, fn, inputs, reads)
    stream = torch.cuda.current_stream(device)
    held = (*owner.parameters(), *owner.buffers(), *reads)
    sig = (key, stream.cuda_stream,
           tuple((tuple(x.shape), x.dtype, x.device) for x in inputs),
           tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in held))
    cache = cache_of(owner)
    with cache.lock:
        first = sig not in cache.seen
        cache.seen.add(sig)
    if first:
        with torch.inference_mode():
            return fn(*inputs)
    inference = torch.is_inference_mode_enabled()
    with cache.lock, torch.inference_mode():
        entry = cache.graphs.get(sig)
        if entry is None:
            entry = _capture(cache, key, fn, inputs, device, stream)
            cache.graphs[sig] = entry
        else:
            for static, x in zip(entry.inputs, inputs):
                static.copy_(x)
            entry.side.wait_stream(stream)
        with torch.cuda.stream(entry.side):
            entry.graph.replay()
        stream.wait_stream(entry.side)
        with torch.inference_mode(inference):
            outs = tuple(o.clone() for o in entry.outputs)
        entry.replays += 1
        launches.add(entry.launches)
    with _stats_lock:
        stats["replays"] += 1
    return outs[0] if entry.single else outs


def _capture(cache: GraphCache, key: tuple, fn: Callable,
             inputs: Sequence[torch.Tensor], device: torch.device,
             stream) -> Graph:
    """Warm ``fn`` up on the caller's graph stream and capture it there,
    behind the caller's stream; return the graph with its static
    buffers."""
    static_in = tuple(x.clone() for x in inputs)
    graph = torch.cuda.CUDAGraph()
    with _capture_lock:
        side = _graph_stream(device, stream)
        pool = cache.pools.get(side.cuda_stream)
        if pool is None:
            pool = cache.pools[side.cuda_stream] = (
                torch.cuda.graph_pool_handle())
        side.wait_stream(stream)
        with launches.recording(), torch.cuda.stream(side):
            fn(*static_in)                       # warm-up, counted nowhere
        with launches.recording() as record:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = fn(*static_in)
    single = isinstance(out, torch.Tensor)
    with _stats_lock:
        stats["captures"] += 1
    return Graph(key=key, stream=stream.cuda_stream, side=side, graph=graph,
                 inputs=static_in, outputs=(out,) if single else tuple(out),
                 single=single, launches=record)
