"""One captured CUDA graph per call signature: the port's counterpart of
``jax.jit``'s trace cache.

The JAX package runs each search, each encoder batch, each training
dispatch and each evaluation as one compiled device program (``jax.jit``
around a fixed-trip ``lax.scan`` or a Python loop it unrolls), so the host
pays one dispatch a call.  The port's bodies are eager loops that launch
tens of kernels a step from Python.  :func:`run` (inference) and
:func:`step` (training) give them the same property on a card: the first
call of a signature runs the body eagerly, the second captures it into a
``torch.cuda.CUDAGraph``, and every call from the second on copies its
inputs into the graph's static buffers and replays it, one launch of the
whole program.  A signature called once (``caption``, a one-shot
``generate``) so pays no capture, and a service or a trainer's timing
warms each shape up twice.  On CPU tensors both call the eager body, as
``jit`` on the CPU backend runs the same function.

- **Signature**: the caller's static key (function and static
  arguments), the current CUDA stream, the shapes, dtypes and devices of
  the inputs, and the address, shape and dtype of every tensor the graph
  reads or writes in place: the module's parameters and buffers, and any
  extra (a feature table, an optimizer's moments and count).  JAX passes
  weights and optimizer state as arguments, so new ones just work there;
  here replaced weights, a new table or a restored optimizer capture anew
  and never replay a stale graph, while an in-place ``load_state_dict``
  keeps the addresses and replays.  The stream is part of it because a
  mesh that lists one card twice runs one module on two streams at once
  (``parallel/decode.py``): each stream replays graphs of its own, from a
  memory pool of its own.
- **Graph streams**: each stream that calls :func:`run` or :func:`step`
  has a graph stream (:func:`new_stream`), and its graphs are captured and
  replayed on it, behind and ahead of the caller's stream by stream
  waits.  cuBLAS keeps a workspace per stream, and a captured product
  writes its capture stream's workspace at every replay; as each graph
  replays on the stream it was captured on, every write to that workspace
  is ordered on one stream, even where the stream pool hands one CUDA
  stream out twice.  :func:`new_stream` hands out streams distinct from
  those it gave before while the pool has one, so graphs of two callers'
  streams still run at once.
- **Cache**: on the owner (a module, an optimizer), so dropping it frees
  its graphs and their pools.  Graphs of one owner and one stream share
  one pool (``torch.cuda.graph_pool_handle``): they run one after another
  on their graph stream, so one may reuse another's scratch memory.
- **Capture**: :func:`run` runs the body once more eagerly on the graph
  stream first (the stream's cuBLAS workspace exists before capture);
  :func:`step` runs a signature's first, eager call on the graph stream
  instead, since every extra call of a training step would move the
  parameters.  Either captures there with
  ``capture_error_mode="thread_local"``: other threads (the service's
  dispatchers, the native pump, autograd's device thread) go on using the
  card.  One capture runs at a time in the process.  A capture executes
  nothing, so the capturing call replays the graph once right after.  A
  capture that fails raises; nothing falls back to the eager loop.
- **Random numbers**: a graph registers the ``torch.Generator``s its body
  draws from (``CUDAGraph.register_generator_state``).  A replay draws
  from a generator's state at the time and advances it as an eager call
  does, so a sequence of calls on one generator gives the same numbers
  eagerly or replayed; :func:`run`'s warm-up leaves the generators as it
  found them.  :func:`step` makes one generator a seed for each graph
  and seeds it before each call (a training step's dropout key).
- **Calls**: a lock per owner spans the copy into the static inputs, the
  replay and the copy out of the static outputs, so two threads never
  interleave writes into one graph's inputs.  Each call returns fresh
  tensors, copied from the static outputs on the caller's stream, so a
  result outlives the next replay (``generate_captions`` holds several
  before it reads them).
- **Launch counts**: the first, eager call counts its launches as any
  eager call does; the warm-up and the capture count nothing; each
  replay adds the kernel launches recorded at capture
  (``ops/kernels/launches.py``), so a call counts each launch once.
- **Collectives**: a mesh's training steps and evaluations
  (``parallel/train.py``, ``train/trainer.py``, ``models/joint.py``)
  pass the process ``groups`` their collectives run over.  A call is a
  graph only where :func:`capturable` says so: every group NCCL, whose
  ``all_reduce`` enqueues device work on a stream that a capture can
  hold; under gloo (the CPU, or two ranks on one card) the collectives
  run on the host and the body runs eagerly.  The groups are part of the
  signature, and a signature's first call, eager, makes each group's
  communicator before any capture.  Every rank makes the same calls in
  the same order with the same shapes (each takes its rows of the same
  global batches), so every rank runs the first call eagerly, captures
  the second and replays the rest at the same calls, and the ranks'
  collectives stay in step.  A graph replays its group's communicator:
  :func:`forget_collectives` drops such graphs, and
  ``parallel.distributed.shutdown`` calls it before the group goes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from lrcn_tpu_torch.ops.kernels import launches
from lrcn_tpu_torch.utils.profiling import span

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
# the owners whose graphs hold collectives
_collective_owners: weakref.WeakSet = weakref.WeakSet()


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
    generators: tuple = ()      # registered; :func:`step` seeds them
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


def capturable(x: torch.Tensor, groups: Sequence = ()) -> bool:
    """Whether a call on ``x`` whose collectives run over the process
    ``groups`` runs as a graph: ``enabled(x)``, and every group NCCL.
    Gloo runs its collectives on the host, out of a capture's reach.
    Decided from the backend, never from a failed capture."""
    return enabled(x) and all(dist.get_backend(g) == "nccl"
                              for g in groups)


def cache_of(owner) -> GraphCache:
    cache = owner.__dict__.get("_graph_cache")
    if cache is None:
        cache = owner.__dict__.setdefault("_graph_cache", GraphCache())
    return cache


def graphs(owner) -> list[Graph]:
    """The graphs ``owner`` has captured, in capture order."""
    return list(cache_of(owner).graphs.values())


def forget(owner) -> None:
    """Drop ``owner``'s graphs (and with them their pools): its next call
    of every signature runs eagerly again.  For state loaded anew
    (``Optimizer.load_leaves``), which no graph of the old may read."""
    owner.__dict__.pop("_graph_cache", None)


def forget_collectives() -> None:
    """Drop every graph of the owners whose graphs hold collectives, once
    the card has run them: before their process group goes, as a replay
    after it would use a destroyed communicator."""
    owners = list(_collective_owners)
    if owners and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    for owner in owners:
        forget(owner)
    _collective_owners.clear()


def default_generator(device: torch.device) -> torch.Generator:
    """The generator that draws with no ``generator=`` on ``device``."""
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index
                                             if device.index is not None
                                             else torch.cuda.current_device()]
    return torch.default_generator


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


def _signature(key: tuple, stream, inputs: Sequence[torch.Tensor],
               held: Sequence[torch.Tensor], groups: Sequence = ()) -> tuple:
    return (key, tuple(groups), stream.cuda_stream,
            tuple((tuple(x.shape), x.dtype, x.device) for x in inputs),
            tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in held))


def _pool(cache: GraphCache, side):
    pool = cache.pools.get(side.cuda_stream)
    if pool is None:
        pool = cache.pools[side.cuda_stream] = torch.cuda.graph_pool_handle()
    return pool


@contextlib.contextmanager
def _kept(generators: Sequence[torch.Generator]):
    """Leave ``generators`` in the state the block found them in."""
    states = [g.get_state() for g in generators]
    try:
        yield
    finally:
        for g, state in zip(generators, states):
            g.set_state(state)


def _replay(entry: Graph, stream) -> None:
    """Replay ``entry`` on its graph stream, behind and ahead of the
    caller's ``stream``.  Under the owner's lock."""
    entry.side.wait_stream(stream)
    with torch.cuda.stream(entry.side):
        entry.graph.replay()
    stream.wait_stream(entry.side)
    entry.replays += 1
    launches.add(entry.launches)
    with _stats_lock:
        stats["replays"] += 1


def run(owner: torch.nn.Module, key: tuple, fn: Callable,
        inputs: Sequence[torch.Tensor], reads: Sequence[torch.Tensor] = (),
        *, graph: bool = True,
        generators: Sequence[torch.Generator] = (), groups: Sequence = ()):
    """``fn(*inputs)``: where :func:`capturable` (on CUDA tensors, every
    one of ``groups`` NCCL) and ``graph`` is True, as a replay of the
    graph captured for this signature, captured now at the signature's
    second call, returning fresh tensors in the structure ``fn`` returns
    (one tensor or a tuple); else, and at a signature's first call,
    ``fn`` itself, eagerly, under ``torch.inference_mode`` on a card.

    ``fn`` must be the eager body: it may read ``owner``'s parameters and
    buffers and ``reads`` in place, may draw from ``generators`` (which
    the caller's ``key`` names where they are not fixed), may run
    collectives over ``groups``, must not wait for the device, and is
    called twice at capture (warm-up, capture).  The inputs share one
    device.

    Spans (``utils/profiling.py:span``), on the graph path only:
    ``lrcn.graph.eager`` (a signature's first call), ``lrcn.graph.capture``
    (the warm-up and the capture) and ``lrcn.graph.replay`` (the copy into
    the static inputs, the replay and the copy out); none inside ``fn``.
    """
    if not (graph and capturable(inputs[0], groups)):
        return fn(*inputs)
    device = inputs[0].device
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return run(owner, key, fn, inputs, reads, generators=generators,
                       groups=groups)
    stream = torch.cuda.current_stream(device)
    held = (*owner.parameters(), *owner.buffers(), *reads)
    sig = _signature(key, stream, inputs, held, groups)
    cache = cache_of(owner)
    with cache.lock:
        first = sig not in cache.seen
        cache.seen.add(sig)
    if first:
        with span("lrcn.graph.eager"), torch.inference_mode():
            return fn(*inputs)
    inference = torch.is_inference_mode_enabled()
    with cache.lock, torch.inference_mode():
        entry = cache.graphs.get(sig)
        fresh = entry is None
        if fresh:
            with span("lrcn.graph.capture"):
                entry = _capture(cache, key, fn, inputs, device, stream,
                                 generators)
            cache.graphs[sig] = entry
            if groups:
                _collective_owners.add(owner)
        with span("lrcn.graph.replay"):
            if not fresh:
                for static, x in zip(entry.inputs, inputs):
                    static.copy_(x)
            _replay(entry, stream)
            with torch.inference_mode(inference):
                outs = tuple(o.clone() for o in entry.outputs)
    return outs[0] if entry.single else outs


def _capture(cache: GraphCache, key: tuple, fn: Callable,
             inputs: Sequence[torch.Tensor], device: torch.device,
             stream, generators: Sequence[torch.Generator],
             warm_up: bool = True) -> Graph:
    """Capture ``fn`` on the caller's graph stream, behind the caller's
    stream, after a warm-up call there (``warm_up``); return the graph
    with its static buffers."""
    static_in = tuple(x.clone() for x in inputs)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with _capture_lock:
        side = _graph_stream(device, stream)
        pool = _pool(cache, side)
        side.wait_stream(stream)
        if warm_up:
            with launches.recording(), torch.cuda.stream(side), \
                    _kept(generators):
                fn(*static_in)                   # counted nowhere
        with launches.recording() as record:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                out = fn(*static_in)
    single = isinstance(out, torch.Tensor)
    with _stats_lock:
        stats["captures"] += 1
    return Graph(key=key, stream=stream.cuda_stream, side=side, graph=graph,
                 inputs=static_in, outputs=(out,) if single else tuple(out),
                 single=single, launches=record, generators=tuple(generators))


def _seeded(device: torch.device, seeds: Sequence[int]
            ) -> list[torch.Generator]:
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def step(owner, key: tuple, fn: Callable, inputs: Sequence[torch.Tensor],
         reads: Sequence[torch.Tensor] = (), seeds: Sequence[int] = (), *,
         graph: bool = True, groups: Sequence = ()):
    """A training dispatch ``fn(generators, *inputs)``: the body updates
    tensors in place (parameters, optimizer state; all of them in
    ``reads``) and returns its losses.  ``generators`` are one
    ``torch.Generator`` on the inputs' device for each of ``seeds``,
    seeded with it.

    Where :func:`capturable` (on CUDA tensors, every one of ``groups``
    NCCL) and ``graph`` is True, a signature's first call runs ``fn``
    eagerly on the caller's graph stream (its warm-up: no extra step is
    taken), its second captures ``fn`` and replays the graph once (the
    step is taken by the replay), and every later call replays it, each
    graph's generators seeded from ``seeds`` first.  Returns fresh
    tensors in the structure ``fn`` returns.  Else ``fn`` itself.  ``fn``
    may run collectives over ``groups``, must leave no ``.grad`` behind
    (a captured backward allocates them in the graph's pool, which the
    next replay of another graph may reuse) and must not wait for the
    device.

    Spans, as :func:`run`'s: ``lrcn.graph.eager`` (a signature's first
    call), ``lrcn.graph.capture`` and ``lrcn.graph.replay`` (the copy in,
    the seeding, the replay and the copy out).
    """
    device = inputs[0].device
    if not (graph and capturable(inputs[0], groups)):
        return fn(_seeded(device, seeds), *inputs)
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return step(owner, key, fn, inputs, reads, seeds, groups=groups)
    stream = torch.cuda.current_stream(device)
    sig = _signature(key, stream, inputs, reads, groups)
    cache = cache_of(owner)
    with cache.lock:
        entry = cache.graphs.get(sig)
        if entry is None and sig not in cache.seen:
            cache.seen.add(sig)
            with span("lrcn.graph.eager"):
                with _capture_lock:
                    side = _graph_stream(device, stream)
                side.wait_stream(stream)
                with torch.cuda.stream(side):
                    out = fn(_seeded(device, seeds), *inputs)
                stream.wait_stream(side)
                if isinstance(out, torch.Tensor):
                    return out.clone()
                return tuple(o.clone() for o in out)
        fresh = entry is None
        if fresh:
            generators = [torch.Generator(device=device) for _ in seeds]
            with span("lrcn.graph.capture"):
                entry = _capture(cache, key,
                                 functools.partial(fn, generators), inputs,
                                 device, stream, generators, warm_up=False)
            cache.graphs[sig] = entry
            if groups:
                _collective_owners.add(owner)
        with span("lrcn.graph.replay"):
            if not fresh:
                for static, x in zip(entry.inputs, inputs):
                    static.copy_(x)
            for g, s in zip(entry.generators, seeds):
                g.manual_seed(s)
            _replay(entry, stream)
            outs = tuple(o.clone() for o in entry.outputs)
    return outs[0] if entry.single else outs
