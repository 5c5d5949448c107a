"""The port's one-program dispatch (``lrcn_tpu_torch/utils/graphs.py``) on
the CPU.

On a card every search and encoder batch runs eagerly at its first call
of a shape, captures a CUDA graph at its second and replays it from then
on.  Here ``torch.cuda``'s
graph API is stubbed (``fake_cuda``), the way ``test_torch_kernels.py``
stubs the kernels' library: ``graphs.enabled`` lets CPU tensors take the
graph path, a "capture" records every aten and ``lrcn::`` op the body
runs (a ``TorchDispatchMode``) and then undoes what it ran (every
storage an op wrote and every generator it drew from are put back), as
a CUDA graph's capture executes nothing, and a "replay" runs the
recorded ops again and writes each op's result into the tensor it
produced at capture, so a replay reads the static inputs and overwrites
the static outputs as a CUDA graph does.  A capture that waits for the
device (``.item()``) raises, as it does on a card.  Streams and pools
are tokens; the stream a "capture" and each "replay" ran on is kept.
The searches' results are held against the eager bodies and against
JAX.
"""

import contextlib
import copy
import functools
import itertools
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.decode import beam as jax_beam
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data import images as torch_images
from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.decode import beam
from lrcn_tpu_torch.decode.writer import generate_captions
from lrcn_tpu_torch.models import vgg as torch_vgg
from lrcn_tpu_torch.models.lrcn import params_from_numpy
from lrcn_tpu_torch.ops.kernels import (conv3x3, fused_conv3x3_relu,
                                        fused_lstm_step, launches, lstm_step,
                                        topk_logsumexp, topk_lse)
from lrcn_tpu_torch.serve import CaptionService
from lrcn_tpu_torch.utils import graphs

CPU = torch.device("cpu")
BEAM, MAX_WORDS = 3, 6
STEPS = MAX_WORDS + 1


class _Recorder(TorchDispatchMode):
    """Every op that runs while it is on, with its arguments and result,
    and each storage an op may write as it was before the first such op
    (``undo`` puts them back)."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.saved = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise RuntimeError("a captured body waited for the device "
                               "(stub)")
        if func._schema.is_mutable:
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor):
                    st = t.untyped_storage()
                    self.saved.setdefault(st.data_ptr(), (st, st.clone()))
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        return out

    def undo(self) -> None:
        for st, before in self.saved.values():
            st.copy_(before)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class FakeGraph:
    """A "captured graph": the ops recorded at capture, run again at each
    replay into the tensors they produced then (a view or an op in place
    already writes where the capture's result lives).  A replay runs no
    Python on a card, so the ops' launch counts are dropped here."""

    def __init__(self):
        self.ops = None
        self.stream = None          # the stream it was captured on
        self.replayed_on = []
        self.generators = []

    def register_generator_state(self, generator) -> None:
        self.generators.append(generator)

    @property
    def replays(self):
        return len(self.replayed_on)

    def replay(self):
        self.replayed_on.append(torch.cuda.current_stream())
        # a replay runs the kernels alone: no autograd
        with torch._C._AutoDispatchBelowAutograd():
            self._run()

    def _run(self):
        for func, args, kwargs, out in self.ops:
            with launches.recording():
                new = func(*args, **kwargs)
            read = {_storage(t) for t in tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor)}
            for old, fresh in zip(tree_leaves(out), tree_leaves(new)):
                if isinstance(old, torch.Tensor) and _storage(old) not in read:
                    old.copy_(fresh)


class FakeStream:
    def __init__(self, handle: int):
        self.cuda_stream = handle

    def wait_stream(self, other) -> None:
        pass


def _stub_graph_api(monkeypatch, pool_streams=None):
    """CPU tensors take the graph path through a stubbed graph API.
    ``state.fail`` makes the next capture raise; ``state.modes`` collects
    each capture's error mode.  ``torch.cuda.Stream`` hands out new
    handles, or with ``pool_streams`` those of a pool of that many in
    turn, as torch's stream pool does."""
    state = types.SimpleNamespace(fail=False, modes=[], pools=0,
                                  current=FakeStream(7), captured_on=[])
    if pool_streams is None:
        handles = itertools.count(100)
    else:
        handles = itertools.cycle(range(100, 100 + pool_streams))

    @contextlib.contextmanager
    def stream(s):
        outer, state.current = state.current, s
        try:
            yield
        finally:
            state.current = outer

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None, stream=None,
              capture_error_mode="global"):
        state.modes.append(capture_error_mode)
        state.captured_on.append(stream)
        recorder = _Recorder()
        drawn = [*cuda_graph.generators, torch.default_generator]
        before = [g.get_state() for g in drawn]
        outer, state.current = state.current, stream
        try:
            with recorder:
                yield
        finally:
            state.current = outer
            recorder.undo()                 # a capture executes nothing
            for g, st in zip(drawn, before):
                g.set_state(st)
        if state.fail:
            raise RuntimeError("capture failed (stub)")
        cuda_graph.ops, cuda_graph.stream = recorder.ops, stream

    def pool_handle():
        state.pools += 1
        return (0, state.pools)

    monkeypatch.setattr(graphs, "enabled", lambda x: True)
    monkeypatch.setattr(graphs, "stats", {"captures": 0, "replays": 0})
    monkeypatch.setattr(graphs, "_graph_streams", {})
    monkeypatch.setattr(graphs, "_handed", set())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", pool_handle)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: state.current)
    monkeypatch.setattr(torch.cuda, "Stream",
                        lambda d=None: FakeStream(next(handles)))
    monkeypatch.setattr(torch.cuda, "stream", stream)
    return state


@pytest.fixture
def fake_cuda(monkeypatch):
    return _stub_graph_api(monkeypatch)


@pytest.fixture
def counting(monkeypatch):
    """The three ops' CPU kernels count a launch each (on the route a card
    would take for these f32 operands), as their CUDA kernels do."""
    for fn in (fused_lstm_step, topk_logsumexp, fused_conv3x3_relu):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_route",
                            dict.fromkeys(fn.launches_by_route, 0))

    def lstm(*args):
        launches.count(fused_lstm_step, "fma")
        return lstm_step._lstm_step_cpu(*args)

    def topk(logits, k, route=None):
        launches.count(topk_logsumexp, "block")
        return topk_lse._topk_lse_cpu(logits, k, route)

    def conv(*args):
        launches.count(fused_conv3x3_relu, "fma")
        return conv3x3._conv3x3_relu_cpu(*args)

    lib = torch.library.Library("lrcn", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # "overriding a kernel"
        lib.impl("lstm_step", lstm, "CPU")
        lib.impl("topk_lse", topk, "CPU")
        lib.impl("conv3x3_relu", conv, "CPU")
    yield
    lib._destroy()


def _counts():
    return (fused_lstm_step.launches, topk_logsumexp.launches,
            fused_conv3x3_relu.launches)


@pytest.fixture(scope="module")
def small():
    """The decode tests' config (tests/test_decode.py), f32."""
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    params = jax_lrcn.init_params(jax.random.PRNGKey(3), cfg)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(2, 3, cfg.cnn_feature_dim)).astype(np.float32)
             for _ in range(3)]
    return cfg, params, tree, feats


def _decoder(small):
    return params_from_numpy(small[2], CPU, torch.float32)


def _eager(fn, *args, **kwargs):
    with torch.inference_mode():
        return fn(*args, **kwargs)


# entry point -> (graphed call, eager body), each on a (2, 3, D) batch
ENTRIES = {
    "beam_search": (
        lambda d, f: beam.beam_search(d, f.reshape(6, -1), beam_width=BEAM,
                                      max_words=MAX_WORDS),
        lambda d, f: beam.beam_search_fn(d, f.reshape(6, -1),
                                         beam_width=BEAM,
                                         max_words=MAX_WORDS)),
    "greedy_search": (
        lambda d, f: beam.greedy_search(d, f.reshape(6, -1),
                                        max_words=MAX_WORDS),
        lambda d, f: beam.greedy_search_fn(d, f.reshape(6, -1),
                                           max_words=MAX_WORDS)),
    "search": (
        lambda d, f: beam.search(d, f.reshape(6, -1), beam_width=BEAM,
                                 max_words=MAX_WORDS),
        lambda d, f: beam.beam_search_fn(d, f.reshape(6, -1),
                                         beam_width=BEAM,
                                         max_words=MAX_WORDS)),
    "beam_search_grouped": (
        lambda d, f: beam.beam_search_grouped(d, f, beam_width=BEAM,
                                              max_words=MAX_WORDS),
        lambda d, f: tuple(t.view(2, 3, *t.shape[1:]) for t in
                           beam.beam_search_fn(d, f.reshape(6, -1),
                                               beam_width=BEAM,
                                               max_words=MAX_WORDS))),
    "greedy_search_grouped": (
        lambda d, f: beam.greedy_search_grouped(d, f, max_words=MAX_WORDS),
        lambda d, f: tuple(t.view(2, 3, *t.shape[1:]) for t in
                           beam.greedy_search_fn(d, f.reshape(6, -1),
                                                 max_words=MAX_WORDS))),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_signature_captures_once_then_replays(small, fake_cuda, entry):
    """Four calls of one shape: the first runs eagerly, the second
    captures, and the second to the fourth replay, on the stream the graph
    was captured on; each call's tokens and scores are those of the eager
    body on its own inputs (the inputs are copied into the graph's static
    buffers)."""
    graphed, eager = ENTRIES[entry]
    decoder = _decoder(small)
    for feats in [*small[3], small[3][0] * 2.0]:
        got = graphed(decoder, torch.from_numpy(feats))
        want = _eager(eager, decoder, torch.from_numpy(feats))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert graphs.stats == {"captures": 1, "replays": 3}
    (entry_graph,) = graphs.graphs(decoder)
    assert entry_graph.replays == 3 and entry_graph.graph.replays == 3
    assert entry_graph.graph.replayed_on == [entry_graph.side] * 3
    assert entry_graph.graph.stream is entry_graph.side
    assert fake_cuda.modes == ["thread_local"]


@pytest.mark.parametrize("beam_width", [1, BEAM])
def test_replayed_searches_match_jax(small, fake_cuda, beam_width):
    """Replays at f32 give the JAX package's tokens (exact) and scores
    (f32 sums in another order: 1e-5)."""
    cfg, params, _, feats = small
    decoder = _decoder(small)
    for batch in feats:
        rows = batch.reshape(6, -1)
        got_t, got_s = beam.search(decoder, torch.from_numpy(rows),
                                   beam_width=beam_width, max_words=MAX_WORDS)
        if beam_width == 1:
            want_t, want_s = jax_beam.greedy_search(
                params, jnp.asarray(rows), max_words=MAX_WORDS,
                compute_dtype=jnp.float32)
        else:
            want_t, want_s = jax_beam.beam_search(
                params, jnp.asarray(rows), beam_width=beam_width,
                max_words=MAX_WORDS, compute_dtype=jnp.float32)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   rtol=1e-5, atol=1e-5)
    assert graphs.stats["captures"] == 1


def test_rows_search_gathers_inside_the_graph(small, fake_cuda):
    """(G, B) indices into a table: one graph for the gather and the
    search, equal to the eager body at every call."""
    decoder = _decoder(small)
    table = torch.from_numpy(np.concatenate(small[3]).reshape(18, -1))
    for seed in range(4):
        idx = torch.from_numpy(
            np.random.default_rng(seed).integers(0, 18, (2, 3)))
        got = beam.rows_search(decoder, table, idx, beam_width=BEAM,
                               max_words=MAX_WORDS)
        want = _eager(beam._rows_search_fn, decoder, table, idx,
                      beam_width=BEAM, max_words=MAX_WORDS)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert got[0].shape == (2, 3, MAX_WORDS + 2)
    assert graphs.stats == {"captures": 1, "replays": 3}
    assert {g.key for g in graphs.graphs(decoder)} == {
        ("rows", BEAM, MAX_WORDS)}


def test_results_outlive_the_next_replay(small, fake_cuda):
    """Two replays return distinct tensors, and the second, which
    overwrites the graph's static outputs, leaves the first one's result
    as it was."""
    decoder = _decoder(small)
    warm, a, b = (torch.from_numpy(f.reshape(6, -1)) for f in small[3])
    beam.beam_search(decoder, warm, beam_width=BEAM, max_words=MAX_WORDS)
    first = beam.beam_search(decoder, a, beam_width=BEAM,
                             max_words=MAX_WORDS)
    kept = [t.clone() for t in first]
    second = beam.beam_search(decoder, b, beam_width=BEAM,
                              max_words=MAX_WORDS)
    (entry,) = graphs.graphs(decoder)
    assert not torch.equal(first[1], second[1])     # other inputs
    for f, s, k, static in zip(first, second, kept, entry.outputs):
        assert f.data_ptr() != s.data_ptr()
        assert f.data_ptr() != static.data_ptr()
        assert torch.equal(f, k)
    assert torch.equal(second[1], entry.outputs[1])
    assert entry.replays == 2


def test_replaced_parameter_captures_anew(small, fake_cuda):
    """A weight replaced by another tensor is a new signature: the search
    captures again and reads the new weight; a ``load_state_dict`` in
    place keeps every address and replays, reading the new values."""
    decoder = _decoder(small)
    feats = torch.from_numpy(small[3][0].reshape(6, -1))
    run = lambda: beam.beam_search(decoder, feats, beam_width=BEAM,
                                   max_words=MAX_WORDS)
    want = lambda: _eager(beam.beam_search_fn, decoder, feats,
                          beam_width=BEAM, max_words=MAX_WORDS)
    run(), run()
    decoder.w_out = decoder.w_out * 4.0
    run()                           # a new signature: eagerly
    got = run()
    assert graphs.stats["captures"] == 2
    for g, w in zip(got, want()):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    other = params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x) * 0.5, small[2]), CPU, torch.float32)
    decoder.load_state_dict(other.state_dict())
    got = run()
    assert graphs.stats == {"captures": 2, "replays": 3}
    for g, w in zip(got, want()):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_new_table_captures_anew(small, fake_cuda):
    """``rows_search`` reads its table in place: another table of the same
    shape is another graph, never a replay against the first."""
    decoder = _decoder(small)
    rows = np.concatenate(small[3]).reshape(18, -1)
    idx = torch.arange(6)
    for scale in (1.0, -2.0):
        table = torch.from_numpy(rows * scale)
        beam.rows_search(decoder, table, idx, beam_width=BEAM,
                         max_words=MAX_WORDS)
        got = beam.rows_search(decoder, table, idx, beam_width=BEAM,
                               max_words=MAX_WORDS)
        want = _eager(beam._rows_search_fn, decoder, table, idx,
                      beam_width=BEAM, max_words=MAX_WORDS)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert graphs.stats == {"captures": 2, "replays": 2}


def test_toy_launches_count_once_per_call(fake_cuda, monkeypatch):
    """The first call counts its own launches; the warm-up and the
    capture at the second leave the counters as they found them; each
    call from the second on adds the launches recorded at capture once,
    by route."""
    for fn in (fused_lstm_step, topk_logsumexp):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "launches_by_route",
                            dict.fromkeys(fn.launches_by_route, 0))
    seen = []

    def body(x):
        seen.append(_counts()[:2])
        launches.count(fused_lstm_step, "wgmma")
        launches.count(fused_lstm_step, "wgmma")
        launches.count(topk_logsumexp, "block")
        return x * 2

    owner = torch.nn.Linear(2, 2)
    for call in range(1, 5):
        out = graphs.run(owner, ("toy",), body, (torch.ones(3),))
        torch.testing.assert_close(out, torch.full((3,), 2.0))
        assert _counts()[:2] == (2 * call, call)
        assert fused_lstm_step.launches_by_route["wgmma"] == 2 * call
        assert topk_logsumexp.launches_by_route["block"] == call
    # the eager call, then the warm-up and the capture: nothing counted
    assert seen == [(0, 0), (2, 1), (2, 1)]


def test_search_launches_count_once_per_call(small, fake_cuda, counting):
    """The searches' kernels: 2 LSTM and 1 top-k launches a step, whether
    the call ran eagerly, captured or replayed."""
    decoder = _decoder(small)
    feats = torch.from_numpy(small[3][0].reshape(6, -1))
    _eager(beam.beam_search_fn, decoder, feats, beam_width=BEAM,
           max_words=MAX_WORDS)
    assert _counts() == (2 * STEPS, STEPS, 0)
    for call in range(2, 5):
        beam.beam_search(decoder, feats, beam_width=BEAM,
                         max_words=MAX_WORDS)
        assert _counts() == (2 * STEPS * call, STEPS * call, 0)
    (entry,) = graphs.graphs(decoder)
    assert entry.launches == {(fused_lstm_step, "fma"): 2 * STEPS,
                              (topk_logsumexp, "block"): STEPS}


def test_capture_error_raises_and_runs_no_eager_loop(small, fake_cuda,
                                                     monkeypatch):
    """A capture that fails raises; the search is not run eagerly instead,
    nothing is cached or counted, and the next call tries to capture
    again."""
    decoder = _decoder(small)
    feats = torch.from_numpy(small[3][0].reshape(6, -1))
    beam.beam_search(decoder, feats, beam_width=BEAM, max_words=MAX_WORDS)
    calls = []
    real = beam.beam_search_fn

    def body(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(beam, "beam_search_fn", body)
    fake_cuda.fail = True
    before = _counts()
    for attempt in (1, 2):
        with pytest.raises(RuntimeError, match="capture failed"):
            beam.beam_search(decoder, feats, beam_width=BEAM,
                             max_words=MAX_WORDS)
        assert len(calls) == 2 * attempt      # warm-up and capture only
    assert graphs.graphs(decoder) == [] and _counts() == before
    assert graphs.stats == {"captures": 0, "replays": 0}


def test_cpu_tensors_never_enter_the_cache(small, monkeypatch):
    """With the real ``graphs.enabled``, CPU tensors run the eager bodies:
    no graph API is touched and no cache holds a graph."""
    def refuse(*args, **kwargs):
        raise AssertionError("graph API used for CPU tensors")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setattr(graphs, "stats", {"captures": 0, "replays": 0})
    decoder = _decoder(small)
    feats = torch.from_numpy(small[3][0].reshape(6, -1))
    encoder = _encoder()
    pixels = torch.from_numpy(_pixels(0, 1, 2))
    avg = torch.full((224, 224, 3), 100.0)
    for _ in range(2):
        beam.beam_search(decoder, feats, beam_width=BEAM,
                         max_words=MAX_WORDS)
        beam.greedy_search(decoder, feats, max_words=MAX_WORDS)
        beam.search(decoder, feats, beam_width=BEAM, max_words=MAX_WORDS)
        beam.rows_search(decoder, feats, torch.arange(6), beam_width=BEAM,
                         max_words=MAX_WORDS)
        torch_vgg.vgg16_fc7(encoder, pixels[0].float())
        torch_images.normalize_and_fc7(encoder, pixels, avg)
        torch_images.images_to_fc7(encoder, pixels[0], avg)
    assert graphs.graphs(decoder) == graphs.graphs(encoder) == []
    assert graphs.stats == {"captures": 0, "replays": 0}


def test_each_stream_replays_graphs_of_its_own(small, fake_cuda):
    """Two streams (a mesh's two shards on one card share a replica)
    replay graphs of their own, each captured and replayed on a graph
    stream of its own: cuBLAS's workspace is per capture stream, and two
    graphs replaying at once must not share one.  A later capture for a
    stream uses its graph stream again."""
    decoder = _decoder(small)
    feats = [torch.from_numpy(f.reshape(6, -1)) for f in small[3]]
    shards = [FakeStream(11), FakeStream(12)]
    for stream in shards * 3:
        fake_cuda.current = stream
        got = beam.greedy_search(decoder, feats[0], max_words=MAX_WORDS)
        want = _eager(beam.greedy_search_fn, decoder, feats[0],
                      max_words=MAX_WORDS)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert graphs.stats == {"captures": 2, "replays": 4}
    assert [g.stream for g in graphs.graphs(decoder)] == [11, 12]
    assert [g.replays for g in graphs.graphs(decoder)] == [2, 2]
    first, second = fake_cuda.captured_on
    assert first is not second
    for g in graphs.graphs(decoder):
        assert g.graph.replayed_on == [g.side] * 2
    fake_cuda.current = shards[0]
    for _ in range(2):
        beam.greedy_search(decoder, feats[0][:4], max_words=MAX_WORDS)
    assert fake_cuda.captured_on[2] is first


def test_graph_streams_stay_distinct_past_the_stream_pool(small,
                                                          monkeypatch):
    """torch hands out a pool of 32 streams in turn.  With draws
    elsewhere (collectives, other code) between them, so that the pool
    comes round to the shards' streams again, the shards' streams and the
    graph streams that ``new_stream`` hands out are still distinct from
    each other, and each graph is captured and replayed on its own graph
    stream, never on a stream that another graph or caller uses."""
    state = _stub_graph_api(monkeypatch, pool_streams=32)
    for _ in range(40):
        torch.cuda.Stream(CPU)
    callers = [graphs.new_stream(CPU) for _ in range(3)]
    for _ in range(32 - len(callers)):
        torch.cuda.Stream(CPU)
    # the pool's next stream is the first shard's
    assert torch.cuda.Stream(CPU).cuda_stream == callers[0].cuda_stream
    for _ in range(31):
        torch.cuda.Stream(CPU)
    callers.append(FakeStream(7))           # the default stream
    decoders = [_decoder(small) for _ in callers]
    feats = torch.from_numpy(small[3][0].reshape(6, -1))
    for _ in range(3):
        for stream, decoder in zip(callers, decoders):
            state.current = stream
            beam.greedy_search(decoder, feats, max_words=MAX_WORDS)
    entries = [g for d in decoders for g in graphs.graphs(d)]
    sides = [g.side.cuda_stream for g in entries]
    caller_handles = [s.cuda_stream for s in callers]
    assert len(entries) == len(callers)
    assert len(set(sides + caller_handles)) == 2 * len(callers)
    for g in entries:
        assert g.graph.stream is g.side
        assert g.graph.replayed_on == [g.side] * 2


def test_a_module_copy_starts_with_no_graphs(small, fake_cuda):
    """``copy.deepcopy`` (the mesh's replicas) gives a module of its own
    cache: the copy captures its own graphs."""
    decoder = _decoder(small)
    feats = torch.from_numpy(small[3][0].reshape(6, -1))
    for _ in range(2):
        beam.greedy_search(decoder, feats, max_words=MAX_WORDS)
    replica = copy.deepcopy(decoder)
    assert graphs.graphs(replica) == []
    for _ in range(2):
        beam.greedy_search(replica, feats, max_words=MAX_WORDS)
    assert len(graphs.graphs(decoder)) == len(graphs.graphs(replica)) == 1
    assert graphs.stats["captures"] == 2


# --- the encoder ---


def _encoder(fc_dim: int = 16):
    gen = torch.Generator().manual_seed(4)
    params = torch_vgg.init_vgg_params(gen, width_multiplier=0.05,
                                       fc_dim=fc_dim)
    for k in torch_vgg.PARAM_KEYS:       # nonzero biases
        if k.endswith("/b"):
            params[k].data.normal_(0.0, 0.1, generator=gen)
    return params.encoder(torch.float32)


def _pixels(seed: int, *lead) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (*lead, 224, 224, 3)).astype(np.uint8)


def test_encoder_entry_points_capture_once(fake_cuda):
    """``vgg16_fc7``, ``vgg16_fc7_grouped``, ``normalize_and_fc7`` and the
    service's ``images_to_fc7``: one graph each, every call equal to its
    eager body."""
    encoder = _encoder()
    avg = torch.from_numpy(np.random.default_rng(9).uniform(
        90, 130, (224, 224, 3)).astype(np.float32))
    norm = lambda p: torch_images.normalize_batch(p, avg)
    cases = {
        "fc7": (lambda p: torch_vgg.vgg16_fc7(encoder, norm(p[0])),
                lambda p: torch_vgg.vgg16_fc7_fn(encoder, norm(p[0]))),
        "grouped": (
            lambda p: torch_vgg.vgg16_fc7_grouped(encoder, norm(p)),
            lambda p: torch.stack([torch_vgg.vgg16_fc7_fn(encoder, b)
                                   for b in norm(p)])),
        "normalize_fc7": (
            lambda p: torch_images.normalize_and_fc7(encoder, p, avg),
            lambda p: torch_images._normalize_and_fc7_fn(encoder, p, avg)),
        "images_fc7": (
            lambda p: torch_images.images_to_fc7(encoder, p[0], avg),
            lambda p: torch_vgg.l1_normalize(
                torch_vgg.vgg16_fc7_fn(encoder, norm(p[0])))),
    }
    for graphed, eager in cases.values():
        for seed in (1, 2, 3):
            pixels = torch.from_numpy(_pixels(seed, 2, 2))
            torch.testing.assert_close(graphed(pixels), eager(pixels),
                                       rtol=0, atol=0)
    assert graphs.stats == {"captures": len(cases),
                            "replays": 2 * len(cases)}
    assert len(graphs.graphs(encoder)) == len(cases)


# --- the service and the writer ---


@pytest.fixture(scope="module")
def served():
    """A decoder at the encoder's fc width, its vocabulary and a store."""
    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=16, compute_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_lrcn.init_params(
        jax.random.PRNGKey(0), cfg))
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    rng = np.random.default_rng(5)
    store = FeatureStore.from_dict(
        {100 + i: np.abs(rng.standard_normal(16)).astype(np.float32)
         for i in range(24)}, normalized=False)
    return cfg, tree, vocab, store


def _service(served, **kw):
    cfg, tree, vocab, store = served
    return CaptionService(cfg, params_from_numpy(tree, CPU, torch.float32),
                          vocab, device=CPU, store=store, vgg=_encoder(),
                          beam_width=2, max_words=MAX_WORDS, decode_batch=2,
                          encode_batch=2, max_burst_groups=2, **kw)


def _answer(svc, store):
    ids = store.ids()
    feats = list(store.table()[:5] * 3.0)
    images = list(_pixels(3, 3))
    return (svc.caption_ids(ids[:1]), svc.caption_ids(ids[1:4]),
            svc.caption_ids(ids[4:8]), svc.caption_features(feats[:1]),
            svc.caption_features(feats), svc.caption_images(images))


def test_service_captures_every_shape_at_warmup(served):
    """``warmup()`` captures each burst size of the id and feature paths
    and the encoder batch; requests after it replay only, and answer as
    the eager service does."""
    store = served[3]
    eager_svc = _service(served)
    try:
        want = _answer(eager_svc, store)
    finally:
        eager_svc.close()

    with pytest.MonkeyPatch.context() as mp:
        state = _stub_graph_api(mp)
        svc = _service(served)
        try:
            svc.warmup()
            # ids: 2 burst sizes; features: 2; the encoder batch: 1
            assert graphs.stats["captures"] == 5
            assert {g.key for g in graphs.graphs(svc.decoder)} == {
                ("rows", 2, MAX_WORDS), ("search", 2, MAX_WORDS)}
            assert [g.key for g in graphs.graphs(svc.vgg)] == [
                ("images_fc7",)]
            replays = graphs.stats["replays"]
            got = _answer(svc, store)
            assert graphs.stats["captures"] == 5
            assert graphs.stats["replays"] > replays
        finally:
            svc.close()
    assert state.modes == ["thread_local"] * 5
    assert got == want


@pytest.mark.parametrize("beam_width,resident", [(BEAM, False), (1, True)])
def test_generate_captions_in_flight_match(served, fake_cuda, beam_width,
                                           resident):
    """Groups padded to one shape capture once a run, at its second
    search (a resident store is a table of the run's own, so each run
    searches eagerly first and captures its own graph); with
    several searches in flight before the first fetch, every line is that
    of one search in flight at a time and of the eager run."""
    cfg, tree, vocab, store = served
    decoder = params_from_numpy(tree, CPU, torch.float32)
    ids = store.ids()[:11]
    run = functools.partial(generate_captions, decoder, vocab, store, ids,
                            device=CPU, beam_width=beam_width,
                            max_words=MAX_WORDS, batch_size=2, scan_depth=2,
                            resident_store=resident)
    lines = {n: run(max_inflight=n) for n in (1, 3)}
    # 3 searches a run
    assert graphs.stats == ({"captures": 2, "replays": 4} if resident else
                            {"captures": 1, "replays": 5})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "enabled", lambda x: False)
        want = run(max_inflight=1)
    assert lines[1] == lines[3] == want
