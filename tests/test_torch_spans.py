"""The port's spans (``lrcn_tpu_torch/utils/profiling.py:span``) and the
benchmark's reading of them (``portbench/spans.py``), on the CPU.

- With no profiler recording, ``span`` is one shared no-op context and
  makes no ``RecordFunction``.
- Under ``profiling.trace``, ``generate_captions``, ``extract_features``
  (its image loader stubbed as ``portbench/drivers/caption_images.py``
  stubs it) and a decoder ``train_epoch`` write each span they name into
  the Chrome trace, each inside the span that encloses it in the code; the
  graph dispatch's spans come from ``test_torch_graphs.py``'s stubbed
  graph API; no captured body opens a program span, and no exported
  program holds a profiler op.
- ``portbench.spans`` splits hand-built timelines into known shares.
"""

import glob
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from lrcn_tpu_torch import export
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data import images
from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.decode.writer import generate_captions
from lrcn_tpu_torch.models import vgg
from lrcn_tpu_torch.models.lrcn import init_params
from lrcn_tpu_torch.utils import graphs, profiling
from test_torch_graphs import _stub_graph_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import spans  # noqa: E402
from portbench.harness import main as bench_main  # noqa: E402
from portbench.harness import spec  # noqa: E402
from portbench.harness.trace import WINDOW, Timeline  # noqa: E402
from portbench.tiny import tiny_cell  # noqa: E402

CPU = torch.device("cpu")
MAX_WORDS = 5
# span -> the span that encloses it in the code (None: a whole call)
PARENT = {
    "lrcn.generate": None,
    "lrcn.generate.table": "lrcn.generate",
    "lrcn.generate.enqueue": "lrcn.generate",
    "lrcn.generate.fetch": "lrcn.generate",
    "lrcn.generate.detokenize": "lrcn.generate",
    "lrcn.extract": None,
    "lrcn.extract.wait_decode": "lrcn.extract",
    "lrcn.extract.upload": "lrcn.extract",
    "lrcn.extract.readback": "lrcn.extract",
    "lrcn.extract.store": "lrcn.extract",
    "lrcn.train.epoch": None,
    "lrcn.train.batch": "lrcn.train.epoch",
    "lrcn.train.log": "lrcn.train.epoch",
    "lrcn.train.sync": "lrcn.train.epoch",
    "lrcn.train.wait_data": "lrcn.train.epoch",
}


# --- the primitive ---


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    """No profiler records: every span is the same no-op context, and
    entering it constructs and enters no ``record_function``."""
    made = []

    class Counting(torch.profiler.record_function):
        def __init__(self, *args, **kwargs):
            made.append(args)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Counting)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("lrcn.a"), profiling.span("lrcn.b")
    assert a is b is profiling._NO_SPAN
    with a, b:
        torch.ones(4).sum()
    assert made == []
    with torch.profiler.profile():
        with profiling.span("lrcn.c"):
            pass
    assert made == [("lrcn.c",)]


def test_span_without_a_profiler_calls_no_op(monkeypatch):
    """The no-op context dispatches nothing: the profiler's enter and
    exit ops are never called."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Seen(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    with Seen():
        with profiling.span("lrcn.a"):
            pass
    assert seen == []


def _trace_spans(logdir) -> list[dict]:
    """The ``lrcn.*`` spans of the one Chrome trace in ``logdir``."""
    (path,) = glob.glob(os.path.join(str(logdir), "*.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [{"name": e["name"], "tid": e["tid"], "start": float(e["ts"]),
             "end": float(e["ts"]) + float(e["dur"])}
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("lrcn.")]


def _parent(s: dict, found: list[dict]) -> str | None:
    """The innermost span that holds ``s`` on its thread."""
    holders = [p for p in found if p is not s and p["tid"] == s["tid"]
               and p["start"] <= s["start"] and s["end"] <= p["end"]]
    if not holders:
        return None
    return max(holders, key=lambda p: (p["start"], -p["end"]))["name"]


def _parents(found: list[dict]) -> dict[str, set]:
    out: dict[str, set] = {}
    for s in found:
        out.setdefault(s["name"], set()).add(_parent(s, found))
    return out


def test_span_records_on_another_thread(tmp_path):
    """``profiling.trace`` records every thread, and a span opened on a
    thread nests under that thread's spans only."""
    import threading

    def work():
        with profiling.span("lrcn.test.thread"):
            torch.ones(8).sum()

    with profiling.trace(str(tmp_path), device="cpu"):
        with profiling.span("lrcn.test.main"):
            worker = threading.Thread(target=work)
            worker.start()
            worker.join()
    found = _trace_spans(tmp_path)
    assert _parents(found) == {"lrcn.test.main": {None},
                               "lrcn.test.thread": {None}}
    assert len({s["tid"] for s in found}) == 2


# --- the program's spans ---


def _decoder_and_vocab(cnn: int = 10):
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=cnn,
                     vocab_size=25)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    return params.decoder(torch.float32), vocab


def _store(n: int, dim: int = 10) -> FeatureStore:
    rng = np.random.default_rng(5)
    return FeatureStore.from_dict(
        {100 + i: np.abs(rng.standard_normal(dim)).astype(np.float32)
         for i in range(n)})


@pytest.mark.parametrize("resident", [True, False])
def test_generate_captions_spans(tmp_path, resident):
    """Three groups: one ``enqueue``, ``fetch`` and ``detokenize`` each,
    all inside ``lrcn.generate``; ``table`` once, with the resident
    table only."""
    decoder, vocab = _decoder_and_vocab()
    store = _store(12)
    with profiling.trace(str(tmp_path), device="cpu"):
        lines = generate_captions(decoder, vocab, store, store.ids(),
                                  device=CPU, beam_width=2,
                                  max_words=MAX_WORDS, batch_size=2,
                                  scan_depth=2, resident_store=resident)
    assert len(lines) == 12
    found = _trace_spans(tmp_path)
    names = [s["name"] for s in found]
    for phase in ("enqueue", "fetch", "detokenize"):
        assert names.count(f"lrcn.generate.{phase}") == 3
    assert names.count("lrcn.generate") == 1
    assert names.count("lrcn.generate.table") == int(resident)
    for name, parents in _parents(found).items():
        assert parents == {PARENT[name]}, name


def _encoder(fc_dim: int = 16):
    params = vgg.init_vgg_params(torch.Generator().manual_seed(4),
                                 width_multiplier=0.05, fc_dim=fc_dim)
    return params.encoder(torch.float32)


def test_extract_features_spans(tmp_path, monkeypatch):
    """Five images in batches of 2, groups of 2 batches: two groups, each
    with its four spans inside ``lrcn.extract``; the loader hands over
    arrays by path, as ``portbench/drivers/caption_images.py`` does."""
    pixels = np.random.default_rng(1).integers(
        0, 256, (5, 224, 224, 3)).astype(np.uint8)
    monkeypatch.setattr(images, "load_images",
                        lambda paths: pixels[[int(p) for p in paths]])
    paths = {200 + i: str(i) for i in range(5)}
    with profiling.trace(str(tmp_path), device="cpu"):
        store = images.extract_features(
            paths, _encoder(), np.full((224, 224, 3), 117.0, np.float32),
            batch_size=2, scan_depth=2)
    assert sorted(store.ids()) == sorted(paths)
    found = _trace_spans(tmp_path)
    names = [s["name"] for s in found]
    assert names.count("lrcn.extract") == 1
    for phase in ("wait_decode", "upload", "readback", "store"):
        assert names.count(f"lrcn.extract.{phase}") == 2
    for name, parents in _parents(found).items():
        assert parents == {PARENT[name]}, name


def _context(name: str):
    cell = tiny_cell(name)
    return bench_main.Context(seed=4_200_000_123, device=CPU,
                              config=cell.config, traffic=cell.traffic,
                              limits=cell.limits, started=time.time())


def test_decoder_train_epoch_spans(tmp_path):
    """One epoch of the benchmark's decoder cell at its tiny size (4
    batches, 2 a dispatch): a ``batch`` each dispatch, the first
    dispatch's ``log``, the closing ``sync`` and the epoch's ``log``,
    inside ``lrcn.train.epoch``."""
    work = spec.driver("train_decoder").Work(_context("coco-fc7-train"))
    with profiling.trace(str(tmp_path), device="cpu"):
        work.unit()
    found = _trace_spans(tmp_path)
    names = [s["name"] for s in found]
    assert names.count("lrcn.train.epoch") == 1
    assert names.count("lrcn.train.batch") == 2
    assert names.count("lrcn.train.log") == 2
    assert names.count("lrcn.train.sync") == 1
    for name, parents in _parents(found).items():
        assert parents == {PARENT[name]}, name


def test_joint_train_epoch_waits_for_data_in_spans(tmp_path):
    """The joint trainer's feed: a ``wait_data`` and a ``batch`` each
    dispatch, inside ``lrcn.train.epoch`` (no ``sync`` on the CPU)."""
    work = spec.driver("train_joint").Work(
        _context("vgg16-coco-joint-train"))
    with profiling.trace(str(tmp_path), device="cpu"):
        work.unit()
    found = _trace_spans(tmp_path)
    names = [s["name"] for s in found]
    assert names.count("lrcn.train.epoch") == 1
    assert names.count("lrcn.train.wait_data") == 2
    assert names.count("lrcn.train.batch") == 2
    for name, parents in _parents(found).items():
        assert parents == {PARENT[name]}, name


def _program_spans(graph) -> list[str]:
    """The program's spans opened inside a captured body (torch's own
    ranges, as the optimizer's step, are host work a CUDA graph never
    holds)."""
    return [args[0] for func, args, *_ in graph.ops
            if "record_function_enter" in str(func)
            and str(args[0]).startswith("lrcn.")]


def test_graph_spans_in_generate(tmp_path, monkeypatch):
    """Under the stubbed graph API, four groups of one shape: the first
    searches eagerly, the second captures and replays, the others
    replay; each inside its group's ``enqueue``, and the captured body
    opens no span though a profiler recorded the capture."""
    _stub_graph_api(monkeypatch)
    decoder, vocab = _decoder_and_vocab()
    store = _store(16)
    with profiling.trace(str(tmp_path), device="cpu"):
        generate_captions(decoder, vocab, store, store.ids(), device=CPU,
                          beam_width=2, max_words=MAX_WORDS, batch_size=2,
                          scan_depth=2, resident_store=False)
    found = _trace_spans(tmp_path)
    names = [s["name"] for s in found]
    assert [names.count(f"lrcn.graph.{p}")
            for p in ("eager", "capture", "replay")] == [1, 1, 3]
    parents = _parents(found)
    for phase in ("eager", "capture", "replay"):
        assert parents.pop(f"lrcn.graph.{phase}") == {
            "lrcn.generate.enqueue"}
    for name, p in parents.items():
        assert p == {PARENT[name]}, name
    (entry,) = graphs.graphs(decoder)
    assert entry.graph.ops and _program_spans(entry.graph) == []


def test_graph_spans_in_training(tmp_path, monkeypatch):
    """Under the stubbed graph API the decoder cell's set-up runs the
    dispatch eagerly, captures it and replays it, each ``lrcn.graph.*``
    span inside ``lrcn.train.epoch``; an epoch of the window replays
    only.  The captured step opens no span of the program."""
    _stub_graph_api(monkeypatch)
    with profiling.trace(str(tmp_path / "setup"), device="cpu"):
        work = spec.driver("train_decoder").Work(_context("coco-fc7-train"))
    found = _trace_spans(tmp_path / "setup")
    names = [s["name"] for s in found]
    assert names.count("lrcn.graph.eager") == 1
    assert names.count("lrcn.graph.capture") == 1
    assert names.count("lrcn.graph.replay") >= 1
    for s in found:
        if s["name"].startswith("lrcn.graph."):
            assert _parent(s, found) == "lrcn.train.epoch"
    with profiling.trace(str(tmp_path / "window"), device="cpu"):
        work.unit()
    names = [s["name"] for s in _trace_spans(tmp_path / "window")]
    assert names.count("lrcn.graph.replay") == 2
    assert "lrcn.graph.capture" not in names
    assert "lrcn.graph.eager" not in names
    for entry in graphs.graphs(work.opt):
        assert entry.graph.ops and _program_spans(entry.graph) == []


def test_exported_program_holds_no_profiler_op(tmp_path):
    """A beam program exported while a profiler records: no node of its
    graph is a profiler op."""
    decoder, _ = _decoder_and_vocab()
    with profiling.trace(str(tmp_path), device="cpu"):
        program = export.export_decoder(decoder, variant="beam",
                                        beam_width=2, max_words=3)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert any("lrcn.lstm_step" in t for t in targets)
    assert not [t for t in targets
                if "profiler" in t or "record_function" in t]


# --- portbench.spans on hand-built timelines ---


def _timeline(host, kernels, window=(0.0, 1000.0)) -> Timeline:
    """A timeline of a window, program spans or torch ops ``host`` as
    (name, start, end) and device kernels as (start, end)."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": window[0], "dur": window[1] - window[0]}]
    for name, start, end in host:
        cat = "user_annotation" if name.startswith("lrcn.") else "cpu_op"
        events.append({"ph": "X", "cat": cat, "name": name, "ts": start,
                       "dur": end - start})
    for start, end in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": start, "dur": end - start})
    return Timeline(events)


def _run(timeline):
    return bench_main.Run(config={}, traffic={}, counts={}, window_s=1.0,
                          setup_s=0.0, timeline=timeline, peaks={})


def _us(split: dict) -> dict:
    return {k: round(v * 1e6, 6) for k, v in split.items() if v}


def test_split_nested_spans():
    """Gaps 10-30 and 40-60 around a child 20-50 inside a parent 0-100:
    the child holds 10 + 10 us, the parent the rest."""
    t = _timeline([("lrcn.a", 0, 100), ("lrcn.a.b", 20, 50)],
                  [(0, 10), (30, 40), (60, 1000)])
    assert _us(spans.idle_by_span(t)) == {"lrcn.a": 20.0, "lrcn.a.b": 20.0}
    assert spans.idle_share(_run(t), ("lrcn.a.b",)) == pytest.approx(2.0)


def test_split_gap_across_two_spans_and_under_none():
    """A gap 40-70 across spans 0-50 and 50-100 splits 10 : 20; a gap
    200-250 under no span goes to None."""
    t = _timeline([("lrcn.x", 0, 50), ("lrcn.y", 50, 100)],
                  [(0, 40), (70, 200), (250, 1000)])
    assert _us(spans.idle_by_span(t)) == {"lrcn.x": 10.0, "lrcn.y": 20.0,
                                          None: 50.0}
    assert spans.idle_share(_run(t), ("lrcn.x", "lrcn.y")) == (
        pytest.approx(3.0))


def test_split_finds_a_span_that_began_300_events_before_the_gap():
    """A span that opened before 300 torch ops and 300 short program
    spans still holds a gap after them (the breakdown's 256-event
    look-back loses it), and torch ops never take its place."""
    host = [("lrcn.outer", 0, 900)]
    host += [(f"aten::op{i}", 1 + i, 1.5 + i) for i in range(300)]
    host += [("lrcn.outer.inner", 301 + i, 301.5 + i) for i in range(300)]
    t = _timeline(host, [(0, 700), (800, 1000)])
    assert _us(spans.idle_by_span(t)) == {"lrcn.outer": 100.0}
    assert t.breakdown()["idle_gaps"][0][0] == "host outside traced ops"
    assert spans.idle_share(_run(t), ("lrcn.outer.inner",)) == 0.0


def test_split_of_spans_that_start_together_and_outlast_the_window():
    """Of two spans that start together the shorter is the inner one; a
    span is cut to the window."""
    t = _timeline([("lrcn.p", -50, 40), ("lrcn.p.c", -50, 20)],
                  [(40, 1000)])
    assert _us(spans.idle_by_span(t)) == {"lrcn.p.c": 20.0, "lrcn.p": 20.0}


def test_a_trace_without_program_spans_reads_none():
    """The parent commit's program writes no span: every ``idle_in.*``
    reads None, as does a run without a trace."""
    t = _timeline([("aten::mm", 0, 500)], [(600, 700)])
    assert spans.idle_by_span(t) == {}
    names = [m["name"] for m in _bench()["per_layer"]
             if m["name"].startswith("idle_in.")]
    for name in names:
        read = spec.metric_reader(name)
        assert read(_run(t)) is None
        assert read(_run(None)) is None


def _bench() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


READS = {"idle_in.generate_table": ("lrcn.generate.table",),
         "idle_in.generate_detokenize": ("lrcn.generate.detokenize",),
         "idle_in.extract_upload": ("lrcn.extract.upload",),
         "idle_in.extract_store": ("lrcn.extract.store",),
         "idle_in.train_data": ("lrcn.train.batch", "lrcn.train.wait_data"),
         "idle_in.graph_replay": ("lrcn.graph.replay",)}


@pytest.mark.parametrize("name", list(READS))
def test_each_metric_reads_its_spans(name):
    """Each reader's share is the idle time under its own spans: one
    10 us gap under each span (and 10 us under its parent), in a window
    of 1000 us."""
    host, kernels, at = [], [], 0.0
    for span_name in sorted({n for v in READS.values() for n in v}):
        host += [("lrcn.whole", at, at + 40), (span_name, at + 20, at + 40)]
        kernels += [(at, at + 10), (at + 20, at + 30)]
        at += 40
    kernels.append((at, 1000.0))
    t = _timeline(host, kernels)
    entry = {m["name"]: m for m in _bench()["per_layer"]}[name]
    assert entry["source"] == "program_span" and entry["unit"] == "%"
    assert spec.metric_reader(name)(_run(t)) == pytest.approx(
        len(READS[name]))
