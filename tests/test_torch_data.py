"""The port's copies of the tokenizer, the batcher and the metrics logger,
and its device prefetch, against the JAX package, on the CPU.

The copies must give the JAX package's captions, vocabulary and batches
(same ids, same order from the same numpy generator): a model trained by
either package reads the other's data the same way.
"""

import json

import numpy as np
import pytest
import torch

from lrcn_tpu.core import tokenizer as jax_tok
from lrcn_tpu.data import batcher as jax_batcher
from lrcn_tpu.train.metrics import MetricsLogger as JaxMetrics
from lrcn_tpu_torch.core import tokenizer
from lrcn_tpu_torch.data import batcher
from lrcn_tpu_torch.data.pipeline import prefetch_to_device
from lrcn_tpu_torch.train.metrics import MetricsLogger

WORDS = ["a", "dog", "cat", "runs", "on", "the", "grass", "red", "ball",
         "man", "(with)", "hat,", "Two", "young", "guys", "!", "don't"]


def _caption(rng: np.random.Generator) -> str:
    n = int(rng.integers(1, 32))        # some longer than the 28-word cap
    return " ".join(rng.choice(WORDS, n)) + " ."


@pytest.fixture(scope="module")
def data_files(tmp_path_factory):
    """A synthetic Flickr ``.token`` file (2100 images x 5 captions, enough
    for the fixed 1000 + 1000 split) and two COCO json files."""
    root = tmp_path_factory.mktemp("captions")
    rng = np.random.default_rng(0)
    flickr = root / "results_20130124.token"
    with open(flickr, "w") as f:
        for img in range(2100):
            for j in range(5):
                f.write(f"{1000 + img}.jpg#{j}\t{_caption(rng)}\n")
    coco = []
    for split in ("train", "val"):
        path = root / f"captions_{split}2014.json"
        anns = [{"image_id": int(rng.integers(0, 400)),
                 "caption": _caption(rng).capitalize()} for _ in range(900)]
        path.write_text(json.dumps({"annotations": anns}))
        coco.append(str(path))
    return str(flickr), coco


@pytest.mark.parametrize("kind", ["flickr", "coco"])
def test_tokenize_matches_jax(data_files, kind):
    flickr, coco = data_files
    files = [flickr] if kind == "flickr" else coco
    vocab, lists = tokenizer.tokenize(files, min_count=3)
    jvocab, jlists = jax_tok.tokenize(files, min_count=3)
    assert vocab.words == jvocab.words and len(vocab) > 10
    assert len(lists) == len(jlists) == (3 if kind == "flickr" else 2)
    for caps, jcaps in zip(lists, jlists):
        assert [(c.image_id, c.words) for c in caps] == [
            (c.image_id, c.words) for c in jcaps]


def test_caption_parsers_match_jax():
    line = "42.jpg#3\tA (man), with don't-stop 'style' ?!\n"
    got, want = (mod.tokenize_flickr_line(line)
                 for mod in (tokenizer, jax_tok))
    assert (got.image_id, got.words) == (want.image_id, want.words)
    text = "A man, riding  a (horse)."
    assert tokenizer.tokenize_coco_caption(text) == \
        jax_tok.tokenize_coco_caption(text)
    caps = [tokenizer.Caption(1, ("cat",) * 5), tokenizer.Caption(2, ("dog",))]
    jcaps = [jax_tok.Caption(1, ("cat",) * 5), jax_tok.Caption(2, ("dog",))]
    assert tokenizer.build_vocab([caps]).words == \
        jax_tok.build_vocab([jcaps]).words


def _same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for field in ("image_ids", "tokens", "lengths"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def coco_captions(data_files):
    _, coco = data_files
    return tokenizer.tokenize(coco, min_count=3), jax_tok.tokenize(
        coco, min_count=3)


@pytest.mark.parametrize("drop_remainder", [False, True])
@pytest.mark.parametrize("small_rule", [False, True])
def test_bucket_batches_match_jax(coco_captions, drop_remainder,
                                  small_rule):
    (vocab, lists), (jvocab, jlists) = coco_captions
    kw = dict(apply_small_dataset_rule=small_rule,
              drop_remainder=drop_remainder)
    got = batcher.bucket_batches(lists[0], vocab, 25, **kw)
    want = jax_batcher.bucket_batches(jlists[0], jvocab, 25, **kw)
    _same_batches(got, want)
    assert any((b.lengths == -1).any() for b in got) != drop_remainder


def test_equal_length_batches_and_batch_size_match_jax(coco_captions):
    (vocab, lists), (jvocab, jlists) = coco_captions
    _same_batches(batcher.equal_length_batches(lists[1], vocab, 7,
                                               apply_small_dataset_rule=False),
                  jax_batcher.equal_length_batches(
                      jlists[1], jvocab, 7, apply_small_dataset_rule=False))
    for n in (10, 30000, 30001):
        assert batcher.effective_batch_size(n, 25) == \
            jax_batcher.effective_batch_size(n, 25)


@pytest.mark.parametrize("k", [1, 3])
def test_epoch_order_and_chunks_match_jax(coco_captions, k):
    """Same seed, same shuffled order and same same-shape chunks + tail."""
    (vocab, lists), (jvocab, jlists) = coco_captions
    got = batcher.bucket_batches(lists[0], vocab, 8,
                                 apply_small_dataset_rule=False)
    want = jax_batcher.bucket_batches(jlists[0], jvocab, 8,
                                      apply_small_dataset_rule=False)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    _same_batches(list(batcher.iterate_epoch(got, rng)),
                  list(jax_batcher.iterate_epoch(want, jrng)))
    chunks, tail = batcher.chunk_same_shape(got, k, rng)
    jchunks, jtail = jax_batcher.chunk_same_shape(want, k, jrng)
    assert [len(c) for c in chunks] == [len(c) for c in jchunks]
    _same_batches([b for c in chunks for b in c],
                  [b for c in jchunks for b in c])
    _same_batches(tail, jtail)
    assert all(len({(b.batch_size, b.padded_len) for b in c}) == 1
               for c in chunks)


def test_metrics_logger_matches_jax(tmp_path):
    for cls, name in ((MetricsLogger, "port"), (JaxMetrics, "jax")):
        log = cls(str(tmp_path / f"{name}.jsonl"), echo=False)
        log.log(event="epoch", epoch=1, loss=np.float32(0.5))
        log.close()
    port, jax_lines = ([json.loads(line) for line in
                        open(tmp_path / f"{n}.jsonl")] for n in ("port", "jax"))
    for a, b in zip(port, jax_lines):
        a.pop("time"), b.pop("time")
        assert a == b == {"event": "epoch", "epoch": 1, "loss": 0.5}


def test_prefetch_passes_items_through_on_the_cpu():
    """On the CPU: every item, in order, its leaves as tensors on the CPU
    (numpy arrays converted without a copy), after ``transform``."""
    items = [(np.arange(i, i + 3, dtype=np.int32),
              {"f": np.full((2,), i, np.float32), "n": i}) for i in range(7)]
    for device in (None, "cpu"):
        for size in (1, 2, 5):
            got = list(prefetch_to_device(iter(items), size=size,
                                          device=device))
            assert len(got) == len(items)
            for (a, d), (x, e) in zip(got, items):
                assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
                np.testing.assert_array_equal(a.numpy(), x)
                np.testing.assert_array_equal(d["f"].numpy(), e["f"])
                assert d["n"] == e["n"]
    doubled = list(prefetch_to_device(range(4), device="cpu",
                                      transform=lambda i: np.array([2 * i])))
    assert [int(t) for t in doubled] == [0, 2, 4, 6]


def test_prefetch_runs_the_transform_ahead():
    """``size`` items are transformed before the first is consumed, then
    one more per item taken."""
    seen = []

    def transform(i):
        seen.append(i)
        return np.array([i])

    it = prefetch_to_device(range(6), size=2, device="cpu",
                            transform=transform)
    assert seen == []
    next(it)
    assert seen == [0, 1]
    next(it)
    assert seen == [0, 1, 2]
    assert [int(t) for t in it] == [2, 3, 4, 5]
