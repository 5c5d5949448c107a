"""The MoE text decoder on the port's generation path, on the CPU at a
tiny size: its beam search against the plain reference's
(``portbench/reference/kimi_vl_text.py``), the search as one captured
program (through ``test_torch_graphs``'s stubbed graph API),
``generate_captions`` with the resident table, and ``lrcn-torch
generate`` from a checkpoint; and the top-k kernel's plain path at a
vocabulary above 65,535."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from lrcn_tpu_torch import cli
from lrcn_tpu_torch.config import MoETextConfig
from lrcn_tpu_torch.core.vocab import Vocab, detokenize_batch
from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.decode import beam
from lrcn_tpu_torch.decode.writer import generate_captions
from lrcn_tpu_torch.models import moe_text
from lrcn_tpu_torch.ops.kernels import topk_logsumexp
from lrcn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from portbench.reference import kimi_vl_text as ref
from test_torch_graphs import _stub_graph_api
from test_torch_moe_text import TINY, tiny_params

MAX_WORDS = 7


@pytest.fixture(scope="module")
def tiny():
    cfg = MoETextConfig(**TINY)
    params = tiny_params(cfg, seed=11)
    return cfg, params, moe_text.MoETextDecoder(cfg, params, torch.float32)


def _rows(n: int, seed: int = 12) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.random((n, TINY["cnn_feature_dim"]), dtype=np.float32)
    return x / x.sum(1, keepdims=True)


def _lines(tokens: torch.Tensor, cfg: MoETextConfig) -> list[str]:
    return detokenize_batch(tokens.numpy(), _vocab(cfg))


def _vocab(cfg: MoETextConfig) -> Vocab:
    return Vocab([f"w{i}" for i in range(3, cfg.vocab_size)])


@pytest.mark.parametrize("beam_width", [3, 1])
def test_beam_search_equals_the_reference(tiny, beam_width):
    """Exact tokens at float32, the cache's reorder by parent included
    (beam 3), and greedy out of the same code (beam 1)."""
    cfg, params, dec = tiny
    feats = torch.from_numpy(_rows(5))
    tokens, scores = beam.search(dec, feats, beam_width=beam_width,
                                 max_words=MAX_WORDS)
    words, want = ref.beam_search(params, dataclasses.asdict(cfg), feats,
                                  beam_width, MAX_WORDS)
    assert tokens.shape == (5, MAX_WORDS + 2)
    assert (tokens[:, 0] == 1).all()
    for row, w in zip(tokens.tolist(), words):
        got = row[1:]
        assert got[:len(w)] == w
    torch.testing.assert_close(scores, want, rtol=0, atol=1e-4)


def test_a_cache_left_unordered_changes_the_captions(tiny, monkeypatch):
    """The reorder is what keeps each hypothesis's history: without it the
    beam's captions differ from the reference's."""
    cfg, params, dec = tiny
    feats = torch.from_numpy(_rows(5))
    want, _ = beam.search(dec, feats, beam_width=3, max_words=MAX_WORDS)
    monkeypatch.setattr(moe_text, "reorder_cache", lambda *args: None)
    got, _ = beam.search(dec, feats, beam_width=3, max_words=MAX_WORDS)
    assert not torch.equal(got, want)


def test_the_search_is_one_captured_program(tiny, monkeypatch):
    """Captured on rows A (the expert offsets stay on the device: the
    grouped product is torch's, not the plain version's host loop) and
    replayed on rows B, the search equals the eager search of B: nothing
    in it waits for the host."""
    cfg, _, dec = tiny
    monkeypatch.setattr(moe_text, "grouped_mm", lambda x, w, offs:
                        torch._grouped_mm(x, w, offs=offs))
    a, b = (torch.from_numpy(_rows(4, seed)) for seed in (13, 14))
    want = beam.search_fn(dec, b, beam_width=3, max_words=MAX_WORDS)
    fake = _stub_graph_api(monkeypatch)
    from lrcn_tpu_torch.utils import graphs

    for feats in (a, a, b):
        got = beam.search(dec, feats, beam_width=3, max_words=MAX_WORDS)
    assert graphs.stats == {"captures": 1, "replays": 2}
    assert fake.modes == ["thread_local"]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def _store(n: int) -> tuple[FeatureStore, list[int]]:
    ids = [1000 + 7 * i for i in range(n)]
    store = FeatureStore(dim=TINY["cnn_feature_dim"], normalized=True)
    for image_id, row in zip(ids, _rows(n)):
        store.add(image_id, row)
    return store, ids


def test_generate_captions_runs_it_with_the_resident_table(tiny):
    cfg, _, dec = tiny
    store, ids = _store(11)
    lines = generate_captions(dec, _vocab(cfg), store, ids, device="cpu",
                              beam_width=3, max_words=MAX_WORDS,
                              batch_size=4, scan_depth=2,
                              resident_store=True)
    tokens, _ = beam.search(dec, torch.from_numpy(store.gather(ids)),
                            beam_width=3, max_words=MAX_WORDS)
    assert lines == _lines(tokens, cfg)
    with pytest.raises(ValueError, match="sampling"):
        generate_captions(dec, _vocab(cfg), store, ids, device="cpu",
                          sample_n=2)


def test_lrcn_torch_generate_runs_a_moe_checkpoint(tiny, tmp_path):
    cfg, params, dec = tiny
    store, ids = _store(9)
    store.save(str(tmp_path / "feats"))
    save_checkpoint(str(tmp_path / "ckpt"), params, _vocab(cfg), cfg)
    ckpt = load_checkpoint(str(tmp_path / "ckpt"), "cpu", torch.float32)
    assert isinstance(ckpt["decoder"], moe_text.MoETextDecoder)
    assert ckpt["cfg"] == cfg
    out, id_file = tmp_path / "cands.txt", tmp_path / "ids.txt"
    assert cli.main(["--device", "cpu", "generate", "--loadfile",
                     str(tmp_path / "ckpt"), "--features",
                     str(tmp_path / "feats"), "--generate", str(MAX_WORDS),
                     "--beam_width", "3", "--capnumber", "9", "--seed", "5",
                     "--compute-dtype", "float32", "--out", str(out),
                     "--ids-out", str(id_file)]) == 0
    written = [int(i) for i in id_file.read_text().split()]
    assert sorted(written) == sorted(ids)
    tokens, _ = beam.search(dec, torch.from_numpy(store.gather(written)),
                            beam_width=3, max_words=MAX_WORDS)
    assert out.read_text().splitlines() == _lines(tokens, cfg)


def test_topk_plain_path_above_65535_words():
    """The top-k op's CPU path at the decoder's vocabulary width class:
    indices past 65,535 and the log-sum-exp of a long row."""
    g = torch.Generator().manual_seed(15)
    logits = torch.randn((3, 70_001), generator=g)
    logits[0, 70_000] = 9.0
    logits[1, 65_536] = 8.0
    logits[2, [65_535, 69_999]] = 7.0                   # a tie: lower first
    vals, idx, lse = topk_logsumexp(logits, 3)
    assert idx[:, 0].tolist() == [70_000, 65_536, 65_535]
    assert idx[2, 1].item() == 69_999
    want = torch.sort(logits, dim=-1, descending=True, stable=True)
    assert torch.equal(vals, want.values[:, :3])
    assert torch.equal(idx.long(), want.indices[:, :3])
    torch.testing.assert_close(lse, torch.logsumexp(logits.double(), -1)
                               .float())
