"""Tiny runs of every cell on the CPU: each traffic file through its
driver, the window and the check, sound and then with the timed path
broken underneath, which the check has to see (``correct`` false).

The cells are cut by ``tiny.py`` and run in float32, so a sound run reads
round-off; the limits are the cells' own."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.harness.main import measure
from portbench.tiny import tiny_cell

CELLS = ("coco-fc7-generate", "vgg16-coco-caption", "coco-fc7-train",
         "vgg16-coco-joint-train")
CAPTION_CELLS = CELLS[:2]
SEED = 4_200_000_123


def tiny_run(name: str, seconds: float = 0.0) -> dict:
    return measure(tiny_cell(name), SEED, seconds, False, "cpu", time.time())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = tiny_run(name, seconds=0.05)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) >= {"setup_s"}
    assert list(result)[-1] == "checks"


def test_the_same_seed_gives_the_same_readings():
    a, b = tiny_run("coco-fc7-train"), tiny_run("coco-fc7-train")
    assert a["checks"] == b["checks"]


def _alter_tokens(monkeypatch, change):
    """Wrap the search that ``generate_captions`` calls so that its tokens
    come out changed by ``change(tokens)``."""
    from lrcn_tpu_torch.decode import writer

    search = writer.rows_search

    def broken(*args, **kwargs):
        tokens, scores = search(*args, **kwargs)
        return change(tokens.clone()), scores

    monkeypatch.setattr(writer, "rows_search", broken)


def _next_word(tokens):
    vocab = tiny_cell(CELLS[0]).config["vocab_size"]
    tokens[..., 2] = 3 + (tokens[..., 2] - 2) % (vocab - 3)
    return tokens


def _next_image(tokens):
    rows = tokens.view(-1, tokens.shape[-1])
    rows[:] = torch.roll(rows, 1, dims=0)
    return tokens


@pytest.mark.parametrize("name", CAPTION_CELLS)
@pytest.mark.parametrize("fault", [_next_word, _next_image],
                         ids=["token_altered", "answers_of_other_images"])
def test_caption_faults_are_caught(monkeypatch, name, fault):
    _alter_tokens(monkeypatch, fault)
    assert not tiny_run(name)["correct"]


def _greedy(monkeypatch):
    """The search that ``generate_captions`` calls runs greedy (beam 1)."""
    from lrcn_tpu_torch.decode import writer

    search = writer.rows_search
    monkeypatch.setattr(writer, "rows_search", lambda *args, **kwargs:
                        search(*args, **{**kwargs, "beam_width": 1}))


def test_a_greedy_search_is_caught(monkeypatch):
    """Every greedy token is among the beam's 3 best: ``caption_gap``
    passes it, and ``beam_mismatch`` has to see it."""
    _greedy(monkeypatch)
    result = tiny_run(CAPTION_CELLS[0])
    assert not result["correct"], result["checks"]
    assert result["checks"]["caption_gap"]["value"] <= (
        result["checks"]["caption_gap"]["limit"])


@pytest.mark.parametrize("name", CAPTION_CELLS)
def test_a_caption_that_never_comes_is_caught(monkeypatch, name):
    from lrcn_tpu_torch.decode import writer

    detokenize = writer.detokenize_batch
    monkeypatch.setattr(writer, "detokenize_batch",
                        lambda tokens, vocab: detokenize(tokens, vocab)[:-1])
    result = tiny_run(name)
    assert not result["correct"]
    assert result["checks"]["missing_captions"]["value"] > 0


def _unchanged(monkeypatch):
    from lrcn_tpu_torch.models.joint import JointOptState
    from lrcn_tpu_torch.train.trainer import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)
    monkeypatch.setattr(JointOptState, "step", lambda self: None)


def _half_batch(monkeypatch):
    from lrcn_tpu_torch.models import joint, lrcn

    loss_fn, joint_loss = lrcn.loss_fn, joint.joint_loss_total_count

    def half(fn):
        def broken(params, a, b, c, *rest, **kwargs):
            h = a.shape[0] // 2
            return fn(params, a[:h], b[:h], c[:h], *rest, **kwargs)
        return broken

    monkeypatch.setattr(lrcn, "loss_fn", half(loss_fn))
    monkeypatch.setattr(joint, "joint_loss_total_count", half(joint_loss))


def _dispatch_broken(monkeypatch, change):
    """Wrap the K-step dispatch both trainers call so that it runs on
    ``change(seeds, inputs)``: the steps' dropout seeds and the stacked
    batches (K first)."""
    from lrcn_tpu_torch.utils import graphs

    step = graphs.step

    def broken(owner, key, fn, inputs, reads=(), seeds=(), **kwargs):
        seeds, inputs = change(list(seeds), inputs)
        return step(owner, key, fn, inputs, reads, seeds, **kwargs)

    monkeypatch.setattr(graphs, "step", broken)


def _one_key_a_dispatch(monkeypatch):
    _dispatch_broken(monkeypatch, lambda seeds, inputs: (
        seeds[:1] * len(seeds), inputs))


def _last_step_dropped(monkeypatch):
    _dispatch_broken(monkeypatch, lambda seeds, inputs: (
        seeds[:-1], tuple(x[:-1] for x in inputs)))


@pytest.mark.parametrize("name", CELLS[2:])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _one_key_a_dispatch, _last_step_dropped],
                         ids=["state_unchanged", "half_batch",
                              "one_key_a_dispatch", "last_step_dropped"])
def test_training_faults_are_caught(monkeypatch, name, fault):
    fault(monkeypatch)
    result = tiny_run(name)
    assert not result["correct"], result["checks"]


def test_no_card_no_result(monkeypatch, capsys):
    from portbench.harness import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main.main(["--workload", CELLS[0], "--seed", "1",
                      "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
