"""Tiny runs of the MoE text decoder's cell on the CPU: the traffic file
through its driver, the window and the check, sound and then with the
program broken underneath, which the check has to see (``correct``
false).

The cell is cut to a few units a width (the config's keys narrowed, the
layout kept: one dense layer then expert layers, shared experts, the
router's bias) and run in float32, so a sound run reads round-off; the
limits are the cell's own.  The weights are drawn wider than the cell's
(``init_std`` 0.5), so that at this depth a fault moves the logits as
far as it does through the cell's 27 layers."""

from __future__ import annotations

import time

import pytest
import torch

from portbench.harness import spec
from portbench.harness.main import measure

CELL = "kimi-vl-a3b-coco-fc7-generate"
SEED = 4_200_000_123
CONFIG = {"vocab_size": 97, "hidden_size": 64, "intermediate_size": 96,
          "moe_intermediate_size": 32, "num_hidden_layers": 3,
          "num_attention_heads": 4, "n_shared_experts": 1,
          "n_routed_experts": 8, "num_experts_per_tok": 2,
          "kv_lora_rank": 16, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
          "v_head_dim": 16, "cnn_feature_dim": 24, "projector_dim": 32,
          "prompt_ids": [5, 9, 11], "compute_dtype": "float32",
          "init_std": 0.5}
TRAFFIC = {"images": 20, "max_words": 6, "check_captions": 20,
           "check_chunk": 8, "control_images": 2}


def tiny_cell() -> spec.Cell:
    cell = spec.load_cell(CELL)
    cell.config = {**cell.config, **CONFIG}
    cell.traffic = {**cell.traffic, **TRAFFIC}
    return cell


def tiny_run(seconds: float = 0.0) -> dict:
    return measure(tiny_cell(), SEED, seconds, False, "cpu", time.time())


def test_sound_run_is_correct():
    result = tiny_run(seconds=0.05)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["checks"]) == {"missing_captions", "rerun_mismatch",
                                     "score_gap", "score_deficit",
                                     "caption_gap"}
    assert result["checks"]["score_gap"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["router_weights_by_bias",
                                   "shared_dropped", "cache_not_reordered",
                                   "lse_off_by_itself"])
def test_program_faults_are_caught(fault):
    from portbench.drivers import generate_moe

    with generate_moe.planted(fault):
        result = tiny_run()
    assert not result["correct"], result["checks"]


def test_a_caption_that_never_comes_is_caught(monkeypatch):
    from lrcn_tpu_torch.decode import writer

    detokenize = writer.detokenize_batch
    monkeypatch.setattr(writer, "detokenize_batch",
                        lambda tokens, vocab: detokenize(tokens, vocab)[:-1])
    result = tiny_run()
    assert not result["correct"]
    assert result["checks"]["missing_captions"]["value"] > 0


def test_the_upper_readings_read_above_a_sound_search():
    """The tiny cell's fp8 control (its reference beam search with e4m3
    operands) and faults planted in the reference's answers come out not
    correct by the cell's limits, and read gaps far above the float32
    reference's own search, which passes them."""
    from portbench.drivers import generate_moe
    from portbench.harness.main import Context

    cell = tiny_cell()
    ctx = Context(seed=SEED, device=torch.device("cpu"), config=cell.config,
                  traffic=cell.traffic, limits=cell.limits)
    found = generate_moe.control(ctx)
    assert [c.name for c in found["sound_f32"]] == list(generate_moe.GAPS)
    assert all(c.passed and c.value < 1e-4 for c in found["sound_f32"])
    for reading in ("control_fp8", "fault_token_altered",
                    "fault_wrong_image"):
        assert not all(c.passed for c in found[reading]), (
            reading, found[reading])
        assert max(c.value for c in found[reading]) > 1e-3, reading


def test_expert_readers_on_a_tiny_run():
    """The expert counter reaches the readers: shares and roofline
    operations from a tiny run's counts."""
    from portbench.harness.main import Run
    from portbench.harness import spec as specs
    from portbench.work import moe, peaks

    cell = tiny_cell()
    from portbench.drivers import generate_moe
    from portbench.harness.main import Context

    ctx = Context(seed=SEED, device=torch.device("cpu"), config=cell.config,
                  traffic=cell.traffic, limits=cell.limits)
    work = generate_moe.setup(ctx)
    work.unit()
    counts = work.counts()
    experts = counts["experts"]
    k, e = CONFIG["num_experts_per_tok"], CONFIG["n_routed_experts"]
    hyps = counts["hypotheses"]
    # one search a pass: every token of its prefill and its max_words + 1
    # steps, in each expert layer
    assert counts["searches"] == 1
    calls = moe.layer_calls(1, TRAFFIC["max_words"])
    assert calls == 1 + TRAFFIC["max_words"] + 1
    rows = hyps * (TRAFFIC["max_words"] + 1) + (hyps // 3) * (
        1 + len(CONFIG["prompt_ids"]))
    assert [sum(tokens) for tokens in experts["tokens"]] == [k * rows] * 2
    for active, busiest in zip(experts["active"], experts["busiest"]):
        assert calls <= active <= e * calls
        assert k * rows / e <= busiest <= rows
    run = Run(config=cell.config, traffic=cell.traffic, counts=counts,
              window_s=1.0, setup_s=0.0, timeline=None, peaks=peaks())
    share = specs.metric_reader("moe.expert_tokens_max_share")(run)
    assert share == pytest.approx(100 * sum(experts["busiest"])
                                  / (2 * k * rows))
    assert 100 / e <= share <= 100 / k
    assert specs.metric_reader("moe_grouped_roofline")(run) is None
    assert specs.metric_reader("mfu.moe_caption")(run) > 0
    nbytes, ops, kind = moe.cost(cell.config, sum(experts["tokens"][0]),
                                 experts["active"][0], calls)
    assert ops == 2 * 3 * 64 * 32 * (k + 1) * rows
    assert kind == "bf16" and nbytes > 0


def test_a_path_keeps_the_words_after_an_inner_eos():
    """A hypothesis that emitted EOS and went on extending is scored on
    its whole path, up to the EOS that ended it."""
    from portbench.reference.kimi_vl_text import path_words

    assert path_words([5, 0, 7, 8, 0, 0]) == [5, 0, 7, 8]
    assert path_words([5, 6, 7]) == [5, 6, 7]
    assert path_words([0, 0, 0]) == []
