"""The work counts and the metric readers against hand counts at small
shapes, and the trace's timeline on a made-up trace.  CPU only."""

from __future__ import annotations

import json
import os

import pytest

from portbench import work
from portbench.harness import spec
from portbench.harness.main import Run
from portbench.harness.trace import Timeline
from portbench.work import conv3x3, decoder, lstm_step, topk_lse, vgg16

PEAKS = {"bytes_s": 1e3, "flops_s": {"bf16": 1e3, "f32": 1e2}}


def config(name: str) -> dict:
    with open(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_lstm_step_cost():
    # x, h, c read (4 * 2 * 11), W (2 * 7 * 16), b (4 * 16), h', c' (2 * 4 * 8)
    assert lstm_step.cost(2, 3, 4, 2) == (88 + 224 + 64 + 64, 448, "bf16")
    assert lstm_step.cost(2, 3, 4, 4)[2] == "f32"


def test_topk_lse_cost():
    assert topk_lse.cost(2, 10, 3) == (80 + 48 + 8, 80, "f32")


def test_conv3x3_cost():
    # x (4 * 3) and y (4 * 4) at 2 bytes, w (9 * 12) at 2, b (4 * 4)
    assert conv3x3.cost(1, 2, 2, 3, 4, 2) == (2 * (28 + 108) + 16, 864,
                                              "bf16")


def test_bound_takes_the_slower_of_bytes_and_operations():
    assert work.bound_s(100, 10, "bf16", PEAKS) == 0.1
    assert work.bound_s(10, 100, "f32", PEAKS) == 1.0


def test_vgg16_macs_at_the_published_widths():
    cfg = config("lrcn-2f-vgg16-coco")
    assert len(vgg16.conv_shapes(cfg)) == 13
    assert vgg16.conv_shapes(cfg)[0] == (224, 3, 64)
    assert vgg16.forward_macs(cfg) == 15_466_168_320


def test_decoder_counts_at_the_published_widths():
    cfg = config("lrcn-coco-fc7")
    # LSTM-1 2000 x 4000, factor 1000 x 500, LSTM-2 2000 x 4000,
    # output 1000 x 8800
    assert decoder.step_macs(cfg) == 25_300_000
    assert decoder.train_step_flops(cfg, 256, 21) == 6 * (
        21 * 256 * 25_300_000 + 256 * 4096 * 500)
    assert decoder.caption_flops(cfg, 2, 11, 3) == 2 * (
        3 * 11 * 25_300_000 + 2 * 4096 * 500)


def events():
    x = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat,
                                    "ts": ts, "dur": dur}
    return [x("portbench.window", "user_annotation", 0, 100),
            x("outer", "cpu_op", 0, 100),
            x("aten::copy_", "cpu_op", 40, 20),
            x("wg::lstm_step_wgmma_kernel", "kernel", 10, 20),
            x("blk::topk_lse_block_kernel", "kernel", 20, 20),
            x("Memcpy HtoD", "gpu_memcpy", 60, 10),
            x("late_kernel", "kernel", 95, 50)]


def test_timeline_union_gaps_and_names():
    t = Timeline(events())
    assert t.window_s == pytest.approx(1e-4)
    # busy 10-40, 60-70 and 95-100 (clipped at the window's end)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.kernel_s(["lstm_step_"]) == pytest.approx(20e-6)
    b = t.breakdown()
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"outer": 35e-6, "aten::copy_": 20e-6})
    assert b["device_ops"][0] == ["wg::lstm_step_wgmma_kernel",
                                  pytest.approx(20e-6)]


def run(counts: dict, cfg: dict, traffic: dict, timeline=None) -> Run:
    return Run(config=cfg, traffic=traffic, counts=counts, window_s=2.0,
               setup_s=5.0, timeline=timeline, peaks=PEAKS)


def test_end_to_end_readers():
    r = run({"captions": 100, "steps": 4}, {}, {})
    assert spec.metric_reader("captions_per_s")(r) == 50.0
    assert spec.metric_reader("train_step_ms")(r) == 500.0
    assert spec.metric_reader("setup_s")(r) == 5.0
    assert spec.metric_reader("captions_per_s")(run({}, {}, {})) is None


def test_mfu_readers():
    cfg = config("lrcn-2f-vgg16-coco")
    traffic = {"beam_width": 3}
    r = run({"captions": 2, "caption_steps": 7, "images": 2}, cfg, traffic)
    ops = 2 * (3 * 7 * decoder.step_macs(cfg) + 2 * 4096 * 500)
    ops += 2 * 2 * vgg16.forward_macs(cfg)
    assert spec.metric_reader("mfu.caption")(r) == pytest.approx(
        100 * ops / 2.0 / 1e3)
    r = run({"steps": 3, "batch": 4, "positions": 5}, cfg, {})
    per_step = (decoder.train_step_flops(cfg, 4, 5)
                + 3 * 2 * 4 * vgg16.forward_macs(cfg))
    assert spec.metric_reader("mfu.train")(r) == pytest.approx(
        100 * 3 * per_step / 2.0 / 1e3)


def test_roofline_readers_count_needed_rows_over_kernel_time():
    cfg = {"hidden": [4, 4], "embed": 3, "factor_dim": 2, "vocab_size": 10}
    traffic = {"beam_width": 3}
    t = Timeline(events())
    r = run({"rows_by_step": [[6, 3, 0]]}, cfg, traffic, t)
    need = sum(work.bound_s(*lstm_step.cost(rows, x, 4), PEAKS)
               for rows in (6, 3) for x in (3, 4))
    assert spec.metric_reader("lstm_step_roofline")(r) == pytest.approx(
        100 * need / 20e-6)
    need = sum(work.bound_s(*topk_lse.cost(rows, 10, 3), PEAKS)
               for rows in (6, 3))
    assert spec.metric_reader("topk_lse_roofline")(r) == pytest.approx(
        100 * need / 20e-6)
    assert spec.metric_reader("conv3x3_roofline")(r) is None
    assert spec.metric_reader("lstm_step_roofline")(
        run({"rows_by_step": [[6]]}, cfg, traffic)) is None


def test_device_idle_readers():
    t = Timeline(events())
    r = run({"captions": 1}, {}, {}, t)
    assert spec.metric_reader("device_idle.caption")(r) == pytest.approx(55.0)
    assert spec.metric_reader("device_idle.train")(r) is None
