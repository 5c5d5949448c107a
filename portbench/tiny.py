"""Cells cut to a size that a CPU test run holds.

``tiny_cell(name)`` is the cell of ``BENCHMARK.json`` with its
configuration narrowed (every width a few units, VGG-16's layout kept at
224 x 224) and its traffic's sizes shrunk, in float32 so that a sound run
reads gaps of round-off alone.  Everything else, the driver and its
check included, is the cell's own.
"""

from __future__ import annotations

from portbench.harness import spec

CONFIG = {"hidden": [16, 16], "embed": 16, "factor_dim": 8,
          "cnn_feature_dim": 32, "vocab_size": 50, "fc6_dim": 16,
          "fc7_bias": 0.3,      # about fc7's spread at these widths
          "compute_dtype": "float32",
          "serving_init": {"gains": {"w_cnn": 10.0, "embedding": 3.0,
                                     "w_out": 4.0},
                           "eos_counter": {"gate_bias": 6.0, "rate": 0.1,
                                           "eos_weight": 10.0,
                                           "eos_bias": -6.0}},
          "vgg_widths": [8, 8, "pool", 8, 8, "pool", 8, 8, 8, "pool",
                         8, 8, 8, "pool", 8, 8, 8, "pool"]}
TRAFFIC = {
    "generate": {"images": 40, "max_words": 8, "check_captions": 40},
    "caption_images": {"images": 20, "extract_batch": 8,
                       "extract_scan_depth": 2, "max_words": 8,
                       "check_captions": 6},
    "train_joint": {"batch": 4, "min_len": 3, "max_len": 6,
                    "steps_per_dispatch": 2, "image_pool": 32,
                    "epoch_batches": 4, "block_rows": 2},
    "train_decoder": {"batch": 8, "min_len": 3, "max_len": 6,
                      "steps_per_dispatch": 2, "table_rows": 64,
                      "epoch_batches": 4},
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cell.config = {**cell.config, **{k: v for k, v in CONFIG.items()
                                     if k in cell.config}}
    cell.traffic = {**cell.traffic, **TRAFFIC[cell.traffic["driver"]]}
    return cell
