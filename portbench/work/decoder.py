"""The LRCN decoder's model operations, 2 per multiply-add.

A decode step of one hypothesis runs LSTM-1 over the word embedding
((E + H1) x 4 H1), the factor projection (H1 x F), LSTM-2 over the
concat ((2F + H2) x 4 H2) and the output projection (H2 x V); an image's
fc7 row is projected once (C x F).  A training step runs the same
products at every position of the padded batch, forward and backward
(3x the forward).  (Copied from ``chip_smoke.py``'s ``train_step_flops``.)
"""

from __future__ import annotations


def step_macs(cfg: dict) -> int:
    h1, h2 = cfg["hidden"]
    e, f, v = cfg["embed"], cfg["factor_dim"], cfg["vocab_size"]
    return e * 4 * h1 + h1 * 4 * h1 + h1 * f + (2 * f + h2) * 4 * h2 + h2 * v


def caption_flops(cfg: dict, captions: int, steps: int, beam: int) -> int:
    """Model operations of ``captions`` captions needing ``steps`` search
    steps in all: ``beam`` hypotheses a step, and each image's
    projection."""
    return 2 * (beam * steps * step_macs(cfg)
                + captions * cfg["cnn_feature_dim"] * cfg["factor_dim"])


def train_step_flops(cfg: dict, batch: int, positions: int) -> int:
    """Model operations of one training step over ``batch`` captions of
    ``positions`` steps (words + EOS)."""
    return 3 * 2 * (positions * batch * step_macs(cfg)
                    + batch * cfg["cnn_feature_dim"] * cfg["factor_dim"])
