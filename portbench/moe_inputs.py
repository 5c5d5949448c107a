"""The MoE text decoder's weights, made from ``--seed`` on the device a
tensor at a time.

Each parameter (``reference/kimi_vl_text.py:param_shapes``) has a
stream of its own, so any one of them can be made again alone: the
program takes them one by one and casts each to its compute dtype, and
the reference makes each layer's again when it computes that layer, in
float32, so neither holds the model in float32 at once.

The draw (the configuration's ``assumed``): matrices ``N(0, init_std^2)``;
RMSNorm and LayerNorm weights 1, biases 0; the router's selection bias
``N(0, sigma_s^2)``, with ``sigma_s`` the spread of the router's scores
``sigmoid(z)`` over the logits' ``z ~ N(0, init_std^2 * hidden)`` (a
normed token has unit RMS), so that the bias changes some selections
and leaves others.

``held``: the values the program holds, for the reference.  The program
keeps every matrix but the router's in its compute dtype (bf16) and the
router, norms and biases in float32 (``models/moe_text.py``); given
that dtype, ``Weights`` rounds the same matrices through it and returns
them in float32, so the reference computes the configured model.
"""

from __future__ import annotations

import math

import torch

from portbench import inputs
from portbench.reference.kimi_vl_text import param_shapes

# streams of the weights: this one plus the key's index in sorted order
WEIGHTS = 1000


def score_spread(cfg: dict) -> float:
    """The standard deviation of ``sigmoid(z)``, ``z ~ N(0, s^2)`` with
    ``s = init_std * sqrt(hidden)``, by quadrature."""
    s = cfg["init_std"] * math.sqrt(cfg["hidden_size"])
    z = torch.linspace(-10.0, 10.0, 20001, dtype=torch.float64)
    p = torch.exp(-0.5 * z * z)
    p = p / p.sum()
    y = torch.sigmoid(s * z)
    mean = (p * y).sum()
    return float((p * (y - mean) ** 2).sum().sqrt())


class Weights:
    """``weights(key)``: the float32 parameter ``key`` on ``device``,
    made from the seed (again at every call, but for ``keep``'s keys,
    which are made once and held), rounded through ``held`` where the
    program holds it so."""

    def __init__(self, cfg: dict, seed: int, device,
                 keep: tuple[str, ...] = (),
                 held: torch.dtype | None = None):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.held_dtype = held
        self.shapes = param_shapes(cfg)
        self.streams = {k: WEIGHTS + i for i, k in enumerate(
            sorted(self.shapes))}
        self.keep = set(keep)
        self.held: dict[str, torch.Tensor] = {}
        self.bias_std = score_spread(cfg)

    def __call__(self, key: str) -> torch.Tensor:
        if key in self.held:
            return self.held[key]
        value = self._make(key)
        if (self.held_dtype is not None and value.dim() >= 2
                and not key.endswith("/router")):
            value = value.to(self.held_dtype).float()
        if key in self.keep:
            self.held[key] = value
        return value

    def _make(self, key: str) -> torch.Tensor:
        shape = self.shapes[key]
        if key.endswith(("norm", "norm_w")):
            return torch.ones(shape, device=self.device)
        if len(shape) == 1 and not key.endswith("router_bias"):
            return torch.zeros(shape, device=self.device)
        std = (self.bias_std if key.endswith("router_bias")
               else self.cfg["init_std"])
        gen = inputs.device_generator(self.seed, self.streams[key],
                                      self.device)
        return torch.empty(shape, device=self.device).normal_(
            0.0, std, generator=gen)
