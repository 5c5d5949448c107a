"""The precision of the reference's products.

``None`` is float32 (TF32 off: ``strict_float32``).  ``Fp8`` is the
control of a bfloat16 configuration, the next precision below it, as an
fp8 training path computes: each operand of a product rounded to float8
e4m3 under one scale per tensor (its largest magnitude mapped to e4m3's
largest, 448), the product summed in float32, and in the backward pass
the product's cotangent rounded to e5m2 the same way (largest 57344)
before the two products that carry it back.  The roundings pass
gradients straight through.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def strict_float32():
    """Float32 products without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = x.abs().max().clamp(min=1e-30)
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _RoundCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Fp8:
    def operand(self, x: torch.Tensor) -> torch.Tensor:
        return x + (_round(x.detach(), torch.float8_e4m3fn) - x).detach()

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundCotangent.apply(y) if y.requires_grad else y


fp8 = Fp8()


def cast(x: torch.Tensor, quant) -> torch.Tensor:
    """An operand of a product at ``quant``'s precision."""
    return x if quant is None else quant.operand(x)


def product(y: torch.Tensor, quant) -> torch.Tensor:
    """A product's result, its cotangent at ``quant``'s precision."""
    return y if quant is None else quant.output(y)
