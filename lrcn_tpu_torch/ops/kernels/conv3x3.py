"""Fused 3x3 conv + bias + ReLU: CUDA kernel wrapper and its plain PyTorch
version.

Counterpart of ``lrcn_tpu/ops/pallas/conv3x3.py:fused_conv3x3_relu``; the
kernel is ``csrc/conv3x3.cu``, an implicit GEMM over the NHWC input that
never materialises a padded copy.  One launch computes

    y = relu(conv3x3(x, w) + b)      cross-correlation, pad 1, stride 1

with x and w in the compute dtype, f32 sums, the f32 bias added to the f32
sum and the result cast to the compute dtype, in NHWC / HWIO layout.  The
compute dtype is the dtype of ``w``: the encoder caches its conv weights
in it once, at load.  bf16 is the serving path; f32 is for parity runs.

A CUDA tensor takes one of three hand-written routes of the kernel,
chosen by ``conv3x3_route`` from the shapes, dtype and alignment:
``"wgmma"`` (bf16 with C and F multiples of 64: TMA loads, wgmma; 12 of
VGG-16's 13 convs), ``"scalar"`` (other bf16 shapes: a gather into wmma
tiles; conv1_1 has C = 3) and ``"fma"`` (f32).

The kernel is the ``torch.library`` op ``lrcn::conv3x3_relu``: its CPU
implementation is the plain version, its CUDA implementation
(``conv3x3_relu_cuda``) casts x to the compute dtype, picks the route,
launches and counts the launch (``launches.count``) in
``fused_conv3x3_relu.launches`` and, per route, in
``fused_conv3x3_relu.launches_by_route`` (a captured CUDA graph counts its
replays, ``utils/graphs.py``); its fake
implementation gives the shape, so ``torch.export`` traces the op as one
node.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lrcn_tpu_torch import require_cuda
from lrcn_tpu_torch.ops.kernels import build, launches

# route name -> the int the C entry point takes (csrc/conv3x3.cu:Route)
ROUTES = {"fma": 0, "scalar": 1, "wgmma": 2}
# TMA needs 16-byte aligned bases; a wgmma K step is 64 channels deep
_TMA_ALIGN, _WGMMA_DEPTH = 16, 64


def conv3x3_relu_reference(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor,
                           compute_dtype: torch.dtype = torch.bfloat16,
                           apply_relu: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel.

    x and w are rounded to ``compute_dtype`` and upcast to f32, convolved
    in f32 (``F.conv2d``; on CUDA, f32 parity needs
    ``torch.backends.cudnn.allow_tf32 = False``), then the f32 bias and
    ReLU are applied and the result cast to ``compute_dtype``: the
    rounding of the Pallas kernel.
    """
    xq = x.to(compute_dtype).float().permute(0, 3, 1, 2)
    wq = w.to(compute_dtype).float().permute(3, 2, 0, 1)
    y = F.conv2d(xq, wq, padding=1).permute(0, 2, 3, 1) + b.float()
    if apply_relu:
        y = torch.relu(y)
    return y.to(compute_dtype).contiguous()


def _check(x, w, b) -> None:
    if x.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)}: want (B, H, W, C)")
    c = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"w {tuple(w.shape)} incompatible with x "
                         f"{tuple(x.shape)}")
    if b.shape != (w.shape[-1],):
        raise ValueError(f"b {tuple(b.shape)} != ({w.shape[-1]},)")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w must be bfloat16 or float32, got {w.dtype}")
    if b.dtype != torch.float32:
        raise TypeError(f"b must be float32, got {b.dtype}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def conv3x3_route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel route for ``x`` (already in the dtype of ``w``,
    contiguous) and ``w``: "wgmma", "scalar" or "fma"."""
    if w.dtype == torch.float32:
        return "fma"
    c, f = w.shape[2], w.shape[3]
    aligned = all(t.data_ptr() % _TMA_ALIGN == 0 for t in (x, w))
    if c % _WGMMA_DEPTH == 0 and f % _WGMMA_DEPTH == 0 and aligned:
        return "wgmma"
    return "scalar"


def _conv3x3_relu_cpu(x, w, b, apply_relu=True):
    _check(x, w, b)
    return conv3x3_relu_reference(x, w, b, w.dtype, apply_relu)


def conv3x3_relu_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      apply_relu: bool = True) -> torch.Tensor:
    """The op's CUDA implementation: check the operands, cast x to the
    compute dtype, pick the route, launch the kernel on the current stream
    and count the launch."""
    _check(x, w, b)
    device = require_cuda(x.device)
    x = x.to(w.dtype).contiguous()
    b_dim, h, w_dim, c = x.shape
    f = w.shape[-1]
    y = torch.empty((b_dim, h, w_dim, f), dtype=w.dtype, device=device)
    if y.numel() == 0:
        return y
    route = conv3x3_route(x, w)
    lib = build.load()
    with build.on_device(device) as stream:
        status = lib.lrcn_conv3x3(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            b_dim, h, w_dim, c, f, int(apply_relu), ROUTES[route], stream)
    build.check(status, f"lrcn_conv3x3 ({route})")
    launches.count(fused_conv3x3_relu, route)
    return y


def _conv3x3_relu_fake(x, w, b, apply_relu=True):
    _check(x, w, b)
    return x.new_empty((*x.shape[:3], w.shape[-1]), dtype=w.dtype)


_OP = build.define_op(
    "conv3x3_relu(Tensor x, Tensor w, Tensor b, bool apply_relu=True)"
    " -> Tensor",
    cpu=_conv3x3_relu_cpu, cuda=conv3x3_relu_cuda, fake=_conv3x3_relu_fake)


def fused_conv3x3_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       apply_relu: bool = True) -> torch.Tensor:
    """``relu(conv3x3(x, w) + b)`` as one kernel launch, NHWC / HWIO,
    through ``lrcn::conv3x3_relu``.

    Args:
      x: (B, H, W, C) input; cast to the dtype of ``w`` if it is not
        already (the first layer's input is the f32 normalized image).
      w: (3, 3, C, F) filters, bf16 or f32 (the compute dtype).
      b: (F,) f32 bias.

    Returns (B, H, W, F) in the compute dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.
    """
    return _OP(x, w, b, apply_relu)


fused_conv3x3_relu.launches = 0
fused_conv3x3_relu.launches_by_route = dict.fromkeys(ROUTES, 0)
