"""Fused LSTM step: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``lrcn_tpu/ops/pallas/lstm_step.py:fused_lstm_step``; the
kernel is ``csrc/lstm_step.cu``.  One launch computes the four gate
matmuls of ``[x, h] @ W + b`` and the cell update, in f32 accumulation,
without writing the (B, 4H) gate pre-activations to device memory.

The compute dtype is the dtype of ``w``: the decoder caches its LSTM
weights in the compute dtype once, at load (the JAX kernel casts them on
every call).  bf16 is the serving path; f32 is for parity runs.

A CUDA tensor takes one of three hand-written routes of the kernel,
chosen by ``lstm_step_route`` from the shapes, dtype and alignment:
``"wgmma"`` (bf16 with X and H multiples of 4 and 16-byte aligned
tensors: TMA loads, wgmma, the cell update in the epilogue; the decode
step's shapes), ``"wmma"`` (other bf16 shapes) and ``"fma"`` (f32).  The
wgmma route runs persistent blocks, at most one an SM, each walking over
output tiles, in clusters of two that share W; ``wgmma_grid`` sizes the
grid from the row count.

The kernel is the ``torch.library`` op ``lrcn::lstm_step``: its CPU
implementation is the plain version, its CUDA implementation
(``lstm_step_cuda``) checks the operands, picks the route, launches and
counts the launch (``launches.count``) in ``fused_lstm_step.launches``
and, per route, in ``fused_lstm_step.launches_by_route`` (a captured CUDA
graph counts its replays, ``utils/graphs.py``); its fake implementation
gives the shapes, so ``torch.export`` traces the op as one node.  The wrapper
``fused_lstm_step`` calls the op, so the live path and an exported
program run the same op.
"""

from __future__ import annotations

import torch

from lrcn_tpu_torch import require_cuda
from lrcn_tpu_torch.ops import lstm
from lrcn_tpu_torch.ops.kernels import build, launches

# route name -> the int the C entry point takes (csrc/lstm_step.cu:Route)
ROUTES = {"fma": 0, "wmma": 1, "wgmma": 2}
# TMA needs 16-byte aligned bases and row strides: 4 f32 per 16 bytes
_TMA_ALIGN, _TMA_F32_STEP = 16, 4
# the wgmma route's output tile: rows, and hidden columns of each gate,
# and the blocks of a cluster (csrc/lstm_step.cu: wg::BM, wg::BNH, wg::CL)
WGMMA_TILE = (128, 64)
WGMMA_CLUSTER = 2


def lstm_step_reference(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                        c: torch.Tensor, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``ops.lstm.lstm_step`` in the
    dtype of ``w``."""
    return lstm.lstm_step(w, b, h, c, x, compute_dtype=w.dtype)


def _check(w, b, h, c, x) -> None:
    if x.dim() != 2 or h.dim() != 2 or c.shape != h.shape:
        raise ValueError(f"x {tuple(x.shape)}, h {tuple(h.shape)}, "
                         f"c {tuple(c.shape)}: want (B, X), (B, H), (B, H)")
    (b_dim, x_dim), h_dim = x.shape, h.shape[1]
    if h.shape[0] != b_dim:
        raise ValueError(f"x has {b_dim} rows, h has {h.shape[0]}")
    if w.shape != (x_dim + h_dim, 4 * h_dim):
        raise ValueError(f"w {tuple(w.shape)} != "
                         f"({x_dim + h_dim}, {4 * h_dim})")
    if b.shape != (4 * h_dim,):
        raise ValueError(f"b {tuple(b.shape)} != ({4 * h_dim},)")
    if w.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w must be bfloat16 or float32, got {w.dtype}")
    for name, t in (("x", x), ("h", h), ("c", c), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("w", w), ("b", b), ("h", h), ("c", c), ("x", x)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def lstm_step_route(w: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                    x: torch.Tensor) -> str:
    """The kernel route for these operands: "wgmma", "wmma" or "fma"."""
    if w.dtype == torch.float32:
        return "fma"
    x_dim, h_dim = x.shape[1], h.shape[1]
    aligned = all(t.data_ptr() % _TMA_ALIGN == 0 for t in (w, h, c, x))
    if x_dim % _TMA_F32_STEP == 0 and h_dim % _TMA_F32_STEP == 0 and aligned:
        return "wgmma"
    return "wmma"


def wgmma_grid(rows: int, h_dim: int, sms: int) -> int:
    """Blocks of the wgmma route: at most one an SM, in clusters of two.

    The tiles are ``WGMMA_TILE``'s rows by its hidden columns of all four
    gates.  A cluster takes two row tiles of one column tile (a group) and
    shares the column tile's W strips by multicast; a row tile past the
    rows loads zeros and writes nothing.  Groups are numbered column tile
    fastest, and cluster ``k`` of ``K`` takes groups ``k, k + K, k + 2K,
    ...``, so the clusters in flight share their rows of x and h and
    between them read all of W.  Below one group a cluster (768 rows at
    H = 1000 make 48) each cluster takes one group."""
    tile_rows, tile_cols = WGMMA_TILE
    groups = -(-rows // (WGMMA_CLUSTER * tile_rows)) * -(-h_dim // tile_cols)
    return WGMMA_CLUSTER * max(1, min(groups, sms // WGMMA_CLUSTER))


def _lstm_step_cpu(w, b, h, c, x):
    _check(w, b, h, c, x)
    return tuple(t.contiguous() for t in lstm_step_reference(w, b, h, c, x))


def lstm_step_cuda(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                   c: torch.Tensor, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: check the operands, pick the route,
    launch the kernel on the current stream and count the launch."""
    _check(w, b, h, c, x)
    device = require_cuda(x.device)
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    route = lstm_step_route(w, h, c, x)
    grid = (wgmma_grid(x.shape[0], h.shape[1], build.sm_count(device))
            if route == "wgmma" else 0)
    lib = build.load()
    with build.on_device(device) as stream:
        status = lib.lrcn_lstm_step(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
            b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            x.shape[0], x.shape[1], h.shape[1], grid, ROUTES[route], stream)
    build.check(status, f"lrcn_lstm_step ({route})")
    launches.count(fused_lstm_step, route)
    return h_out, c_out


def _lstm_step_fake(w, b, h, c, x):
    _check(w, b, h, c, x)
    return torch.empty_like(h), torch.empty_like(c)


_OP = build.define_op(
    "lstm_step(Tensor w, Tensor b, Tensor h, Tensor c, Tensor x)"
    " -> (Tensor, Tensor)",
    cpu=_lstm_step_cpu, cuda=lstm_step_cuda, fake=_lstm_step_fake)


def fused_lstm_step(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                    c: torch.Tensor, x: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step as one kernel launch, through ``lrcn::lstm_step``;
    returns (h', c') in float32.

    Args:
      w: (X+H, 4H) packed weights, gate order [f, i, o, g], bf16 or f32
        (the compute dtype).
      b: (4H,) f32 bias.  h, c: (B, H) f32 state.  x: (B, X) f32 input.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Under ``torch.export`` the op is traced as one node.
    """
    return _OP(w, b, h, c, x)


fused_lstm_step.launches = 0
fused_lstm_step.launches_by_route = dict.fromkeys(ROUTES, 0)
