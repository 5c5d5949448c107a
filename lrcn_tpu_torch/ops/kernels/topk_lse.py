"""Fused per-row top-k + log-sum-exp: CUDA kernel wrapper and its plain
PyTorch version.

Counterpart of ``lrcn_tpu/ops/pallas/topk_lse.py:topk_logsumexp``; the
kernel is ``csrc/topk_lse.cu``.  For (R, V) logits it returns, in one pass
over each row, the top-k values in descending order, their indices
(lowest index first among equal values, ``lax.top_k``'s rule) and the
row's log-sum-exp.  The beam step ranks candidates by ``vals - lse``: the
shift is per row, so this is the top-k of ``log_softmax``.
"""

from __future__ import annotations

import threading

import torch

from lrcn_tpu_torch import require_cuda
from lrcn_tpu_torch.ops.kernels import build

MAX_K = 8   # the kernel is instantiated for k = 1..8

_count_lock = threading.Lock()


def topk_logsumexp_reference(logits: torch.Tensor, k: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of the kernel.

    ``torch.topk`` does not promise an order among equal values, so the
    indices come from a stable descending sort, which keeps the lower
    index first."""
    logits = logits.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return (vals[:, :k].contiguous(), idx[:, :k].to(torch.int32),
            torch.logsumexp(logits, dim=-1))


def topk_logsumexp(logits: torch.Tensor, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, V) f32 logits -> (vals (R, k) f32 desc, idx (R, k) int32,
    lse (R,) f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Rows are expected finite (NaN is never selected).
    """
    if logits.dim() != 2:
        raise ValueError(f"logits must be (R, V), got {tuple(logits.shape)}")
    r, v = logits.shape
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"k={k} must be in 1..{min(MAX_K, v)} (V={v})")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if logits.device.type == "cpu":
        return topk_logsumexp_reference(logits, k)
    device = require_cuda(logits.device)
    vals = torch.empty((r, k), dtype=torch.float32, device=device)
    idx = torch.empty((r, k), dtype=torch.int32, device=device)
    lse = torch.empty((r,), dtype=torch.float32, device=device)
    lib = build.load()
    with build.on_device(device) as stream:
        status = lib.lrcn_topk_lse(logits.data_ptr(), vals.data_ptr(),
                                   idx.data_ptr(), lse.data_ptr(), r, v, k,
                                   stream)
    build.check(status, "lrcn_topk_lse")
    with _count_lock:
        topk_logsumexp.launches += 1
    return vals, idx, lse


topk_logsumexp.launches = 0
