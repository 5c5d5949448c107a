"""Fused per-row top-k + log-sum-exp: CUDA kernel wrapper and its plain
PyTorch version.

Counterpart of ``lrcn_tpu/ops/pallas/topk_lse.py:topk_logsumexp``; the
kernel is ``csrc/topk_lse.cu``.  For (R, V) logits it returns, in one pass
over each row, the top-k values in descending order, their indices
(lowest index first among equal values, ``lax.top_k``'s rule) and the
row's log-sum-exp.  The beam step ranks candidates by ``vals - lse``: the
shift is per row, so this is the top-k of ``log_softmax``.  Every
``1 <= k <= V`` is taken, as in the JAX package.

A CUDA tensor takes one of three hand-written routes of the kernel,
chosen by ``topk_lse_route`` from k: ``"block"`` (one block per row, a
register list of the k best; k <= 16, every beam width the service
runs), ``"rounds"`` (k block-wide argmax rounds over the row; any k) and
``"warp"`` (v1, one warp per row; k <= 8), which the route function does
not pick and a caller may ask for by name.

The kernel is the ``torch.library`` op ``lrcn::topk_lse(logits, k,
route=None)``, the route an argument of the op: its CPU implementation
is the plain version, its CUDA implementation (``topk_lse_cuda``)
launches the kernel on the route asked for (by default
``topk_lse_route``'s) and counts the launch (``launches.count``) in
``topk_logsumexp.launches`` and, per route, in
``topk_logsumexp.launches_by_route`` (a captured CUDA graph counts its
replays, ``utils/graphs.py``); its fake
implementation gives the shapes, so ``torch.export`` traces the op as one
node.
"""

from __future__ import annotations

import torch

from lrcn_tpu_torch import require_cuda
from lrcn_tpu_torch.ops.kernels import build, launches

# route name -> the int the C entry point takes (csrc/topk_lse.cu:Route)
ROUTES = {"warp": 0, "block": 1, "rounds": 2}
# the largest k of each register-list route (its template instances);
# "rounds" takes any k <= V
MAX_K = {"warp": 8, "block": 16}


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


def topk_lse_route(logits: torch.Tensor, k: int) -> str:
    """The kernel route for these logits and k: "block" up to its register
    list's k, else "rounds".  Any V and any row alignment take either."""
    return "block" if k <= MAX_K["block"] else "rounds"


def _check(logits: torch.Tensor, k: int, route: str | None) -> None:
    if logits.dim() != 2:
        raise ValueError(f"logits must be (R, V), got {tuple(logits.shape)}")
    v = logits.shape[1]
    if not 1 <= k <= v:
        raise ValueError(f"k={k} must be in 1..{v} (V={v})")
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {list(ROUTES)}")
    if route is not None and k > MAX_K.get(route, v):
        raise ValueError(f"route {route!r} takes k <= {MAX_K[route]}, "
                         f"got k={k}")
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")


def _topk_lse_cpu(logits, k, route=None):
    _check(logits, k, route)
    return topk_logsumexp_reference(logits, k)


def topk_lse_cuda(logits: torch.Tensor, k: int, route: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: check the operands, launch the kernel
    on ``route`` (default ``topk_lse_route``) on the current stream and
    count the launch."""
    _check(logits, k, route)
    r, v = logits.shape
    route = topk_lse_route(logits, k) if route is None else route
    device = require_cuda(logits.device)
    vals = torch.empty((r, k), dtype=torch.float32, device=device)
    idx = torch.empty((r, k), dtype=torch.int32, device=device)
    lse = torch.empty((r,), dtype=torch.float32, device=device)
    lib = build.load()
    with build.on_device(device) as stream:
        status = lib.lrcn_topk_lse(logits.data_ptr(), vals.data_ptr(),
                                   idx.data_ptr(), lse.data_ptr(), r, v, k,
                                   ROUTES[route], stream)
    build.check(status, f"lrcn_topk_lse ({route})")
    launches.count(topk_logsumexp, route)
    return vals, idx, lse


def _topk_lse_fake(logits, k, route=None):
    _check(logits, k, route)
    r = logits.shape[0]
    return (logits.new_empty((r, k)),
            logits.new_empty((r, k), dtype=torch.int32),
            logits.new_empty((r,)))


_OP = build.define_op(
    "topk_lse(Tensor logits, int k, str? route=None)"
    " -> (Tensor, Tensor, Tensor)",
    cpu=_topk_lse_cpu, cuda=topk_lse_cuda, fake=_topk_lse_fake)


def topk_logsumexp(logits: torch.Tensor, k: int, *, route: str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, V) f32 logits -> (vals (R, k) f32 desc, idx (R, k) int32,
    lse (R,) f32), for any 1 <= k <= V, through ``lrcn::topk_lse``.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    ``route`` (default ``topk_lse_route``) or raise.  Rows are expected
    finite or -inf (NaN and +inf are out of contract).
    """
    return _OP(logits, k, route)


topk_logsumexp.launches = 0
topk_logsumexp.launches_by_route = dict.fromkeys(ROUTES, 0)
