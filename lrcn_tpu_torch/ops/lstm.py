"""Plain LSTM primitives on tensors (counterpart of ``lrcn_tpu/ops/lstm.py``).

Same packed weight layout ``W[(X+H), 4H]`` and gate order [forget, ingate,
outgate, change] as the JAX package (reference cell lrcn.jl:528-538).

``matmul`` keeps JAX's numerics: operands rounded to ``compute_dtype``,
products summed in float32, float32 out.  A bf16 ``torch.matmul`` would
round its output to bf16, which JAX does not, so the bf16 route is
``torch.mm(..., out_dtype=torch.float32)`` on CUDA (cuBLAS, f32
accumulation and output) and, on the CPU, bf16-rounded operands upcast and
multiplied in float32.  A float32 ``compute_dtype`` multiplies in full
float32: callers that check f32 parity on CUDA keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, the counterpart of
JAX's ``Precision.HIGHEST``).

Every route is differentiable.  ``torch.mm(..., out_dtype=...)`` has no
derivative, so where a gradient is wanted the bf16 CUDA route goes through
``_MatmulF32Out``, whose backward runs both products on the tensor cores
with bf16 operands (the cotangent rounded to bf16) and returns bf16
gradients; the ``.to(compute_dtype)`` casts carry them back to the
operands' own dtypes, as JAX's ``astype`` transposes do.

Under ``torch.export`` the bf16 route is the op ``lrcn::mm_f32``, whose
CPU and CUDA implementations are the two routes: an exported program runs
on either device (``export.py``).
"""

from __future__ import annotations

import torch


class _MatmulF32Out(torch.autograd.Function):
    """``a @ w`` of two bf16 CUDA matrices with a float32 result."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, w)
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        grad_a = g @ w.t() if ctx.needs_input_grad[0] else None
        grad_w = a.t() @ g if ctx.needs_input_grad[1] else None
        return grad_a, grad_w


def _mm_f32_cpu(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a.float() @ w.float()


def _mm_f32_cuda(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.mm(a, w, out_dtype=torch.float32)


# ``lrcn::mm_f32(a, w)``: the bf16 route of ``matmul`` as one op with a
# route per device, which a program traced by ``torch.export`` records in
# place of the traced device's own route, so that it runs on either
# device with that device's numerics (``aten::mm.dtype`` has no CPU
# kernel).  The live path calls the routes directly.
_ops = torch.library.Library("lrcn", "FRAGMENT")
_ops.define("mm_f32(Tensor a, Tensor w) -> Tensor")
_ops.impl("mm_f32", _mm_f32_cpu, "CPU")
_ops.impl("mm_f32", _mm_f32_cuda, "CUDA")
torch.library.register_fake(
    "lrcn::mm_f32", lambda a, w: a.new_empty((a.shape[0], w.shape[1]),
                                             dtype=torch.float32), lib=_ops)


def matmul(a: torch.Tensor, w: torch.Tensor,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``a @ w`` with operands in ``compute_dtype`` and a float32 result."""
    # no cast where there is none to do: a traced program records every one
    if a.dtype != compute_dtype:
        a = a.to(compute_dtype)
    if w.dtype != compute_dtype:
        w = w.to(compute_dtype)
    if compute_dtype == torch.float32:
        return a @ w
    if torch.compiler.is_exporting():
        return torch.ops.lrcn.mm_f32.default(a, w)
    if a.is_cuda:
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            return _MatmulF32Out.apply(a, w)
        return _mm_f32_cuda(a, w)
    return _mm_f32_cpu(a, w)


def lstm_cell_update(gates: torch.Tensor, c: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate nonlinearities + cell update on (..., 4H) pre-activations
    packed [forget, ingate, outgate, change].  Returns (h, c), float32."""
    f, i, o, g = gates.float().chunk(4, dim=-1)
    c = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(g)  # lrcn.jl:535
    h = torch.sigmoid(o) * torch.tanh(c)                        # lrcn.jl:536
    return h, c


def lstm_step(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, x: torch.Tensor, *,
              compute_dtype: torch.dtype = torch.bfloat16
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step with packed weights ``w[(X+H), 4H]`` and bias
    ``b[4H]`` (the reference's ``hcat(input,hidden) * weight .+ bias``,
    lrcn.jl:529, followed by the gate update)."""
    x_dim = x.shape[-1]
    gates = (matmul(x, w[:x_dim], compute_dtype)
             + matmul(h, w[x_dim:], compute_dtype)
             + b.float())
    return lstm_cell_update(gates, c)


def lstm_recurrent_gates(w_h: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                         x_proj: torch.Tensor, *,
                         compute_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Gates from a precomputed input projection plus the recurrent matmul:
    ``x_proj`` is ``x @ w[:X]`` hoisted out of the time loop and ``w_h`` is
    the recurrent half ``w[X:]``; this adds ``h @ w_h + b``.  The JAX
    function slices ``w`` itself; here the caller slices once outside the
    loop, so that autograd sums the steps' gradients on the slice instead of
    scattering each into a full-size one."""
    return (x_proj
            + matmul(h, w_h, compute_dtype)
            + b.float())
