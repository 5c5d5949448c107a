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
"""

from __future__ import annotations

import torch


def matmul(a: torch.Tensor, w: torch.Tensor,
           compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``a @ w`` with operands in ``compute_dtype`` and a float32 result."""
    a = a.to(compute_dtype)
    w = w.to(compute_dtype)
    if compute_dtype == torch.float32:
        return a @ w
    if a.is_cuda:
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


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
