"""One fused LSTM step (``lrcn::lstm_step``): ``[x, h] @ W + b`` and the
gate update, for ``rows`` rows of input width ``x_dim`` and hidden width
``h_dim``.

x, h and c are read once (float32), W (``w_bytes`` an element) and b read
once, h' and c' written once; 2 operations per multiply-add of the
product; the gate update's few operations an element are left out.  At
the decode's shapes (thousands of rows, X = H = 1000) the operations
bound it; at a few hundred rows the bytes of W do.  (Copied from
``chip_smoke.py``'s ``lstm_bound``.)
"""

from __future__ import annotations


def cost(rows: int, x_dim: int, h_dim: int, w_bytes: int = 2
         ) -> tuple[float, float, str]:
    nbytes = (4 * rows * (x_dim + 2 * h_dim)
              + w_bytes * (x_dim + h_dim) * 4 * h_dim + 4 * 4 * h_dim
              + 2 * 4 * rows * h_dim)
    ops = 2 * rows * (x_dim + h_dim) * 4 * h_dim
    return nbytes, ops, "bf16" if w_bytes == 2 else "f32"
