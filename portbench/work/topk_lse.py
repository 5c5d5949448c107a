"""The fused top-k and log-sum-exp over the vocabulary
(``lrcn::topk_lse``) for ``rows`` rows of ``v`` float32 logits.

The logits are read once; values, indices and the log-sum-exp are written
once; about 4 float32 operations an element (max, subtract, exp, add).
The bytes bound it at every shape the port runs.  (Copied from
``chip_smoke.py``'s ``topk_bound``.)
"""

from __future__ import annotations


def cost(rows: int, v: int, k: int) -> tuple[float, float, str]:
    return 4 * rows * v + 8 * rows * k + 4 * rows, 4 * rows * v, "f32"
