"""The expert products of one expert layer's calls (routed and shared,
``models/moe_text.py:experts``), from the expert counter.

Each row that enters a group takes ``2 x D x 2F`` operations for gate
and up and ``2 x F x D`` for down.  The routed experts take ``tokens``
rows in all (their tokens routed) and the shared MLP's ``S`` slices
``tokens / k`` each (every token before routing).  Bytes: the weights of
every group that took at least one row in a call, read once a call (the
routed experts that took a token, ``active`` summed over calls, and the
``S`` shared slices every call), and each row's activations read and
written once in bf16: its input (D) and gate-up output (2F), the
product's input (F) and output (D).  ``tokens`` and ``active`` are one
layer's sums over ``calls`` calls; the bound of the sum is at most the
sum of the calls' bounds.
"""

from __future__ import annotations


def layer_calls(searches: int, max_words: int) -> int:
    """An expert layer's calls in ``searches`` searches: each prefills
    its rows' prefix in one call, then runs ``max_words + 1`` steps."""
    return searches * (1 + max_words + 1)


def cost(cfg: dict, tokens: int, active: int, calls: int,
         elem: int = 2) -> tuple[float, float, str]:
    d, f, s = (cfg["hidden_size"], cfg["moe_intermediate_size"],
               cfg["n_shared_experts"])
    grouped_rows = tokens + s * tokens // cfg["num_experts_per_tok"]
    ops = 2 * grouped_rows * 3 * d * f
    nbytes = elem * ((active + s * calls) * 3 * d * f
                     + grouped_rows * (2 * d + 3 * f))
    return nbytes, ops, "bf16" if elem == 2 else "f32"
