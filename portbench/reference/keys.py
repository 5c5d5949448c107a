"""Step keys and batch order as the configuration states them.

A run's key ``k`` gives each training step its own: the steps' dropout
streams derive from 64-bit integer keys by splitmix64 (``fold_in``), as
the port's training loop documents.  An epoch of ``K`` batches of one
shape is one dispatch of ``K`` steps: step ``i`` takes the epoch key
folded with ``i``; the next epoch's key is the epoch key folded with
``K + 1``, then with ``1`` (the epoch's single-step tail, empty).  The
epoch's shuffle generator first orders its shape groups (one), then the
group's batches.  A generator is seeded with the key's low 63 bits.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    z = (key ^ ((data + 1) * 0x9E3779B97F4A7C15)) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_seed(key: int) -> int:
    return key & (_MASK64 >> 1)


def dispatch_keys(key: int, k: int, epochs: int) -> list[int]:
    """The step keys of ``epochs`` epochs in a row from key ``key``, each
    one dispatch of ``k`` steps."""
    keys = []
    for _ in range(epochs):
        keys += [fold_in(key, i) for i in range(k)]
        key = fold_in(fold_in(key, k + 1), 1)
    return keys


def epoch_order(rng: np.random.Generator, k: int) -> list[int]:
    """The order in which an epoch's ``k`` same-shape batches run, drawn
    from its shuffle generator ``rng``."""
    rng.permutation(1)
    return [int(i) for i in rng.permutation(k)]
