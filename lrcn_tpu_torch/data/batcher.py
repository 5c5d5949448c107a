"""Caption batching.

A copy of ``lrcn_tpu.data.batcher`` (the same batches in the same
order from the same numpy generator), kept here so that this package
loads nothing of ``lrcn_tpu``: the module is numpy-only, but it imports
``lrcn_tpu.config``, and ``lrcn_tpu/data/__init__.py`` imports JAX.

The reference requires every batch to contain same-length captions and
DELETES captions that cannot fill an equal-length batch
(``delete_unbatchable_captions!``, lrcn.jl:299-327), and silently drops its
batch size to 10 for datasets under 30k captions (lrcn.jl:264-268).

Both packages replace this with length-BUCKETED batches plus
padding/masking: captions are grouped into a small set of static padded
shapes (multiples of ``bucket_quantum`` up to ``max_len``), and NO data is
discarded.  The masked loss
(models/lrcn.py) makes padding exact.  This is an intentional, documented
divergence; an ``equal_length_batches`` parity mode reproduces the
reference's delete-based batching for comparison studies.

Captions longer than ``max_len`` (28) are skipped, matching the reference's
hard cap (lrcn.jl:353-355).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from lrcn_tpu_torch.config import MAX_CAPTION_LEN
from lrcn_tpu_torch.core.tokenizer import Caption
from lrcn_tpu_torch.core.vocab import Vocab

# Reference: lrcn.jl:264-268 — small datasets force batch_size=10.
SMALL_DATASET_CAPTIONS = 30000
SMALL_DATASET_BATCH_SIZE = 10


@dataclasses.dataclass(frozen=True)
class Batch:
    """One padded training batch (host-side, NumPy)."""
    image_ids: np.ndarray   # (B,) int64
    tokens: np.ndarray      # (B, L_padded) int32, vocab ids
    lengths: np.ndarray     # (B,) int32, true lengths (<= L_padded)

    @property
    def batch_size(self) -> int:
        return self.tokens.shape[0]

    @property
    def padded_len(self) -> int:
        return self.tokens.shape[1]

    @property
    def token_count(self) -> int:
        """Real tokens in the batch (excludes padding and the EOS step)."""
        return int(self.lengths.sum())


def effective_batch_size(n_captions: int, batch_size: int) -> int:
    """Reference rule: datasets under 30k captions train with batch 10."""
    if n_captions <= SMALL_DATASET_CAPTIONS:
        return SMALL_DATASET_BATCH_SIZE
    return batch_size


def _encode(captions: Sequence[Caption], vocab: Vocab, max_len: int
            ) -> list[tuple[int, list[int], int]]:
    out = []
    for cap in captions:
        n = len(cap.words)
        if n == 0 or n > max_len:   # hard cap, lrcn.jl:353-355
            continue
        out.append((cap.image_id, vocab.encode(cap.words), n))
    return out


def _pad_to_bucket(n: int, quantum: int, max_len: int) -> int:
    return min(-(-n // quantum) * quantum, max_len)


def bucket_batches(captions: Sequence[Caption], vocab: Vocab,
                   batch_size: int, *, max_len: int = MAX_CAPTION_LEN,
                   bucket_quantum: int = 4,
                   apply_small_dataset_rule: bool = True,
                   drop_remainder: bool = False) -> list[Batch]:
    """Build length-bucketed padded batches.

    Every batch has a static shape ``(batch_size, bucket_len)`` where
    ``bucket_len`` is the caption length rounded up to a multiple of
    ``bucket_quantum`` (capped at ``max_len``), so at most
    ``max_len / bucket_quantum`` distinct shapes occur.

    The final partial batch of each bucket is padded with copies of its last
    example carrying ``length = -1``: the teacher-forcing mask
    (``pos <= length``) then excludes those rows from the loss entirely, so
    batching is exact and no caption is dropped (unlike the reference, which
    deletes unbatchable captions).  ``drop_remainder=True`` drops partial
    batches instead.
    """
    if apply_small_dataset_rule:
        batch_size = effective_batch_size(len(captions), batch_size)

    encoded = _encode(captions, vocab, max_len)
    buckets: dict[int, list[tuple[int, list[int], int]]] = {}
    for item in encoded:
        buckets.setdefault(
            _pad_to_bucket(item[2], bucket_quantum, max_len), []).append(item)

    batches: list[Batch] = []
    for bucket_len in sorted(buckets):
        items = buckets[bucket_len]
        for start in range(0, len(items), batch_size):
            chunk = items[start:start + batch_size]
            n_real = len(chunk)
            if n_real < batch_size:
                if drop_remainder:
                    continue
                # pad rows with length -1: fully masked out of the loss
                filler = (chunk[-1][0], chunk[-1][1], -1)
                chunk = chunk + [filler] * (batch_size - n_real)
            ids = np.array([c[0] for c in chunk], np.int64)
            lengths = np.array([c[2] for c in chunk], np.int32)
            tokens = np.zeros((batch_size, bucket_len), np.int32)
            for i, (_, tok, n) in enumerate(chunk):
                tokens[i, :len(tok)] = tok
            batches.append(Batch(ids, tokens, lengths))
    return batches


def equal_length_batches(captions: Sequence[Caption], vocab: Vocab,
                         batch_size: int, *,
                         max_len: int = MAX_CAPTION_LEN,
                         apply_small_dataset_rule: bool = True
                         ) -> list[Batch]:
    """Parity mode: the reference's equal-length-or-delete batching.

    Reproduces ``delete_unbatchable_captions!`` + ``minibatch``
    (lrcn.jl:257-327): captions sorted by length; a batch is emitted only
    when ``batch_size`` consecutive captions share one length; leftovers of
    each length run are deleted.
    """
    if apply_small_dataset_rule:
        batch_size = effective_batch_size(len(captions), batch_size)

    encoded = sorted(_encode(captions, vocab, max_len), key=lambda t: t[2])
    batches: list[Batch] = []
    i = 0
    while i + batch_size <= len(encoded):
        chunk = encoded[i:i + batch_size]
        length = chunk[0][2]
        if chunk[-1][2] != length:
            # can't fill an equal-length batch: drop captions up to the next
            # length boundary (the reference deletes them, lrcn.jl:299-327)
            i += 1
            while i < len(encoded) and encoded[i][2] == length:
                i += 1
            continue
        ids = np.array([c[0] for c in chunk], np.int64)
        lengths = np.full((batch_size,), length, np.int32)
        tokens = np.array([c[1] for c in chunk], np.int32)
        batches.append(Batch(ids, tokens, lengths))
        i += batch_size
    return batches


def epoch_order(n_batches: int, rng: np.random.Generator) -> np.ndarray:
    """Shuffled batch order for one epoch (reference: lrcn.jl:351)."""
    return rng.permutation(n_batches)


def iterate_epoch(batches: Sequence[Batch], rng: np.random.Generator | None
                  ) -> Iterator[Batch]:
    order = (np.arange(len(batches)) if rng is None
             else epoch_order(len(batches), rng))
    for i in order:
        yield batches[int(i)]


def chunk_same_shape(batches: Sequence[Batch], k: int,
                     rng: np.random.Generator | None
                     ) -> tuple[list[list[Batch]], list[Batch]]:
    """Same-shape stacks of K batches, plus a single-step tail.

    Used by the K-steps-per-dispatch trainers: the K batches of a
    dispatch are stacked, which requires uniform shapes per stack.
    Ordering divergence from the one-step path (documented): shape groups
    run one after another (shuffled), batches shuffled WITHIN each group.
    The reference itself trains on equal-length batches in shuffled order
    (lrcn.jl:351), so the curriculum effect is comparable.
    """
    by_shape: dict[tuple, list[Batch]] = {}
    for b in batches:
        by_shape.setdefault((b.batch_size, b.padded_len), []).append(b)
    shapes = list(by_shape)
    if rng is not None:
        shapes = [shapes[i] for i in rng.permutation(len(shapes))]
    chunks: list[list[Batch]] = []
    tail: list[Batch] = []
    for shape in shapes:
        group = by_shape[shape]
        if rng is not None:
            group = [group[i] for i in rng.permutation(len(group))]
        split = len(group) - len(group) % k
        chunks.extend(group[s:s + k] for s in range(0, split, k))
        tail.extend(group[split:])
    return chunks, tail
