"""Caption tokenization for Flickr30k ``.token`` files and MS-COCO JSON.

A copy of ``lrcn_tpu.core.tokenizer`` (same captions, same vocabulary),
kept here so that this package loads nothing of ``lrcn_tpu``: the
module is numpy-only, but importing it runs ``lrcn_tpu/__init__.py``.

Re-implements the normalization rules of the reference tokenizer
(tokenizer.jl) exactly, because BLEU parity depends on producing the same
word streams:

- Flickr lines look like ``1000092795.jpg#0\tTwo young guys ... .``.  The
  reference lowercases the line and splits on ``[' ','\\t','#','.','\\n']``
  (tokenizer.jl:91), takes tokens from position 4 onward (skipping the image
  id, the ``jpg`` extension and the caption index), strips each token of
  ``[' ','.',',','#','\\'',')','(','!','/','?','\\t','`']`` (tokenizer.jl:96)
  and drops empty tokens.
- COCO captions are split on single spaces only (tokenizer.jl:115), then each
  token is lowercased + stripped of the same character set (tokenizer.jl:118)
  and empties are dropped.
- The vocabulary keeps words seen >= 5 times (tokenizer.jl:30) and, for
  Flickr, is built from ALL captions before the val/test split is removed so
  the vocab is split-independent (tokenizer.jl:12-16).
- Caption lists are sorted by length ascending (tokenizer.jl:51,106,128) —
  the equal-length batcher depends on this.
- Flickr val/test: 1000 + 1000 images selected by a seed-5 shuffle
  (tokenizer.jl:57-78).  Julia's ``srand(5)`` stream is not reproducible from
  Python, so this framework defines its own deterministic seed-5 permutation
  (numpy PCG64) with identical sizes and protocol — an intentional,
  documented divergence.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

from lrcn_tpu_torch.core.vocab import Vocab

# tokenizer.jl:42,96,118 — strip set applied to every token.
STRIP_CHARS = " .,#')(!/?\t`"

# tokenizer.jl:91 — split set for Flickr lines.
_FLICKR_SPLIT = re.compile(r"[ \t#.\n]")

VAL_SIZE = 1000   # tokenizer.jl:57
TEST_SIZE = 1000  # tokenizer.jl:57
SPLIT_SEED = 5    # tokenizer.jl:59


@dataclasses.dataclass(frozen=True)
class Caption:
    """One caption: image id + normalized word list.

    Mirrors the reference's ``((id, words), length)`` tuples
    (tokenizer.jl:35,49).
    """
    image_id: int
    words: tuple[str, ...]

    def __len__(self) -> int:
        return len(self.words)


def _clean(tokens: Iterable[str]) -> tuple[str, ...]:
    """Strip each token of STRIP_CHARS and drop empties (tokenizer.jl:94-102)."""
    out = []
    for t in tokens:
        t = t.strip(STRIP_CHARS)
        if t:
            out.append(t)
    return tuple(out)


def tokenize_flickr_line(line: str) -> Caption:
    """Parse one Flickr30k ``.token`` line (tokenizer.jl:89-104)."""
    tokens = _FLICKR_SPLIT.split(line.lower())
    image_id = int(tokens[0])
    # tokens[1]='jpg', tokens[2]=caption index; caption words start at 3
    # (Julia 1-based words[4:end], tokenizer.jl:103).
    return Caption(image_id, _clean(tokens[3:]))


def parse_flickr_tokens(lines: Sequence[str], sort_by_len: bool = True
                        ) -> list[Caption]:
    """Parse a whole Flickr ``.token`` file (tokenizer.jl:34-53)."""
    caps = [tokenize_flickr_line(ln) for ln in lines if ln.strip()]
    if sort_by_len:
        caps.sort(key=len)  # stable, ascending (tokenizer.jl:51)
    return caps


def flickr_split(lines: Sequence[str]) -> tuple[list[Caption], list[Caption],
                                                list[Caption]]:
    """Deterministic train/val/test split of a Flickr ``.token`` file.

    Protocol mirrors tokenizer.jl:56-87: the file has 5 consecutive caption
    lines per image; pick 1000 val images + 1000 test images by a seeded
    shuffle of image positions, remove their lines from train.  The RNG
    stream differs from Julia's ``srand(5)`` (see module docstring).
    """
    lines = [ln for ln in lines if ln.strip()]
    if len(lines) % 5 != 0:
        raise ValueError(
            f"Flickr .token file must have 5 captions per image; got "
            f"{len(lines)} lines")
    n_images = len(lines) // 5
    if n_images < VAL_SIZE + TEST_SIZE:
        raise ValueError(f"need >= {VAL_SIZE + TEST_SIZE} images for the "
                         f"fixed split; got {n_images}")
    rng = np.random.default_rng(SPLIT_SEED)
    perm = rng.permutation(n_images)
    val_imgs = set(perm[:VAL_SIZE].tolist())
    test_imgs = set(perm[VAL_SIZE:VAL_SIZE + TEST_SIZE].tolist())

    train_lines, val_lines, test_lines = [], [], []
    for img in range(n_images):
        chunk = lines[5 * img:5 * img + 5]
        if img in val_imgs:
            val_lines.extend(chunk)
        elif img in test_imgs:
            test_lines.extend(chunk)
        else:
            train_lines.extend(chunk)
    return (parse_flickr_tokens(train_lines),
            parse_flickr_tokens(val_lines),
            parse_flickr_tokens(test_lines))


def tokenize_coco_caption(caption: str) -> tuple[str, ...]:
    """Normalize one COCO caption string (tokenizer.jl:115-124).

    The reference splits on single spaces only, then lowercases + strips each
    token; embedded newlines survive inside tokens exactly as in the
    reference.
    """
    return _clean(t.lower() for t in caption.split(" "))


def parse_coco_json(text: str, sort_by_len: bool = True) -> list[Caption]:
    """Parse a COCO ``captions_*.json`` annotation file (tokenizer.jl:111-130)."""
    data = json.loads(text)["annotations"]
    caps = [Caption(int(obj["image_id"]), tokenize_coco_caption(obj["caption"]))
            for obj in data]
    if sort_by_len:
        caps.sort(key=len)
    return caps


def build_vocab(caption_lists: Sequence[Sequence[Caption]],
                min_count: int = 5) -> Vocab:
    """Count words over caption lists and build the filtered vocab.

    Reference: tokenizer.jl:132-166 (``get_vocab`` + ``filtervocab``); id
    order here is deterministic first-appearance order (see vocab.py).
    """
    counts: Counter[str] = Counter()
    order: list[str] = []
    seen: set[str] = set()
    for caps in caption_lists:
        for cap in caps:
            for w in cap.words:
                counts[w] += 1
                if w not in seen:
                    seen.add(w)
                    order.append(w)
    return Vocab.from_counts(counts, order, min_count=min_count)


def tokenize(data_files: Sequence[str],
             min_count: int = 5) -> tuple[Vocab, list[list[Caption]]]:
    """Top-level entry mirroring ``Tokenizer.tokenize`` (tokenizer.jl:6-32).

    - ``*.token`` file  -> vocab from ALL captions; returns
      ``[train, val, test]`` caption lists (seed-5 split).
    - ``*.json`` files  -> one caption list per file; every json file
      contributes to the vocab (the reference passes train AND val json for
      COCO, lrcn.jl:69, and both feed ``get_vocab``, tokenizer.jl:23).

    ``min_count`` relaxes the reference's hard-coded count>=5 vocab filter
    (tokenizer.jl:30) — on small custom datasets the default maps most
    content words to unk.
    """
    caption_dicts: list[list[Caption]] = []
    vocab_sources: list[list[Caption]] = []
    for path in data_files:
        kind = path.split(".")[1] if "." in path else ""
        if path.endswith(".token") or kind == "token":
            with open(path) as f:
                lines = f.readlines()
            # vocab from the full file, split-independent (tokenizer.jl:12-16)
            vocab_sources.append(parse_flickr_tokens(lines))
            caption_dicts.extend(flickr_split(lines))
        elif path.endswith(".json") or kind == "json":
            with open(path) as f:
                caps = parse_coco_json(f.read())
            vocab_sources.append(caps)
            caption_dicts.append(caps)
        else:
            raise ValueError(f"invalid caption file: {path}")
    return build_vocab(vocab_sources, min_count=min_count), caption_dicts
