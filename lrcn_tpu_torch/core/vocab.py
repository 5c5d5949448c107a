"""Deterministic vocabulary with reserved EOS/BOS/UNK tokens.

A copy of ``lrcn_tpu.core.vocab`` (same ids, same ``vocab.json`` format),
kept here so that this package loads nothing of ``lrcn_tpu``, and of the
JAX package's detokenizers (``lrcn_tpu/decode/writer.py``:
``caption_to_line``, ``detokenize_batch``), which the exported programs'
consumer path needs without the decode package.

Reference semantics: tokenizer.jl:147-166 (`filtervocab`) reserves
``~~``=eos, `` `` ``=bos, ``##``=unk as the first three ids and drops words
seen fewer than 5 times.  The reference assigns the remaining ids in Julia
``Dict`` iteration order, which is hash-dependent and NOT reproducible across
runs (which is why the reference must serialize the vocab inside every
checkpoint, lrcn.jl:185).  Here id assignment is first-appearance order, so a
vocabulary built from the same files is always identical; we still serialize
it with checkpoints for self-consistency.

Ids are 0-based: EOS=0, BOS=1, UNK=2 (the reference uses 1/2/3 in 1-based
Julia, lrcn.jl:248-255 — same three reserved slots).
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping

EOS_TOKEN = "~~"
BOS_TOKEN = "``"
UNK_TOKEN = "##"

EOS_ID = 0
BOS_ID = 1
UNK_ID = 2

_RESERVED = (EOS_TOKEN, BOS_TOKEN, UNK_TOKEN)


class Vocab:
    """Immutable word<->id mapping with reserved eos/bos/unk ids 0/1/2."""

    def __init__(self, words: Iterable[str]):
        """`words` are the non-reserved vocabulary words, in id order."""
        self._word_to_id: dict[str, int] = {
            w: i for i, w in enumerate(_RESERVED)
        }
        for w in words:
            if w in self._word_to_id:
                raise ValueError(f"duplicate vocab word: {w!r}")
            self._word_to_id[w] = len(self._word_to_id)
        self._id_to_word = [None] * len(self._word_to_id)
        for w, i in self._word_to_id.items():
            self._id_to_word[i] = w

    @classmethod
    def from_counts(cls, counts: Mapping[str, int], order: Iterable[str],
                    min_count: int = 5) -> "Vocab":
        """Build from word counts, keeping words with count >= min_count.

        `order` fixes id assignment (first-appearance order of the corpus).
        Reference: tokenizer.jl:30 (threshold 5), :147-166.
        """
        seen = set()
        kept = []
        for w in order:
            if w in seen or w in _RESERVED:
                continue
            seen.add(w)
            if counts.get(w, 0) >= min_count:
                kept.append(w)
        return cls(kept)

    def __len__(self) -> int:
        return len(self._id_to_word)

    def __contains__(self, word: str) -> bool:
        return word in self._word_to_id

    def id(self, word: str) -> int:
        """Word -> id, mapping OOV words to UNK (reference: lrcn.jl:288)."""
        return self._word_to_id.get(word, UNK_ID)

    def word(self, idx: int) -> str:
        return self._id_to_word[idx]

    def encode(self, words: Iterable[str]) -> list[int]:
        return [self.id(w) for w in words]

    def decode(self, ids: Iterable[int], stop_at_eos: bool = True) -> list[str]:
        out = []
        for i in ids:
            if stop_at_eos and i == EOS_ID:
                break
            out.append(self._id_to_word[int(i)])
        return out

    @property
    def words(self) -> list[str]:
        """All words in id order, including the reserved tokens."""
        return list(self._id_to_word)

    def words_array(self):
        """All words as a cached numpy object array (id order).

        Backs vectorized detokenization (``detokenize_batch``): a
        fancy-index gather over this array replaces the per-token Python
        ``word()`` loop.  Safe to cache —
        the vocab is immutable after construction.
        """
        arr = getattr(self, "_words_arr", None)
        if arr is None:
            import numpy as np

            arr = np.array(self._id_to_word, dtype=object)
            self._words_arr = arr
        return arr

    # --- serialization (checkpoints carry the vocab; lrcn.jl:185,230) ---

    def to_json(self) -> str:
        return json.dumps({"words": self._id_to_word[len(_RESERVED):]})

    @classmethod
    def from_json(cls, payload: str) -> "Vocab":
        return cls(json.loads(payload)["words"])

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Vocab":
        with open(path) as f:
            return cls.from_json(f.read())


def caption_to_line(token_row, vocab: Vocab) -> str:
    """Token ids (BOS at [0]) -> the reference's caption line format.

    Reference: print each word followed by a space, stop at EOS, then
    print "." (lrcn.jl:634-640) — i.e. ``"w1 w2 ... wn ."``.
    """
    words = []
    for t in token_row[1:]:
        if int(t) == EOS_ID:
            break
        words.append(vocab.word(int(t)))
    return " ".join(words + ["."])


def detokenize_batch(tokens, vocab: Vocab) -> list[str]:
    """Vectorized ``caption_to_line`` over (N, T) token rows: a numpy EOS
    scan and an object-array gather leave one join per caption in
    Python."""
    import numpy as np

    toks = np.asarray(tokens)[:, 1:]            # drop BOS
    if toks.size == 0:
        return ["."] * len(toks)
    eos = toks == EOS_ID
    has = eos.any(axis=1)
    ends = np.where(has, eos.argmax(axis=1), toks.shape[1])
    words = vocab.words_array()[toks]           # (N, T-1) object gather
    return [" ".join(list(words[i, :e]) + ["."])
            for i, e in enumerate(ends)]
