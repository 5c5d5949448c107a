"""What the caption drivers share: the served decoder, the caption lines'
counts, and the check of the lines against the reference.

The check takes ``check_captions`` of the last window pass's captions,
drawn from the seed, with the longest among them; both cells take all
of them (a widest gap over a few hundred swung with the seed).  The
reference (float32) runs its own beam search over each sampled fc7 row,
and once over the row with the served caption's words fed in:

- ``caption_gap``: the widest gap, in nats, by which a served token's
  log-probability lies below the reference's ``beam``-th best at its
  position.  A beam of width K extends each hypothesis only by one of
  its K best words, so a served token outside the reference's K best is
  wrong by that gap; with K = 1 this is the gap below the reference's
  best token;
- ``beam_mismatch``: the share of the sampled captions that differ from
  the reference's beam search caption of the same row.  It reads how the
  search ranks and scores its hypotheses (the log-sum-exp that sets the
  scores across beams, the choice among the K * K candidates), which the
  gap of single tokens cannot see: a search that keeps a worse beam, or
  collapses to greedy, returns tokens that are each among the K best.
  Rounding alone changes some captions (near-ties among the K * K
  candidates, or at a caption's end); a share over thousands of rows
  holds steady from seed to seed where a caption's score would not.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs
from portbench.harness.main import Check
from portbench.reference import lrcn as ref
from portbench.reference.precision import strict_float32


def program_decoder(ctx):
    from lrcn_tpu_torch.models.lrcn import LRCNDecoder

    weights = inputs.decoder_weights(ctx.config, ctx.seed, ctx.device,
                                     "serve")
    dtype = getattr(torch, ctx.config["compute_dtype"])
    return LRCNDecoder(weights, dtype)


def program_vocab(cfg: dict):
    from lrcn_tpu_torch.core.vocab import Vocab

    return Vocab(inputs.vocab_words(cfg))


def word_ids(line: str, cfg: dict) -> list[int]:
    """A caption line (``"w1 w2 ... ."``) back to word ids."""
    reserved = {"``": inputs.BOS_ID, "##": 2, "~~": inputs.EOS_ID}
    words = line.split()
    if not words or words[-1] != ".":
        raise ValueError(f"not a caption line: {line!r}")
    ids = []
    for w in words[:-1]:
        if w in reserved:
            ids.append(reserved[w])
        elif w.startswith("w") and w[1:].isdigit() and (
                inputs.N_RESERVED <= int(w[1:]) < cfg["vocab_size"]):
            ids.append(int(w[1:]))
        else:
            raise ValueError(f"not a vocabulary word: {w!r}")
    return ids


def steps_needed(n_words: int, max_words: int) -> int:
    """Search steps a caption of ``n_words`` words needs: its words and
    EOS, or ``max_words + 1`` where it never ended."""
    return min(n_words + 1, max_words + 1)


def pass_counts(passes: list[list[str]], n_images: int, traffic: dict
                ) -> dict:
    """The window's caption counts: captions returned, and for each pass
    the hypotheses the search needs at each step (``beam`` for every
    caption not yet ended)."""
    beam, max_words = traffic["beam_width"], traffic["max_words"]
    rows_by_step, steps = [], 0
    for lines in passes:
        need = np.array([steps_needed(len(line.split()) - 1, max_words)
                         for line in lines])
        steps += int(need.sum())
        rows_by_step.append([beam * int((need > s).sum())
                             for s in range(max_words + 1)])
    returned = sum(len(lines) for lines in passes)
    return {"attempted": n_images * len(passes),
            "failed": n_images * len(passes) - returned,
            "captions": returned, "caption_steps": steps,
            "rows_by_step": rows_by_step}


def sample(lines: list[str], n: int, seed: int) -> np.ndarray:
    """``n`` caption indices drawn from the seed, the longest among them."""
    rng = inputs.host_rng(seed, inputs.CHECK)
    picked = rng.choice(len(lines), size=min(n, len(lines)), replace=False)
    longest = int(np.argmax([len(line.split()) for line in lines]))
    return np.unique(np.append(picked, longest))


def caption_gap(ctx, feats: torch.Tensor, captions: list[list[int]]
                ) -> float:
    """The widest gap of ``captions`` (word ids) over the fc7 rows
    ``feats``, against the reference's float32 log-probabilities."""
    tr = ctx.traffic
    p = inputs.decoder_weights(ctx.config, ctx.seed, feats.device, "serve")
    with strict_float32():
        return float(ref.token_gaps(p, feats, captions, tr["max_words"],
                                    tr["beam_width"]).max())


def beam_mismatch(ctx, feats: torch.Tensor, captions: list[list[int]],
                  best: list[list[int]] | None = None) -> float:
    """The share of ``captions`` unlike the reference's float32 beam
    search over ``feats``; ``best``: that search's captions, where
    already run."""
    if best is None:
        tr = ctx.traffic
        p = inputs.decoder_weights(ctx.config, ctx.seed, feats.device,
                                   "serve")
        with strict_float32():
            best, _ = ref.beam_search(p, feats, tr["beam_width"],
                                      tr["max_words"])
    return float(np.mean([a != b for a, b in zip(captions, best)]))


NUMBERS = {"caption_gap": caption_gap, "beam_mismatch": beam_mismatch}


def check(ctx, feats: torch.Tensor, lines: list[str], missing: int
          ) -> list[Check]:
    """The numbers of ``NUMBERS`` that the cell's limits name, over the
    sampled ``lines`` (fc7 rows ``feats``), and ``missing_captions``: the
    window's captions never returned."""
    out = [Check("missing_captions", float(missing),
                 ctx.limits["missing_captions"])]
    names = [n for n in ctx.limits if n in NUMBERS]
    try:
        captions = [word_ids(line, ctx.config) for line in lines]
    except ValueError:
        return out + [Check(n, float("inf"), ctx.limits[n]) for n in names]
    return out + [Check(n, NUMBERS[n](ctx, feats, captions), ctx.limits[n])
                  for n in names]
