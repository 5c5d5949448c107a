"""Batched beam search and greedy caption decoding on the device
(counterpart of ``lrcn_tpu/decode/beam.py``).

A batch of images decodes together: B·K hypotheses go through one
``decode_step`` per word.  Each step launches the fused LSTM kernel twice
(``models/lrcn.py``) and the fused top-k + log-sum-exp kernel once.  The
loop has a fixed trip count of ``max_words + 1`` and never waits for the
device: finished rows are masked, not skipped, so the host only enqueues
work and the caller's fetch of the tokens is the one synchronisation.

Reference semantics kept exactly, as in the JAX package:

- scores accumulate in log space;
- the first step expands only hypothesis 0 (lrcn.jl:662-664): the other
  beams start at ``NEG_INF = -1e30``;
- candidate selection is two top-k stages: per hypothesis over the
  vocabulary (the kernel; ``vals - lse`` is the top-k of ``log_softmax``),
  then over the K·K shortlist with the lower index first among ties
  (``lax.top_k``'s rule, here a stable descending sort);
- hypotheses that emit EOS keep extending; a row is done when its best
  hypothesis ends in EOS (lrcn.jl:670), after which it records identity
  parents, EOS filler and a frozen score;
- the winning path is read back through the parent pointers.

The beam search also runs the MoE text decoder (``models/moe_text.py``),
chosen once a search by the decoder's type: a step object holds what a
hypothesis carries and reorders it by parent after each selection, the
LSTM state (``_LSTMSteps``) or, for the MoE decoder (``_MoESteps``), a
latent cache of the decoded positions beside the image-and-prompt prefix
that is prefilled once a row and shared by its K hypotheses.  The MoE
decoder's greedy search is this beam search at K = 1.

Rows are independent, so the grouped variants decode all G·B rows of a
(G, B, D) group in one search.

On a card every search is one program, as ``jax.jit`` makes each search
of the JAX package one: ``beam_search``, ``greedy_search`` and
``rows_search`` (and so ``search`` and the grouped variants) capture
their eager body into a CUDA graph at the second call of a shape (the
first runs eagerly) and replay it from then on (``utils/graphs.py``), one launch a search instead
of some 30 a step.  ``beam_search_fn`` and ``greedy_search_fn`` stay the
eager bodies: what ``torch.export`` traces and what the graphs capture.
On CPU tensors the bodies run eagerly.
"""

from __future__ import annotations

import functools

import torch

from lrcn_tpu_torch.core.vocab import BOS_ID, EOS_ID
from lrcn_tpu_torch.models import lrcn, moe_text
from lrcn_tpu_torch.models.lrcn import LRCNDecoder, LSTMState
from lrcn_tpu_torch.models.moe_text import MoETextDecoder
from lrcn_tpu_torch.ops.kernels import (topk_logsumexp,
                                        topk_logsumexp_reference)
from lrcn_tpu_torch.utils import graphs

NEG_INF = -1e30


def _top_k_stable(x: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_beams(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Reorder the beam axis: x (B, K, D) indexed by parent (B, K)."""
    return torch.gather(x, 1, parent[:, :, None].expand(-1, -1, x.shape[-1]))


class _LSTMSteps:
    """The LRCN decoder's steps for a beam search of K hypotheses a row:
    the image's projection, once, and the LSTM state, reordered by
    parent."""

    def __init__(self, decoder: LRCNDecoder, feats: torch.Tensor, k: int,
                 use_kernels: bool):
        b_dim = feats.shape[0]
        self.decoder, self.use_kernels = decoder, use_kernels
        cnn_proj = lrcn.cnn_projection(decoder, feats)            # (B, F)
        # each row's projection k times (repeat_interleave without its sizes)
        self.cnn_flat = cnn_proj[:, None].expand(-1, k, -1).reshape(
            b_dim * k, -1)
        self.state = lrcn.init_state(decoder, b_dim * k, feats.device)
        self.shape = (b_dim, k)

    def __call__(self, last: torch.Tensor, t: int) -> torch.Tensor:
        self.state, logits = lrcn.decode_step(
            self.decoder, self.state, last, self.cnn_flat, self.use_kernels)
        return logits

    def reorder(self, parent: torch.Tensor, t: int) -> None:
        b_dim, k = self.shape
        self.state = LSTMState(*(
            _gather_beams(s.view(b_dim, k, -1), parent).view(b_dim * k, -1)
            for s in self.state))


class _MoESteps:
    """The MoE text decoder's steps: the image-and-prompt prefix prefilled
    once a row and shared by its K hypotheses, and a latent cache of the
    decoded positions a hypothesis, reordered by parent (the counterpart
    of the LSTM state's reorder)."""

    def __init__(self, decoder: MoETextDecoder, feats: torch.Tensor, k: int,
                 max_words: int):
        cfg = decoder.cfg
        self.decoder = decoder
        self.prefix = moe_text.prefill(decoder, feats)
        self.cache = torch.zeros(
            (cfg.num_hidden_layers, feats.shape[0] * k, max_words + 1,
             cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            dtype=decoder.compute_dtype, device=feats.device)

    def __call__(self, last: torch.Tensor, t: int) -> torch.Tensor:
        return moe_text.decode_step(self.decoder, self.prefix, self.cache, t,
                                    last)

    def reorder(self, parent: torch.Tensor, t: int) -> None:
        moe_text.reorder_cache(self.cache, parent, t)


@torch.inference_mode()
def beam_search(decoder: LRCNDecoder, feats: torch.Tensor, *,
                beam_width: int = 3, max_words: int = 30,
                use_kernels: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search over a batch of fc7 rows (:func:`beam_search_fn` under
    ``torch.inference_mode``; on a card with ``use_kernels``, one replay
    of the graph captured for this shape).

    Args:
      decoder: the decoder, on the device of ``feats``.
      feats: (B, D) fc7 features (already L1-normalized, lrcn.jl:597), in
        float32 or the compute dtype.
      beam_width: K (reference ``--beam_width``).
      max_words: cap on generated tokens (reference ``--generate``).
      use_kernels: False runs the kernels' plain versions (see
        ``models.lrcn.decode_step``).

    Returns:
      tokens: (B, max_words+2) int64, BOS in column 0, then up to
        max_words+1 generated tokens with EOS filler after the first EOS.
      scores: (B,) float32 cumulative log-probability of the best
        hypothesis.
    """
    body = functools.partial(beam_search_fn, decoder, beam_width=beam_width,
                             max_words=max_words, use_kernels=use_kernels)
    return graphs.run(decoder, ("beam", beam_width, max_words), body,
                      (feats,), graph=use_kernels)


def beam_search_fn(decoder: LRCNDecoder, feats: torch.Tensor, *,
                   beam_width: int = 3, max_words: int = 30,
                   use_kernels: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The search of :func:`beam_search` with no grad mode of its own: the
    function ``torch.export`` traces (``export.py``)."""
    b_dim, k = feats.shape[0], beam_width
    device = feats.device
    topk = topk_logsumexp if use_kernels else topk_logsumexp_reference
    step = (_MoESteps(decoder, feats, k, max_words)
            if isinstance(decoder, MoETextDecoder)
            else _LSTMSteps(decoder, feats, k, use_kernels))

    # all hypotheses are identical at step 0: only beam 0 may expand
    scores = torch.full((b_dim, k), NEG_INF, dtype=torch.float32,
                        device=device)
    scores[:, 0] = 0.0
    last = torch.full((b_dim, k), BOS_ID, dtype=torch.int64, device=device)
    done = torch.zeros((b_dim,), dtype=torch.bool, device=device)
    identity = torch.arange(k, device=device).expand(b_dim, k)
    eos = torch.full((b_dim, k), EOS_ID, dtype=torch.int64, device=device)

    parents, words = [], []
    for t in range(max_words + 1):
        logits = step(last.reshape(-1), t)
        vals, step_words, lse = topk(logits, k)                  # (B*K, K)
        step_scores = vals - lse[:, None]
        cand = scores[:, :, None] + step_scores.view(b_dim, k, k)
        top_scores, sel = _top_k_stable(cand.view(b_dim, k * k), k)
        parent = torch.div(sel, k, rounding_mode="floor")
        word = torch.gather(step_words.view(b_dim, k * k).long(), 1, sel)

        step.reorder(parent, t)

        # finished rows: identity parents, EOS filler, frozen scores; the
        # state and `last` keep evolving, and all they influence is masked
        keep = done[:, None]
        parents.append(torch.where(keep, identity, parent))
        words.append(torch.where(keep, eos, word))
        scores = torch.where(keep, scores, top_scores)
        # stop rule: the CURRENT BEST hypothesis ends with EOS (lrcn.jl:670)
        done = done | (word[:, 0] == EOS_ID)
        last = word

    # parent-pointer backtrace from the best final hypothesis
    beam = torch.zeros((b_dim, 1), dtype=torch.int64, device=device)
    path = [None] * len(words)
    for t in reversed(range(len(words))):
        path[t] = torch.gather(words[t], 1, beam)
        beam = torch.gather(parents[t], 1, beam)
    bos = torch.full((b_dim, 1), BOS_ID, dtype=torch.int64, device=device)
    return torch.cat([bos] + path, dim=1), scores[:, 0]


@torch.inference_mode()
def greedy_search(decoder: LRCNDecoder, feats: torch.Tensor, *,
                  max_words: int = 30) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy (argmax) decoding: beam search with K=1 semantics,
    through the top-k kernel at k=1.  Same return contract as
    :func:`beam_search`; :func:`greedy_search_fn` under
    ``torch.inference_mode``, on a card one graph replay."""
    body = functools.partial(greedy_search_fn, decoder, max_words=max_words)
    return graphs.run(decoder, ("greedy", max_words), body, (feats,))


def greedy_search_fn(decoder: LRCNDecoder, feats: torch.Tensor, *,
                     max_words: int = 30
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The search of :func:`greedy_search` with no grad mode of its own."""
    b_dim = feats.shape[0]
    device = feats.device

    cnn_proj = lrcn.cnn_projection(decoder, feats)
    state = lrcn.init_state(decoder, b_dim, device)
    last = torch.full((b_dim,), BOS_ID, dtype=torch.int64, device=device)
    scores = torch.zeros((b_dim,), dtype=torch.float32, device=device)
    done = torch.zeros((b_dim,), dtype=torch.bool, device=device)
    eos = torch.full((b_dim,), EOS_ID, dtype=torch.int64, device=device)

    words = []
    for _ in range(max_words + 1):
        state, logits = lrcn.decode_step(decoder, state, last, cnn_proj)
        vals, idx, lse = topk_logsumexp(logits, 1)
        word = idx[:, 0].long()
        # finished rows emit EOS filler and stop accumulating score
        words.append(torch.where(done, eos, word))
        scores = torch.where(done, scores, scores + (vals[:, 0] - lse))
        done = done | (word == EOS_ID)
        last = word
    bos = torch.full((b_dim,), BOS_ID, dtype=torch.int64, device=device)
    return torch.stack([bos] + words, dim=1), scores


def search(decoder: LRCNDecoder, feats: torch.Tensor, *, beam_width: int,
           max_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy for ``beam_width == 1``, else beam search
    (:func:`search_fn`; on a card one graph replay)."""
    body = functools.partial(search_fn, decoder, beam_width=beam_width,
                             max_words=max_words)
    return graphs.run(decoder, ("search", beam_width, max_words), body,
                      (feats,))


def search_fn(decoder: LRCNDecoder, feats: torch.Tensor, *,
              beam_width: int, max_words: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The eager body of :func:`search`; the MoE text decoder takes the
    beam search at every width, greedy being its width 1."""
    if beam_width == 1 and not isinstance(decoder, MoETextDecoder):
        return greedy_search_fn(decoder, feats, max_words=max_words)
    return beam_search_fn(decoder, feats, beam_width=beam_width,
                          max_words=max_words)


def _grouped(fn, decoder, feats: torch.Tensor, **kwargs):
    g_dim, b_dim = feats.shape[:2]
    tokens, scores = fn(decoder, feats.reshape(g_dim * b_dim, -1), **kwargs)
    return tokens.view(g_dim, b_dim, -1), scores.view(g_dim, b_dim)


def beam_search_grouped(decoder: LRCNDecoder, feats: torch.Tensor, *,
                        beam_width: int = 3, max_words: int = 30
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, B, D) -> ((G, B, max_words+2) tokens, (G, B) scores): the G
    batches decode as one search of G·B rows (counterpart of
    ``beam_search_scan``)."""
    return _grouped(beam_search, decoder, feats, beam_width=beam_width,
                    max_words=max_words)


def greedy_search_grouped(decoder: LRCNDecoder, feats: torch.Tensor, *,
                          max_words: int = 30
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The greedy analogue of :func:`beam_search_grouped`."""
    return _grouped(greedy_search, decoder, feats, max_words=max_words)


def _rows_search_fn(decoder: LRCNDecoder, table: torch.Tensor,
                    idx: torch.Tensor, *, beam_width: int, max_words: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    tokens, scores = search_fn(decoder, table[idx.reshape(-1)],
                               beam_width=beam_width, max_words=max_words)
    return tokens.view(*idx.shape, -1), scores.view(idx.shape)


@torch.inference_mode()
def rows_search(decoder: LRCNDecoder, table: torch.Tensor,
                idx: torch.Tensor, *, beam_width: int, max_words: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather rows of a device-resident feature table, then search.

    ``idx`` is (B,) or (G, B) row indices on the table's device; the
    result has the shape of ``idx`` plus the token axis, so a (G, B) group
    is one search (the counterpart of both ``rows_search`` and
    ``rows_search_scan``).  The gather is exact, so this equals searching
    the gathered rows.  On a card the gather and the search are one graph,
    which reads the table in place: a new table captures anew.
    """
    body = functools.partial(_rows_search_fn, decoder, table,
                             beam_width=beam_width, max_words=max_words)
    return graphs.run(decoder, ("rows", beam_width, max_words), body,
                      (idx,), reads=(table,))
