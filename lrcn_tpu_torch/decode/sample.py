"""Batched temperature sampling and best-of-N caption generation on the
device (counterpart of ``lrcn_tpu/decode/sample.py``).

The paper's strongest generation strategy is sampling ("sample 100,
T=1.5/2.0", 1411.4389.pdf Table 6): draw N captions per image from the
tempered softmax and keep the one the model scores highest.  All B·N
hypotheses go through one ``decode_step`` per word, so each step launches
the fused LSTM kernel twice (``models/lrcn.py``); the JAX function steps
the XLA cell (its ``decode_step`` runs the Pallas kernel only when asked
by ``use_pallas``, which sampling does not pass).  The loop has a fixed
trip count of ``max_words + 1`` and never waits for the device.

Semantics of the JAX package, kept exactly:

- each step's token is ``argmax(logits / temperature + gumbel)``, which is
  what ``jax.random.categorical`` computes, with fresh Gumbel noise of the
  logits' shape every step;
- scores add the UNtempered log-probability of the drawn token (the
  selection criterion);
- finished rows freeze their tokens (EOS filler after the first EOS),
  score and state;
- ``best_of_n_search`` keeps each image's first highest-scoring sample, as
  ``jnp.argmax`` does.

The noise is this package's own: drawn from a ``torch.Generator`` on the
device, or given as ``gumbel`` (e.g. the noise JAX draws, which the tests
inject into both packages to compare tokens).

On a card each search is one program, as ``jax.jit`` makes each of the
JAX package's: ``sample_search`` and ``best_of_n_search`` capture their
eager body into a CUDA graph at the second call of a signature (the
first runs eagerly) and replay it from then on (``utils/graphs.py``).
The signature holds the static arguments and the generator object: the
graph registers the generator, so a replay draws from its state at the
time and advances it as an eager call does, and successive calls on one
generator give the same tokens eagerly or replayed.  Injected ``gumbel``
noise is one more input.  ``sample_search_fn`` and ``best_of_n_search_fn``
stay the eager bodies: what ``torch.export`` traces and what the graphs
capture.
"""

from __future__ import annotations

import functools

import torch

from lrcn_tpu_torch.core.vocab import BOS_ID, EOS_ID
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.models.lrcn import LRCNDecoder, LSTMState
from lrcn_tpu_torch.utils import graphs


def gumbel_noise(shape: tuple[int, ...],
                 generator: torch.Generator | None, device=None
                 ) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, u uniform in [tiny, 1), on
    the generator's device (``jax.random.gumbel``'s formula).  With no
    generator, u is drawn from ``device``'s default generator."""
    if generator is None:       # no generator argument: traceable
        u = torch.rand(shape, device=device)
    else:
        u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


@torch.inference_mode()
def sample_search(decoder: LRCNDecoder, feats: torch.Tensor, *,
                  temperature: float = 1.0, max_words: int = 30,
                  generator: torch.Generator | None = None,
                  gumbel: torch.Tensor | None = None,
                  use_kernels: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample one caption per feature row.

    Args:
      decoder: the decoder, on the device of ``feats``.
      feats: (B, D) fc7 features.
      generator: draws the noise, on the device of ``feats``.
      gumbel: (max_words+1, B, V) noise, one slice a step, in place of
        ``generator``'s.  One of the two is required.
      use_kernels: False runs the LSTM kernel's plain version (see
        ``models.lrcn.decode_step``).

    Returns (tokens (B, max_words+2) int64 with BOS at column 0, scores
    (B,) float32 untempered cumulative log-probabilities).  On a card one
    graph replay (eager at a signature's first call).
    """
    return _graphed(sample_search_fn, ("sample",), decoder, feats,
                    temperature=temperature, max_words=max_words,
                    generator=generator, gumbel=gumbel,
                    use_kernels=use_kernels)


def _graphed(body, key: tuple, decoder: LRCNDecoder, feats: torch.Tensor, *,
             generator, gumbel, **static):
    """``body(decoder, feats, ...)`` through ``graphs.run``: the noise is
    one more input where it is given, else drawn from ``generator``, whose
    object is part of the signature."""
    if gumbel is None and generator is None:
        raise ValueError("sampling needs a generator or gumbel noise")
    key = (*key, *sorted(static.items()))
    if gumbel is not None:
        return graphs.run(
            decoder, key, lambda f, g: body(decoder, f, gumbel=g, **static),
            (feats, gumbel))
    return graphs.run(
        decoder, (*key, generator),
        functools.partial(body, decoder, generator=generator, **static),
        (feats,), generators=(generator,))


def sample_search_fn(decoder: LRCNDecoder, feats: torch.Tensor, *,
                     temperature: float = 1.0, max_words: int = 30,
                     generator: torch.Generator | None = None,
                     gumbel: torch.Tensor | None = None,
                     use_kernels: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The search of :func:`sample_search` with no grad mode of its own:
    the function ``torch.export`` traces (``export.py``).  With neither
    ``generator`` nor ``gumbel``, the noise comes from the default
    generator of the device of ``feats``, so that the traced program draws
    it: seeding that generator with s gives the stream of
    ``torch.Generator(device).manual_seed(s)``."""
    b_dim = feats.shape[0]
    device = feats.device

    cnn_proj = lrcn.cnn_projection(decoder, feats)
    tokens = torch.full((b_dim, max_words + 2), EOS_ID, dtype=torch.int64,
                        device=device)
    tokens[:, 0] = BOS_ID
    scores = torch.zeros((b_dim,), dtype=torch.float32, device=device)
    state = lrcn.init_state(decoder, b_dim, device)
    done = torch.zeros((b_dim,), dtype=torch.bool, device=device)
    for step in range(max_words + 1):
        new_state, logits = lrcn.decode_step(decoder, state, tokens[:, step],
                                             cnn_proj, use_kernels)
        noise = (gumbel[step] if gumbel is not None
                 else gumbel_noise(tuple(logits.shape), generator, device))
        word = torch.argmax(logits / temperature + noise, dim=-1)
        step_score = (logits.gather(1, word[:, None])[:, 0]
                      - torch.logsumexp(logits, dim=-1))
        tokens[:, step + 1] = torch.where(done, tokens[:, step + 1], word)
        scores = torch.where(done, scores, scores + step_score)
        state = LSTMState(*(torch.where(done[:, None], old, new)
                            for old, new in zip(state, new_state)))
        done = done | (word == EOS_ID)
    return tokens, scores


@torch.inference_mode()
def best_of_n_search(decoder: LRCNDecoder, feats: torch.Tensor, *,
                     n_samples: int = 100, temperature: float = 2.0,
                     max_words: int = 30,
                     generator: torch.Generator | None = None,
                     gumbel: torch.Tensor | None = None,
                     use_kernels: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The paper's sampling strategy: N draws per image, keep the best.

    All B·N hypotheses decode in one :func:`sample_search` (row b·N + n is
    image b's n-th draw; ``gumbel`` is (max_words+1, B·N, V)).  Returns the
    model-preferred sample per image: (tokens (B, max_words+2), scores
    (B,)).
    """
    tokens, scores = sample_search(
        decoder, feats.repeat_interleave(n_samples, dim=0),
        temperature=temperature, max_words=max_words, generator=generator,
        gumbel=gumbel, use_kernels=use_kernels)
    return _keep_best(tokens, scores, n_samples)


def best_of_n_search_fn(decoder: LRCNDecoder, feats: torch.Tensor, *,
                        n_samples: int = 100, temperature: float = 2.0,
                        max_words: int = 30,
                        generator: torch.Generator | None = None,
                        gumbel: torch.Tensor | None = None,
                        use_kernels: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`best_of_n_search` with no grad mode of its own, over
    :func:`sample_search_fn` (the default generator where neither
    ``generator`` nor ``gumbel`` is given): the function ``torch.export``
    traces."""
    tokens, scores = sample_search_fn(
        decoder, feats.repeat_interleave(n_samples, dim=0),
        temperature=temperature, max_words=max_words, generator=generator,
        gumbel=gumbel, use_kernels=use_kernels)
    return _keep_best(tokens, scores, n_samples)


def _keep_best(tokens: torch.Tensor, scores: torch.Tensor, n_samples: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each image's first highest-scoring of its ``n_samples`` rows."""
    tokens = tokens.view(-1, n_samples, tokens.shape[-1])
    scores = scores.view(-1, n_samples)
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(scores.shape[0], device=scores.device)
    return tokens[rows, best], scores[rows, best]
