"""The LRCN caption decoder in plain float32 PyTorch.

A factored 2-layer LSTM (lrcn.jl:489-551): word embedding; LSTM-1 over
the embedded word; its output projected to F (``w_factor``); the fc7 row
projected to F once per image (``w_cnn``); LSTM-2 over the concat of the
two; the vocabulary logits ``h2 @ w_out + b_out``.  LSTM weights are
packed ``(X+H, 4H)``, gates [forget, ingate, outgate, change]:
``c' = c σ(f) + σ(i) tanh(g)``, ``h' = σ(o) tanh(c')`` (lrcn.jl:528-538).
Ids: EOS 0, BOS 1.

- ``beam_search``: the reference's beam search (lrcn.jl:643-678): scores
  summed in log space; at the first step only hypothesis 0 expands; each
  step takes every hypothesis's best ``K`` words, then the best ``K`` of
  the ``K*K`` (the lower index first among ties); a row is done when its
  best hypothesis ends in EOS, and keeps that hypothesis; ``max_words+1``
  steps at most.
- ``token_gaps``: how far the tokens of given captions lie outside the
  ``k`` best at their positions.
- ``loss``: the teacher-forced training loss (lrcn.jl:553-581): inputs
  BOS then the words, targets the words then EOS at each row's length,
  padding masked, the mean over the predictions; dropout multipliers on
  the embeddings and on LSTM-2's input (lrcn.jl:542,547).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import cast, product

EOS, BOS = 0, 1
NEG_INF = -1e30


def mm(a: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    return product(cast(a, quant) @ cast(w, quant), quant)


def cell(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
         c: torch.Tensor, quant=None) -> tuple[torch.Tensor, torch.Tensor]:
    n_in = x.shape[-1]
    gates = mm(x, w[:n_in], quant) + mm(h, w[n_in:], quant) + b
    f, i, o, g = gates.chunk(4, dim=-1)
    c = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def step(p: dict, state: tuple, words: torch.Tensor, cnn: torch.Tensor,
         quant=None, drop=None) -> tuple[tuple, torch.Tensor]:
    """One word for every row: (h1, c1, h2, c2), previous words (R,), the
    image projection (R, F) -> new state, logits (R, V).  ``drop``: the
    two dropout multipliers of this step, or None."""
    h1, c1, h2, c2 = state
    x = p["embedding"][words]
    if drop is not None:
        x = x * drop[0]
    h1, c1 = cell(p["lstm1/w"], p["lstm1/b"], x, h1, c1, quant)
    x2 = torch.cat([mm(h1, p["w_factor"], quant), cnn], dim=-1)
    if drop is not None:
        x2 = x2 * drop[1]
    h2, c2 = cell(p["lstm2/w"], p["lstm2/b"], x2, h2, c2, quant)
    return (h1, c1, h2, c2), mm(h2, p["w_out"], quant) + p["b_out"]


def zero_state(p: dict, rows: int, device) -> tuple:
    h1 = p["lstm1/b"].shape[0] // 4
    h2 = p["lstm2/b"].shape[0] // 4
    z = lambda d: torch.zeros((rows, d), device=device)
    return z(h1), z(h1), z(h2), z(h2)


@torch.no_grad()
def beam_search(p: dict, feats: torch.Tensor, beam: int, max_words: int,
                quant=None) -> tuple[list[list[int]], torch.Tensor]:
    """feats (B, C) -> (the best caption of each row as word ids, EOS
    left out; its score (B,))."""
    n, k, device = feats.shape[0], beam, feats.device
    cnn = mm(feats, p["w_cnn"], quant).repeat_interleave(k, dim=0)
    scores = torch.full((n, k), NEG_INF, device=device)
    scores[:, 0] = 0.0
    last = torch.full((n * k,), BOS, dtype=torch.long, device=device)
    state = zero_state(p, n * k, device)
    done = torch.zeros(n, dtype=torch.bool, device=device)
    paths = torch.zeros((n, k, 0), dtype=torch.long, device=device)
    for _ in range(max_words + 1):
        state, logits = step(p, state, last, cnn, quant)
        logp = torch.log_softmax(logits, dim=-1)
        top_lp, top_w = logp.topk(k, dim=-1)                    # (N*K, K)
        cand = scores[:, :, None] + top_lp.view(n, k, k)
        flat = cand.view(n, k * k)
        order = torch.sort(flat, dim=-1, descending=True, stable=True)[1]
        sel = order[:, :k]
        parent = sel // k
        new_scores = torch.gather(flat, 1, sel)
        word = torch.gather(top_w.view(n, k * k), 1, sel)
        keep = done[:, None]
        parent = torch.where(keep, torch.arange(k, device=device), parent)
        word = torch.where(keep, torch.full_like(word, EOS), word)
        scores = torch.where(keep, scores, new_scores)
        paths = torch.cat([torch.gather(
            paths, 1, parent[:, :, None].expand(-1, -1, paths.shape[2])),
            word[:, :, None]], dim=2)
        rows = (torch.arange(n, device=device)[:, None] * k + parent
                ).reshape(-1)
        state = tuple(s[rows] for s in state)
        done = done | (word[:, 0] == EOS)
        last = word.reshape(-1)
    captions = []
    for path in paths[:, 0].tolist():
        captions.append(path[:path.index(EOS)] if EOS in path else path)
    return captions, scores[:, 0]


@torch.no_grad()
def token_gaps(p: dict, feats: torch.Tensor, captions: list[list[int]],
               max_words: int, k: int, quant=None) -> torch.Tensor:
    """For each caption, teacher-forced on its own words: the widest gap
    by which one of its tokens (its words, then EOS where it has fewer
    than ``max_words + 1``) lies below the ``k``-th best log-probability
    at its position, 0 where every token is among the ``k`` best.  A beam
    of width ``k`` only ever extends a hypothesis by one of its ``k``
    best words, so a sound search reads 0 but for near-ties."""
    n, device = feats.shape[0], feats.device
    steps = max_words + 1
    targets = np.full((n, steps), EOS, dtype=np.int64)
    mask = np.zeros((n, steps), dtype=bool)
    for r, words in enumerate(captions):
        targets[r, :len(words)] = words
        mask[r, :min(len(words) + 1, steps)] = True
    targets = torch.from_numpy(targets).to(device)
    mask = torch.from_numpy(mask).to(device)
    cnn = mm(feats, p["w_cnn"], quant)
    state = zero_state(p, n, device)
    last = torch.full((n,), BOS, dtype=torch.long, device=device)
    widest = torch.zeros(n, device=device)
    for t in range(steps):
        state, logits = step(p, state, last, cnn, quant)
        lp = torch.log_softmax(logits, dim=-1)
        kth = lp.topk(k, dim=-1).values[:, -1]
        gap = (kth - lp.gather(1, targets[:, t:t + 1])[:, 0]).clamp(min=0)
        widest = torch.maximum(widest, torch.where(mask[:, t], gap, 0.0))
        last = targets[:, t]
    return widest


def loss_sum(p: dict, tokens: torch.Tensor, lengths: torch.Tensor,
             feats: torch.Tensor, drop, quant=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, number of predictions) of padded captions (B, L)
    with lengths (B,) given fc7 rows (B, C); ``drop``: the (T, B, E) and
    (T, B, 2F) dropout multipliers, T = L + 1, or None."""
    n, length = tokens.shape
    device = tokens.device
    tokens = tokens.long()
    inputs = torch.cat([torch.full((n, 1), BOS, device=device), tokens], 1)
    pos = torch.arange(length + 1, device=device)[None, :]
    targets = torch.cat([tokens, torch.zeros((n, 1), dtype=torch.long,
                                             device=device)], 1)
    targets = torch.where(pos == lengths[:, None].long(), EOS, targets)
    mask = (pos <= lengths[:, None].long()).float()
    cnn = mm(feats, p["w_cnn"], quant)
    state = zero_state(p, n, device)
    total = torch.zeros((), device=device)
    for t in range(length + 1):
        step_drop = None if drop is None else (drop[0][t], drop[1][t])
        state, logits = step(p, state, inputs[:, t], cnn, quant, step_drop)
        nll = F.cross_entropy(logits, targets[:, t], reduction="none")
        total = total + (nll * mask[:, t]).sum()
    return total, mask.sum()
