"""Kimi-VL-A3B's language model as a caption decoder, in plain float32
PyTorch.

The text model of Kimi-VL-A3B-Instruct (its ``config.json``,
``text_config``: ``model_type`` deepseek_v3, ``q_lora_rank`` null), as
the published modeling code computes it, over one whole sequence at a
time: no cache, no batching of positions, no kernel.  A sequence is the
image's position (a projector of its fc7 row), the prompt's ids, BOS and
the caption's words.  Per layer, with pre-norm RMSNorm (eps
``rms_norm_eps``) before each sublayer:

- attention (MLA): ``q = W_q x``, H heads of 128 nope + 64 rope dims;
  ``[c; k_pe] = W_kva x``, ``c`` RMS-normed (eps 1e-6, the published
  code's default for this norm); ``[k_nope; v] = W_kvb c`` per head;
  RoPE (theta ``rope_theta``, no scaling) on ``q_pe`` and the one
  ``k_pe`` all heads share, in the published code's layout (dims ``2i``
  and ``2i + 1`` paired, then rotated as halves); causal softmax of
  ``q . k / sqrt(192)``; ``W_o`` over the heads' values;
- feed-forward: layer 0 a SwiGLU of width ``intermediate_size``; the
  others 64 routed experts and a shared MLP: ``s = sigmoid(W_g x)``, the
  experts the top 6 of ``s + e_score_correction_bias`` (one group, so no
  group limit), weighted by ``s`` there over their sum times
  ``routed_scaling_factor``; out ``sum_i w_i E_i(x) + S(x)``, each a
  SwiGLU ``W_down(silu(W_gate x) * W_up x)``, ``S`` of width 2 x 1,408;
- a final RMSNorm and the untied head over the vocabulary.

Departures from the published description, each the configuration's
(``portbench/configs/kimi-vl-a3b-text-coco-fc7.json``, ``assumed``):

- the vision tower (MoonViT) is not here: the image is one position, the
  projector of Kimi-VL (LayerNorm, Linear 4,096 -> 4,096, GELU, Linear ->
  2,048) applied to a stored VGG-16 fc7 row instead of merged MoonViT
  patches;
- a fixed prompt of ids and BOS stand for the chat template;
- every product and sum is float32 (the published code runs bf16); the
  cell's check feeds it the weights as the program holds them, each
  matrix but the router's rounded through bf16
  (``portbench/moe_inputs.py``), so that only the arithmetic differs;
- the router's selection bias is drawn, not trained.

Parameters are read by key through ``get(key)`` (a function, or a
mapping's ``__getitem__``), float32, matrices ``(in, out)``
(``param_shapes``), one layer at a time: a caller may make each layer's
weights on the device when it is needed, so a model larger than the
card's memory in float32 is computed layer by layer.  Every function
takes an optional ``quant``, applied to both operands of every weight
product but the router's (which the published code runs in float32):
the lower-precision control (``precision.py``).

- ``hidden``: the final normed hidden state of every position;
- ``scored``: for given paths, teacher-forced, each token's
  log-probability, and the ``k``-th best at its position;
- ``beam_search``: the port's beam search semantics (the LRCN reference's:
  log-space scores, the first step expanding hypothesis 0, each
  hypothesis's best K words then the best K of the K*K, the lower index
  first among ties, a row done when its best hypothesis ends in EOS),
  each step a whole forward over every hypothesis's sequence.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import cast, product

EOS, BOS = 0, 1
NEG_INF = -1e30
KV_NORM_EPS = 1e-6
PROJECTOR_EPS = 1e-5
# the gap, in sigmoid score, between a token's 6th and 7th experts (by
# score plus bias) below which ``hidden`` counts a routing near-tie
NEAR_TIE = 1e-3


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's key and shape: matrices ``(in, out)``, a dense
    layer's and the shared MLP's ``gate_up`` ``[gate | up]`` along out,
    the routed experts ``(E, in, out)``."""
    d, c, p = cfg["hidden_size"], cfg["cnn_feature_dim"], cfg["projector_dim"]
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    e, f, s = (cfg["n_routed_experts"], cfg["moe_intermediate_size"],
               cfg["n_shared_experts"])
    shapes = {"projector/norm_w": (c,), "projector/norm_b": (c,),
              "projector/w1": (c, p), "projector/b1": (p,),
              "projector/w2": (p, d), "projector/b2": (d,),
              "embedding": (cfg["vocab_size"], d)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers/{i}/"
        shapes.update({pre + "attn_norm": (d,),
                       pre + "q": (d, h * (nope + rope)),
                       pre + "kv_a": (d, r + rope), pre + "kv_norm": (r,),
                       pre + "kv_b": (r, h * (nope + vd)),
                       pre + "o": (h * vd, d), pre + "mlp_norm": (d,)})
        if i < cfg["first_k_dense_replace"]:
            shapes.update({pre + "gate_up": (d, 2 * cfg["intermediate_size"]),
                           pre + "down": (cfg["intermediate_size"], d)})
        else:
            shapes.update({pre + "router": (d, e), pre + "router_bias": (e,),
                           pre + "experts/gate_up": (e, d, 2 * f),
                           pre + "experts/down": (e, f, d),
                           pre + "shared/gate_up": (d, 2 * s * f),
                           pre + "shared/down": (s * f, d)})
    shapes.update({"final_norm": (d,), "head": (d, cfg["vocab_size"])})
    return shapes


def _getter(params):
    return params if callable(params) else params.__getitem__


def mm(a: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    return product(cast(a, quant) @ cast(w, quant), quant)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, d) at positions 0..S-1."""
    s, d = x.shape[-2:]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    return x * cos + half * sin


def swiglu(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor,
           quant=None) -> torch.Tensor:
    g, u = mm(x, gate_up, quant).chunk(2, dim=-1)
    return mm(F.silu(g) * u, down, quant)


def attention(get, cfg: dict, i: int, x: torch.Tensor, quant=None
              ) -> torch.Tensor:
    """Layer ``i``'s causal MLA over normed ``x`` (N, S, D)."""
    n, s, _ = x.shape
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, vd = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    pre = f"layers/{i}/"
    q = mm(x, get(pre + "q"), quant).view(n, s, h, -1).transpose(1, 2)
    kv = mm(x, get(pre + "kv_a"), quant)
    c = rms_norm(kv[..., :r], get(pre + "kv_norm"), KV_NORM_EPS)
    k_pe = rope(kv[..., r:], cfg["rope_theta"])[:, None].expand(n, h, s, -1)
    kvb = mm(c, get(pre + "kv_b"), quant).view(n, s, h, -1).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg["rope_theta"])], -1)
    k = torch.cat([kvb[..., :nope], k_pe], -1)
    scores = mm(q, k.transpose(-1, -2), quant) / math.sqrt(q.shape[-1])
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = scores.masked_fill(~causal, float("-inf")).softmax(-1)
    o = mm(probs, kvb[..., nope:], quant).transpose(1, 2).reshape(n, s, h * vd)
    return mm(o, get(pre + "o"), quant)


def moe(get, cfg: dict, i: int, x: torch.Tensor, quant=None,
        ties: list | None = None) -> torch.Tensor:
    """Layer ``i``'s routed and shared experts over normed tokens (T, D);
    appends (near-ties, tokens) to ``ties``."""
    pre = f"layers/{i}/"
    k, e = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    s = torch.sigmoid(x @ get(pre + "router"))
    choice = s + get(pre + "router_bias")
    ranked = choice.topk(min(k + 1, e), dim=-1).values
    if ties is not None and e > k:
        ties.append((int((ranked[:, k - 1] - ranked[:, k] < NEAR_TIE).sum()),
                     x.shape[0]))
    idx = choice.topk(k, dim=-1).indices
    w = s.gather(1, idx)
    if cfg["norm_topk_prob"] and k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    gate_up, down = get(pre + "experts/gate_up"), get(pre + "experts/down")
    out = swiglu(x, get(pre + "shared/gate_up"), get(pre + "shared/down"),
                 quant)
    for expert in range(e):
        rows, slot = torch.nonzero(idx == expert, as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], gate_up[expert], down[expert], quant)
            out = out.index_add(0, rows, y * w[rows, slot][:, None])
    return out


def prefix(get, cfg: dict, feats: torch.Tensor, quant=None) -> torch.Tensor:
    """The image position and the prompt's (N, 1 + P, D)."""
    z = F.layer_norm(feats, (feats.shape[-1],), get("projector/norm_w"),
                     get("projector/norm_b"), PROJECTOR_EPS)
    z = F.gelu(mm(z, get("projector/w1"), quant) + get("projector/b1"))
    image = mm(z, get("projector/w2"), quant) + get("projector/b2")
    prompt = get("embedding")[torch.as_tensor(cfg["prompt_ids"],
                                              device=feats.device)]
    return torch.cat([image[:, None],
                      prompt[None].expand(feats.shape[0], -1, -1)], 1)


@torch.no_grad()
def hidden(params, cfg: dict, feats: torch.Tensor, tokens: torch.Tensor,
           quant=None, ties: list | None = None) -> torch.Tensor:
    """fc7 rows (N, C) and the tokens after the prefix (N, L): BOS, then
    words -> the final normed hidden state at those L positions
    (N, L, D)."""
    get = _getter(params)
    x = torch.cat([prefix(get, cfg, feats, quant),
                   get("embedding")[tokens]], 1)
    n, s, d = x.shape
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers/{i}/"
        x = x + attention(get, cfg, i, rms_norm(x, get(pre + "attn_norm"),
                                                eps), quant)
        h = rms_norm(x, get(pre + "mlp_norm"), eps).reshape(n * s, d)
        if i < cfg["first_k_dense_replace"]:
            y = swiglu(h, get(pre + "gate_up"), get(pre + "down"), quant)
        else:
            y = moe(get, cfg, i, h, quant, ties)
        x = x + y.view(n, s, d)
    return rms_norm(x[:, -tokens.shape[1]:], get("final_norm"), eps)


def log_probs(params, x: torch.Tensor, quant=None) -> torch.Tensor:
    """Normed hidden states (R, D) -> log-softmax over the vocabulary."""
    return torch.log_softmax(mm(x, _getter(params)("head"), quant), -1)


@torch.no_grad()
def scored(params, cfg: dict, feats: torch.Tensor,
           captions: list[list[int]], max_words: int, k: int, quant=None,
           chunk: int = 1024, ties: list | None = None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced on each caption's own words (the tokens a search
    scored: its words, then EOS where it has fewer than ``max_words +
    1``): (each token's log-probability (N, max_words + 1), the ``k``-th
    best log-probability at its position, the mask of tokens scored)."""
    n, device = feats.shape[0], feats.device
    steps = max_words + 1
    targets = np.full((n, steps), EOS, dtype=np.int64)
    mask = np.zeros((n, steps), dtype=bool)
    for r, words in enumerate(captions):
        targets[r, :len(words)] = words
        mask[r, :min(len(words) + 1, steps)] = True
    targets = torch.from_numpy(targets).to(device)
    inputs = torch.cat([torch.full((n, 1), BOS, device=device,
                                   dtype=torch.long), targets[:, :-1]], 1)
    x = hidden(params, cfg, feats, inputs, quant, ties).reshape(n * steps, -1)
    flat = targets.reshape(-1)
    token_lp = torch.empty(n * steps, device=device)
    kth = torch.empty(n * steps, device=device)
    for start in range(0, n * steps, chunk):
        lp = log_probs(params, x[start:start + chunk], quant)
        token_lp[start:start + chunk] = lp.gather(
            1, flat[start:start + chunk, None])[:, 0]
        kth[start:start + chunk] = lp.topk(k, dim=-1).values[:, -1]
    return (token_lp.view(n, steps), kth.view(n, steps),
            torch.from_numpy(mask).to(device))


@torch.no_grad()
def beam_search(params, cfg: dict, feats: torch.Tensor, beam: int,
                max_words: int, quant=None
                ) -> tuple[list[list[int]], torch.Tensor]:
    """feats (B, C) -> (the best path of each row as ids, its final EOS
    left out (``path_words``); its score (B,)).  Each step runs
    ``hidden`` over every hypothesis's whole sequence."""
    n, k, device = feats.shape[0], beam, feats.device
    rep = feats.repeat_interleave(k, dim=0)
    scores = torch.full((n, k), NEG_INF, device=device)
    scores[:, 0] = 0.0
    done = torch.zeros(n, dtype=torch.bool, device=device)
    paths = torch.zeros((n, k, 0), dtype=torch.long, device=device)
    for _ in range(max_words + 1):
        seqs = torch.cat([torch.full((n * k, 1), BOS, dtype=torch.long,
                                     device=device),
                          paths.reshape(n * k, -1)], 1)
        x = hidden(params, cfg, rep, seqs, quant)[:, -1]
        logp = log_probs(params, x, quant)
        top_lp, top_w = torch.sort(logp, dim=-1, descending=True,
                                   stable=True)
        top_lp, top_w = top_lp[:, :k].reshape(n, k, k), top_w[:, :k]
        flat = (scores[:, :, None] + top_lp).view(n, k * k)
        sel = torch.sort(flat, dim=-1, descending=True, stable=True)[1][:, :k]
        parent = sel // k
        new_scores = torch.gather(flat, 1, sel)
        word = torch.gather(top_w.reshape(n, k * k), 1, sel)
        keep = done[:, None]
        parent = torch.where(keep, torch.arange(k, device=device), parent)
        word = torch.where(keep, torch.full_like(word, EOS), word)
        scores = torch.where(keep, scores, new_scores)
        paths = torch.cat([torch.gather(
            paths, 1, parent[:, :, None].expand(-1, -1, paths.shape[2])),
            word[:, :, None]], dim=2)
        done = done | (word[:, 0] == EOS)
    return [path_words(path) for path in paths[:, 0].tolist()], scores[:, 0]


def path_words(path: list[int]) -> list[int]:
    """A search's best path (its tokens after BOS, EOS filler after the
    row ended) -> the tokens its score covers, without the EOS that ended
    it: everything up to its last word.  A hypothesis that emitted EOS
    and went on extending keeps that EOS inside its path, and its score
    covers the words after it, which a caption line leaves out."""
    last = max((i for i, t in enumerate(path) if t != EOS), default=-1)
    return path[:last + 1]
