"""A DeepSeek-V3-style text model as a caption decoder: latent attention
(MLA) and routed experts, at Kimi-VL-A3B's published widths by default
(``config.py:MoETextConfig``).  This package's own decoder: the JAX
package has no counterpart.

The equations, per layer (pre-norm RMSNorm before each sublayer, the
residual stream in float32):

- **MLA.**  ``q = W_q x`` gives H heads of (nope, rope) dims;
  ``[c; k_pe] = W_kva x`` gives the latent ``c`` (``kv_lora_rank``),
  RMS-normed, and one rope key shared by all heads; ``[k_nope; v] =
  W_kvb c`` per head.  RoPE (the published code's pairing: dims ``2i``
  and ``2i + 1`` turn by ``theta^(-2i/d)``) applies to ``q_pe`` and
  ``k_pe``; scores are scaled by ``1/sqrt(nope + rope)``; ``W_o`` maps
  the heads back.  The cache holds ``[c; k_pe]`` a position
  (``kv_lora_rank + qk_rope_head_dim`` values).  ``prefill`` runs the
  expanded form over the prefix; ``decode_step`` the absorbed one:
  ``W_kvb``'s key half is folded into the query (``q_c = q_nope W_uk^T``,
  scores ``q_c . c + q_pe . k_pe``) and its value half into the output
  (``(p . c) W_uv``), so a step reads the latent cache and never expands
  it.
- **Experts** (layers from ``first_k_dense_replace`` on).  The router's
  logits, sigmoid ``s``, selection and weights are float32: the top
  ``num_experts_per_tok`` of ``s + bias`` are chosen, and weighted by
  ``s`` there, divided by their sum (``norm_topk_prob``) and times
  ``routed_scaling_factor``; the bias picks, it never weights.  The
  output is ``sum_i w_i E_i(x) + S(x)``, each expert a SwiGLU
  ``W_down(silu(W_gate x) * W_up x)``.  The shared MLP ``S`` (width
  ``n_shared_experts`` x the expert width) is the sum of its
  ``n_shared_experts`` slices, each an expert of the routed width with
  weight 1, so routed and shared products are one grouped product over
  ``n_routed + n_shared`` groups (:func:`experts`): the assignments are
  sorted by expert on the device and the group offsets are a device
  cumsum, so nothing waits for the host and a search stays one captured
  graph.  The first layers are dense SwiGLU of ``intermediate_size``.

Numerics: weights in the compute dtype (bf16 on a card) with float32
sums (``ops/lstm.py:matmul``; batched products ``_bmm``); norms,
softmax, rope, the router and the residual stream in float32; the
latent cache in the compute dtype.  On a CUDA tensor in bf16 the grouped
product is ``torch._grouped_mm`` (bf16 out); elsewhere its plain version,
a product a group (``_grouped_mm_plain``), which reads the offsets on the
host.

The image enters as position 0: ``projector`` (LayerNorm, W1 + b1, GELU,
W2 + b2, as Kimi-VL's projector) of its fc7 row; ``prompt_ids`` follow,
then BOS and the caption's words (``MoETextConfig``).

A per-layer, per-expert token counter (``expert_tokens``, with
``expert_active`` and ``expert_busiest`` beside it) is added to inside
every expert layer on the device, with no sync;
:func:`reset_expert_counts` zeroes it and :func:`expert_counts` reads
it.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from lrcn_tpu_torch.config import MoETextConfig
from lrcn_tpu_torch.ops.lstm import matmul

KV_NORM_EPS = 1e-6   # the published code's default for the latent norm
PROJECTOR_EPS = 1e-5
# the expert counter's buffers (per expert layer; tokens also per expert)
COUNTERS = ("expert_tokens", "expert_active", "expert_busiest")


def param_shapes(cfg: MoETextConfig) -> dict[str, tuple[int, ...]]:
    """The decoder's parameters under their checkpoint keys, matrices as
    ``(in, out)``; a dense layer's ``gate_up`` and the shared MLP's are
    ``[gate | up]`` along ``out``, an expert's ``(E, in, out)``."""
    d, c, p = cfg.hidden_size, cfg.cnn_feature_dim, cfg.projector_dim
    h, r = cfg.num_attention_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    e, f, s = (cfg.n_routed_experts, cfg.moe_intermediate_size,
               cfg.n_shared_experts)
    shapes = {"projector/norm_w": (c,), "projector/norm_b": (c,),
              "projector/w1": (c, p), "projector/b1": (p,),
              "projector/w2": (p, d), "projector/b2": (d,),
              "embedding": (cfg.vocab_size, d)}
    for i in range(cfg.num_hidden_layers):
        pre = f"layers/{i}/"
        shapes.update({pre + "attn_norm": (d,),
                       pre + "q": (d, h * (nope + rope)),
                       pre + "kv_a": (d, r + rope), pre + "kv_norm": (r,),
                       pre + "kv_b": (r, h * (nope + vd)),
                       pre + "o": (h * vd, d), pre + "mlp_norm": (d,)})
        if i < cfg.first_k_dense_replace:
            shapes.update({pre + "gate_up": (d, 2 * cfg.intermediate_size),
                           pre + "down": (cfg.intermediate_size, d)})
        else:
            shapes.update({pre + "router": (d, e), pre + "router_bias": (e,),
                           pre + "experts/gate_up": (e, d, 2 * f),
                           pre + "experts/down": (e, f, d),
                           pre + "shared/gate_up": (d, 2 * s * f),
                           pre + "shared/down": (s * f, d)})
    shapes.update({"final_norm": (d,), "head": (d, cfg.vocab_size)})
    return shapes


def init_params(cfg: MoETextConfig, generator: torch.Generator, *,
                std: float = 0.02) -> dict[str, torch.Tensor]:
    """Float32 parameters on the generator's device: matrices
    ``N(0, std^2)``, norm weights 1, biases and the router's bias 0.
    Drawn key by key in ``param_shapes`` order (a small model's: the
    whole tree is held at once)."""
    device = generator.device
    out = {}
    for key, shape in param_shapes(cfg).items():
        if len(shape) >= 2:
            out[key] = torch.empty(shape, device=device).normal_(
                0.0, std, generator=generator)
        elif key.endswith(("norm", "norm_w")):
            out[key] = torch.ones(shape, device=device)
        else:
            out[key] = torch.zeros(shape, device=device)
    return out


def _name(key: str) -> str:
    return key.replace("/", "_")


class MoETextDecoder(nn.Module):
    """The decoder's weights on one device, ready for ``prefill`` and
    ``decode_step``; buffers, as decoding computes no gradient.

    ``params``: a mapping from checkpoint key to a float32 tensor, or a
    function of the key that returns one (a model too large to hold in
    float32 at once is made, cast and dropped a tensor at a time).
    Matrices are kept in ``compute_dtype``; norms, biases and the router
    in float32.  Each expert layer's routed and shared weights are
    stacked into one grouped weight per product, ``(E + S, out, in)``.
    """

    def __init__(self, cfg: MoETextConfig,
                 params: Mapping[str, torch.Tensor] | Callable[
                     [str], torch.Tensor],
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, "
                             f"got {compute_dtype}")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        get = _checked(params if callable(params) else params.__getitem__,
                       param_shapes(cfg))
        for key, shape in param_shapes(cfg).items():
            if "/experts/" in key or "/shared/" in key:
                continue
            keep_f32 = len(shape) == 1 or key.endswith("/router")
            self.register_buffer(_name(key), get(key).to(
                torch.float32 if keep_f32 else compute_dtype).contiguous())
        for i in range(cfg.first_k_dense_replace, cfg.num_hidden_layers):
            gate_up, down = _stacked_experts(cfg, i, get, compute_dtype)
            self.register_buffer(_name(f"layers/{i}/experts_gate_up"),
                                 gate_up)
            self.register_buffer(_name(f"layers/{i}/experts_down"), down)
        for i in range(cfg.num_hidden_layers):
            w_uk, w_uv = _absorbed(cfg, self[f"layers/{i}/kv_b"])
            self.register_buffer(_name(f"layers/{i}/w_uk"), w_uk)
            self.register_buffer(_name(f"layers/{i}/w_uv"), w_uv)
        n_moe, n_exp = cfg.moe_layers, cfg.n_routed_experts
        device = self.embedding.device
        # on the device, so that a captured search copies nothing in
        self.register_buffer("prompt", torch.tensor(
            cfg.prompt_ids, dtype=torch.int64, device=device),
            persistent=False)
        for name in COUNTERS:
            self.register_buffer(name, torch.zeros(
                (n_moe, n_exp) if name == "expert_tokens" else (n_moe,),
                dtype=torch.int64, device=device), persistent=False)

    def __getitem__(self, key: str) -> torch.Tensor:
        return getattr(self, _name(key))

    @property
    def device(self) -> torch.device:
        return self.embedding.device


def _checked(get: Callable[[str], torch.Tensor],
             shapes: dict[str, tuple[int, ...]]
             ) -> Callable[[str], torch.Tensor]:
    """``get`` that raises where a parameter's shape is not ``shapes``'."""
    def checked(key: str) -> torch.Tensor:
        value = get(key)
        if tuple(value.shape) != shapes[key]:
            raise ValueError(f"{key}: shape {tuple(value.shape)}, expected "
                             f"{shapes[key]}")
        return value
    return checked


def _stacked_experts(cfg: MoETextConfig, i: int, get,
                     dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Layer ``i``'s grouped weights: gate_up ``(E + S, 2F, D)`` and down
    ``(E + S, D, F)``, the routed experts first, then the shared MLP's S
    slices of width F (its ``[gate | up]`` columns split alike)."""
    pre = f"layers/{i}/"
    f, s = cfg.moe_intermediate_size, cfg.n_shared_experts
    # each float32 draw is dropped once cast: one layer's at a time
    parts_gu = [get(pre + "experts/gate_up").transpose(1, 2).to(dtype)]
    parts_down = [get(pre + "experts/down").transpose(1, 2).to(dtype)]
    shared_gu, shared_down = get(pre + "shared/gate_up"), get(
        pre + "shared/down")
    gate, up = shared_gu[:, :s * f], shared_gu[:, s * f:]
    for j in range(s):
        cols = slice(j * f, (j + 1) * f)
        parts_gu.append(torch.cat([gate[:, cols], up[:, cols]], dim=1)
                        .t()[None].to(dtype))
        parts_down.append(shared_down[cols].t()[None].to(dtype))
    return (torch.cat(parts_gu).contiguous(),
            torch.cat(parts_down).contiguous())


def _absorbed(cfg: MoETextConfig, kv_b: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``W_kvb``'s key half as ``(H, nope, R)`` and value half as
    ``(H, R, v)``, for the absorbed decode."""
    h, nope = cfg.num_attention_heads, cfg.qk_nope_head_dim
    per_head = kv_b.view(cfg.kv_lora_rank, h, nope + cfg.v_head_dim)
    w_uk = per_head[..., :nope].permute(1, 2, 0).contiguous()
    w_uv = per_head[..., nope:].permute(1, 0, 2).contiguous()
    return w_uk, w_uv


# --- the expert counter ---


def reset_expert_counts(decoder: MoETextDecoder) -> None:
    for name in COUNTERS:
        getattr(decoder, name).zero_()


def expert_counts(decoder: MoETextDecoder) -> dict:
    """The counter on the host: per expert layer, the tokens each expert
    took (``tokens``, a list per layer), and summed over calls the experts
    that took at least one token (``active``) and the tokens of each
    call's busiest expert (``busiest``).  A layer's rows (tokens before
    routing) are its tokens over ``num_experts_per_tok``."""
    return {"tokens": decoder.expert_tokens.tolist(),
            "active": decoder.expert_active.tolist(),
            "busiest": decoder.expert_busiest.tolist()}


# --- pieces ---


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE of ``x`` (..., P, d) at positions ``pos`` (P,), float32: the
    published code's layout, ``[x_even, x_odd]`` rotated as halves."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None, :]             # (P, d/2)
    cos, sin = ang.cos(), ang.sin()
    x = x.float()
    even, odd = x[..., 0::2], x[..., 1::2]
    return torch.cat([even * cos - odd * sin, odd * cos + even * sin], -1)


def _bmm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype
         ) -> torch.Tensor:
    """Batched ``a @ b``, operands in ``dtype``, float32 out."""
    a, b = a.to(dtype), b.to(dtype)
    if dtype == torch.float32 or not a.is_cuda:
        return a.float() @ b.float()
    return torch.bmm(a, b, out_dtype=torch.float32)


def projector(dec: MoETextDecoder, feats: torch.Tensor) -> torch.Tensor:
    """fc7 rows (B, C) -> the image's prefix embedding (B, D), float32."""
    x = F.layer_norm(feats.float(), (feats.shape[-1],),
                     dec["projector/norm_w"], dec["projector/norm_b"],
                     PROJECTOR_EPS)
    x = F.gelu(matmul(x, dec["projector/w1"], dec.compute_dtype)
               + dec["projector/b1"])
    return matmul(x, dec["projector/w2"], dec.compute_dtype) + dec[
        "projector/b2"]


def embed(dec: MoETextDecoder, ids: torch.Tensor) -> torch.Tensor:
    return dec.embedding[ids].float()


def route(dec: MoETextDecoder, j: int, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert layer ``j``'s routing of normed tokens ``x`` (T, D), all in
    float32: (experts (T, k) int64, weights (T, k) float32)."""
    cfg = dec.cfg
    i = cfg.first_k_dense_replace + j
    s = torch.sigmoid(x.float() @ dec[f"layers/{i}/router"])
    _, idx = torch.topk(s + dec[f"layers/{i}/router_bias"],
                        cfg.num_experts_per_tok, dim=-1)
    w = s.gather(1, idx)
    if cfg.norm_topk_prob and cfg.num_experts_per_tok > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def _grouped_mm_plain(x: torch.Tensor, w: torch.Tensor,
                      offs: torch.Tensor) -> torch.Tensor:
    """The grouped product's plain version: ``x[rows of g] @ w[g]`` for
    each group g, float32 sums, out in ``x``'s dtype (offsets read on the
    host)."""
    out = torch.empty((x.shape[0], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = (x[start:end].float() @ w[g].float()).to(
                x.dtype)
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor
               ) -> torch.Tensor:
    """Rows ``x`` (M, K) sorted by group, weights ``w`` (G, K, N), group
    ends ``offs`` (G,) int32 on the device -> (M, N) in ``x``'s dtype."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=offs)
    return _grouped_mm_plain(x, w, offs)


def experts(dec: MoETextDecoder, j: int, x: torch.Tensor,
            idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert layer ``j``'s routed and shared expert outputs for normed
    tokens ``x`` (T, D) routed to ``idx`` (T, k): (routed (T, k, D),
    shared (T, S, D)), float32, through one grouped product over the
    E + S groups.  Counts the layer's tokens into the counter."""
    cfg = dec.cfg
    i = cfg.first_k_dense_replace + j
    t_dim, k = idx.shape
    e, s, f = (cfg.n_routed_experts, cfg.n_shared_experts,
               cfg.moe_intermediate_size)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    _count(dec, j, counts)
    shared_rows = torch.full((s,), t_dim, dtype=torch.int64,
                             device=x.device)
    offs = torch.cumsum(torch.cat([counts, shared_rows]), 0).to(torch.int32)
    xc = x.to(dec.compute_dtype)
    rows = torch.cat([xc[order // k]] + [xc] * s)              # (T(k+S), D)
    h = grouped_mm(rows, dec[f"layers/{i}/experts_gate_up"].transpose(1, 2),
                   offs)
    a = (F.silu(h[:, :f].float()) * h[:, f:].float()).to(dec.compute_dtype)
    y = grouped_mm(a, dec[f"layers/{i}/experts_down"].transpose(1, 2), offs)
    routed = torch.empty_like(y[:t_dim * k])
    routed[order] = y[:t_dim * k]
    return (routed.view(t_dim, k, -1).float(),
            y[t_dim * k:].view(s, t_dim, -1).transpose(0, 1).float())


def _count(dec: MoETextDecoder, j: int, counts: torch.Tensor) -> None:
    dec.expert_tokens[j] += counts
    dec.expert_active[j] += (counts > 0).sum()
    dec.expert_busiest[j] += counts.max()


def combine(routed: torch.Tensor, weights: torch.Tensor,
            shared: torch.Tensor) -> torch.Tensor:
    """``sum_i w_i E_i(x) + S(x)`` (T, D), float32, in a fixed order."""
    return (routed * weights[..., None]).sum(1) + shared.sum(1)


def moe(dec: MoETextDecoder, j: int, x: torch.Tensor) -> torch.Tensor:
    """Expert layer ``j`` on normed tokens ``x`` (T, D)."""
    idx, w = route(dec, j, x)
    routed, shared = experts(dec, j, x, idx)
    return combine(routed, w, shared)


def dense_mlp(dec: MoETextDecoder, i: int, x: torch.Tensor) -> torch.Tensor:
    h = matmul(x, dec[f"layers/{i}/gate_up"], dec.compute_dtype)
    g, u = h.chunk(2, dim=-1)
    return matmul(F.silu(g) * u, dec[f"layers/{i}/down"], dec.compute_dtype)


def mlp(dec: MoETextDecoder, i: int, x: torch.Tensor) -> torch.Tensor:
    """Layer ``i``'s feed-forward sublayer on normed tokens (T, D)."""
    first = dec.cfg.first_k_dense_replace
    return dense_mlp(dec, i, x) if i < first else moe(dec, i - first, x)


def latent(dec: MoETextDecoder, i: int, x: torch.Tensor,
           pos: torch.Tensor) -> torch.Tensor:
    """Normed tokens (N, P, D) at positions ``pos`` (P,) -> their cache
    entries ``[RMSNorm(c); rope(k_pe)]`` (N, P, R + rope) in the compute
    dtype."""
    cfg = dec.cfg
    n, p, d = x.shape
    kv = matmul(x.reshape(n * p, d), dec[f"layers/{i}/kv_a"],
                dec.compute_dtype).view(n, p, -1)
    c = rms_norm(kv[..., :cfg.kv_lora_rank], dec[f"layers/{i}/kv_norm"],
                 KV_NORM_EPS)
    k_pe = rope(kv[..., cfg.kv_lora_rank:], pos, cfg.rope_theta)
    return torch.cat([c, k_pe], -1).to(dec.compute_dtype)


def _queries(dec: MoETextDecoder, i: int, x: torch.Tensor,
             pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normed tokens (N, P, D) -> (q_nope (N, P, H, nope), roped q_pe
    (N, P, H, rope)), float32."""
    cfg = dec.cfg
    n, p, d = x.shape
    nope = cfg.qk_nope_head_dim
    q = matmul(x.reshape(n * p, d), dec[f"layers/{i}/q"],
               dec.compute_dtype).view(n, p, cfg.num_attention_heads, -1)
    q_pe = rope(q[..., nope:].transpose(1, 2), pos, cfg.rope_theta)
    return q[..., :nope], q_pe.transpose(1, 2)


def _scale(cfg: MoETextConfig) -> float:
    return 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def attention_expanded(dec: MoETextDecoder, i: int, x: torch.Tensor,
                       cache: torch.Tensor, pos: torch.Tensor
                       ) -> torch.Tensor:
    """Causal MLA of normed tokens ``x`` (N, P, D) over their own cache
    entries ``cache`` (N, P, R + rope), with ``W_kvb`` expanded into
    per-head keys and values: (N, P, D) float32."""
    cfg = dec.cfg
    n, p, _ = x.shape
    h, r, nope, vd = (cfg.num_attention_heads, cfg.kv_lora_rank,
                      cfg.qk_nope_head_dim, cfg.v_head_dim)
    dt = dec.compute_dtype
    q_nope, q_pe = _queries(dec, i, x, pos)
    kv = matmul(cache[..., :r].reshape(n * p, r), dec[f"layers/{i}/kv_b"],
                dt).view(n, p, h, nope + vd)
    k_pe = cache[..., r:].float()[:, :, None].expand(n, p, h, -1)
    q = torch.cat([q_nope, q_pe], -1).transpose(1, 2).reshape(n * h, p, -1)
    k = torch.cat([kv[..., :nope], k_pe], -1).transpose(1, 2).reshape(
        n * h, p, -1)
    v = kv[..., nope:].transpose(1, 2).reshape(n * h, p, vd)
    scores = _bmm(q, k.transpose(1, 2), dt) * _scale(cfg)
    causal = torch.ones(p, p, dtype=torch.bool, device=x.device).tril()
    probs = scores.masked_fill(~causal, float("-inf")).softmax(-1)
    o = _bmm(probs, v, dt).view(n, h, p, vd).transpose(1, 2)
    return matmul(o.reshape(n * p, h * vd), dec[f"layers/{i}/o"],
                  dt).view(n, p, -1)


def attention_absorbed(dec: MoETextDecoder, i: int, x: torch.Tensor,
                       prefix: torch.Tensor, cache: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """One decode position of normed tokens ``x`` (B*K, D) over the
    image's shared ``prefix`` entries (B, S0, R + rope) and each
    hypothesis's own ``cache`` entries (B*K, t, R + rope), the position's
    own included, with ``W_kvb`` absorbed: (B*K, D) float32."""
    cfg = dec.cfg
    bk, d = x.shape
    b_dim = prefix.shape[0]
    h, r, vd = cfg.num_attention_heads, cfg.kv_lora_rank, cfg.v_head_dim
    dt = dec.compute_dtype
    q_nope, q_pe = _queries(dec, i, x[:, None], pos)
    q_c = _bmm(q_nope[:, 0].transpose(0, 1), dec[f"layers/{i}/w_uk"], dt)
    q = torch.cat([q_c.transpose(0, 1), q_pe[:, 0]], -1).to(dt)  # (BK,H,L)
    s_pre = _bmm(q.reshape(b_dim, -1, q.shape[-1]), prefix.transpose(1, 2),
                 dt).view(bk, h, -1)
    s_own = _bmm(q, cache.transpose(1, 2), dt)
    scores = torch.cat([s_pre, s_own], -1) * _scale(cfg)
    probs = scores.softmax(-1)
    s0 = prefix.shape[1]
    o_c = (_bmm(probs[..., :s0].reshape(b_dim, -1, s0), prefix[..., :r],
                dt).view(bk, h, r)
           + _bmm(probs[..., s0:], cache[..., :r], dt))
    o = _bmm(o_c.transpose(0, 1), dec[f"layers/{i}/w_uv"], dt)  # (H,BK,v)
    return matmul(o.transpose(0, 1).reshape(bk, h * vd),
                  dec[f"layers/{i}/o"], dt)


def logits(dec: MoETextDecoder, x: torch.Tensor) -> torch.Tensor:
    """The residual stream (T, D) -> float32 vocabulary logits (T, V)."""
    eps = dec.cfg.rms_norm_eps
    return matmul(rms_norm(x, dec.final_norm, eps), dec.head,
                  dec.compute_dtype)


def prefill(dec: MoETextDecoder, feats: torch.Tensor) -> torch.Tensor:
    """The image-and-prompt prefix of each fc7 row (B, C): its cache
    entries, (layers, B, S0, R + rope) in the compute dtype."""
    cfg = dec.cfg
    b_dim = feats.shape[0]
    device = feats.device
    x = torch.cat([projector(dec, feats)[:, None],
                   embed(dec, dec.prompt)[None].expand(b_dim, -1, -1)], 1)
    s0 = x.shape[1]
    pos = torch.arange(s0, device=device)
    eps = cfg.rms_norm_eps
    caches = []
    for i in range(cfg.num_hidden_layers):
        h = rms_norm(x, dec[f"layers/{i}/attn_norm"], eps)
        cache = latent(dec, i, h, pos)
        caches.append(cache)
        x = x + attention_expanded(dec, i, h, cache, pos)
        h = rms_norm(x, dec[f"layers/{i}/mlp_norm"], eps)
        x = x + mlp(dec, i, h.view(b_dim * s0, -1)).view(b_dim, s0, -1)
    return torch.stack(caches)


def decode_step(dec: MoETextDecoder, prefix: torch.Tensor,
                cache: torch.Tensor, t: int, ids: torch.Tensor
                ) -> torch.Tensor:
    """Step ``t`` of a search: the hypotheses' input tokens ``ids``
    (B*K,) at position ``S0 + t`` -> their logits (B*K, V) float32.
    Writes the position's entries into ``cache[:, :, t]`` (layers, B*K,
    steps, R + rope) and reads ``prefix`` (layers, B, S0, R + rope)."""
    cfg = dec.cfg
    eps = cfg.rms_norm_eps
    pos = torch.full((1,), prefix.shape[2] + t, dtype=torch.int64,
                     device=ids.device)
    x = embed(dec, ids)
    for i in range(cfg.num_hidden_layers):
        h = rms_norm(x, dec[f"layers/{i}/attn_norm"], eps)
        cache[i, :, t] = latent(dec, i, h[:, None], pos)[:, 0]
        x = x + attention_absorbed(dec, i, h, prefix[i], cache[i, :, :t + 1],
                                   pos)
        x = x + mlp(dec, i, rms_norm(x, dec[f"layers/{i}/mlp_norm"], eps))
    return logits(dec, x)


def reorder_cache(cache: torch.Tensor, parent: torch.Tensor, t: int
                  ) -> None:
    """After step ``t``'s selection, each hypothesis takes its parent's
    entries ``0..t``: ``parent`` (B, K) indexes the beams of its row."""
    b_dim, k = parent.shape
    src = (parent + k * torch.arange(b_dim, device=parent.device)[:, None]
           ).reshape(-1)
    # a layer at a time: the copies stay small, and do not grow the
    # allocator's blocks step by step
    for layer in cache:
        layer[:, :t + 1] = layer[src, :t + 1]
