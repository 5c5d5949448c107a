"""The MoE text decoder's model operations (``models/moe_text.py``), 2
per multiply-add.

A position's products: the query (D x H(nope + rope)), the latent and
rope key (D x (R + rope)), the output (H v x D); an expert layer's
router (D x E) and its ``k`` routed and ``S`` shared SwiGLU slices
(3 D F each), a dense layer's SwiGLU (3 D I).  Attention over ``ctx``
positions: a prefix position in the expanded form (keys and values
from the latent, R x H(nope + v), then H x ctx x (nope + rope + v));
a decoded position in the absorbed one (per head nope x R into the
latent and R x v out, H x ctx x (2R + rope) over the cache).  A decoded
position also takes the head (D x V).  The image's projector (C x P +
P x D) once an image.
"""

from __future__ import annotations


def _layers_macs(cfg: dict) -> int:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    r, nope, rope, v = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
                        cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    dense = cfg["first_k_dense_replace"]
    moe = cfg["num_hidden_layers"] - dense
    attn = d * h * (nope + rope) + d * (r + rope) + h * v * d
    per_expert = 3 * d * cfg["moe_intermediate_size"]
    return (cfg["num_hidden_layers"] * attn
            + dense * 3 * d * cfg["intermediate_size"]
            + moe * (d * cfg["n_routed_experts"]
                     + (cfg["num_experts_per_tok"]
                        + cfg["n_shared_experts"]) * per_expert))


def prefill_macs(cfg: dict) -> int:
    """Multiply-adds of one image's prefix: the projector and its
    ``1 + len(prompt_ids)`` positions, each attending to those before."""
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    s0 = 1 + len(cfg["prompt_ids"])
    layers = cfg["num_hidden_layers"]
    attn_ctx = sum(range(1, s0 + 1)) * h * (nope + rope + v)
    return (cfg["cnn_feature_dim"] * cfg["projector_dim"]
            + cfg["projector_dim"] * cfg["hidden_size"]
            + s0 * _layers_macs(cfg)
            + layers * (s0 * r * h * (nope + v) + attn_ctx))


def decode_macs(cfg: dict, t: int) -> int:
    """Multiply-adds of one hypothesis's search step ``t`` (0-based):
    its position attends to the prefix and to the ``t + 1`` decoded
    positions, its own included."""
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, v = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    ctx = 1 + len(cfg["prompt_ids"]) + t + 1
    absorbed = h * (nope * r + r * v) + h * ctx * (2 * r + rope)
    return (_layers_macs(cfg) + cfg["num_hidden_layers"] * absorbed
            + cfg["hidden_size"] * cfg["vocab_size"])


def caption_flops(cfg: dict, captions: int, rows_by_step: list[int]
                  ) -> int:
    """Model operations of ``captions`` captions of one pass whose search
    needs ``rows_by_step[t]`` hypotheses at step t: each image's prefix,
    and each needed hypothesis's step."""
    return 2 * (captions * prefill_macs(cfg)
                + sum(rows * decode_macs(cfg, t)
                      for t, rows in enumerate(rows_by_step)))
