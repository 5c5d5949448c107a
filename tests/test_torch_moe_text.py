"""The MoE text decoder (``lrcn_tpu_torch/models/moe_text.py``) against
the plain float32 reference of the benchmark
(``portbench/reference/kimi_vl_text.py``), on seeded random weights at a
tiny size on the CPU: hidden 64, 8 routed experts, top 2, 1 shared, one
dense layer and two expert layers, 97 words.  The JAX package has no
counterpart of this decoder."""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
import torch
import torch.nn.functional as F

from lrcn_tpu_torch.config import MoETextConfig
from lrcn_tpu_torch.models import moe_text
from portbench.reference import kimi_vl_text as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
            num_experts_per_tok=2, kv_lora_rank=16, qk_rope_head_dim=8,
            qk_nope_head_dim=16, v_head_dim=16, first_k_dense_replace=1,
            cnn_feature_dim=24, projector_dim=32, prompt_ids=(5, 9, 11),
            compute_dtype="float32")


def tiny_params(cfg: MoETextConfig, seed: int = 1) -> dict:
    """Weights wide enough that routing and attention are far from
    uniform, and a router bias at the scores' spread."""
    g = torch.Generator().manual_seed(seed)
    p = moe_text.init_params(cfg, g, std=0.2)
    for key in p:
        if key.endswith("router_bias"):
            p[key] = torch.randn(p[key].shape, generator=g) * 0.3
        elif p[key].dim() == 1:
            p[key] = p[key] + 0.1 * torch.randn(p[key].shape, generator=g)
    return p


@pytest.fixture(scope="module")
def tiny():
    cfg = MoETextConfig(**TINY)
    params = tiny_params(cfg)
    return cfg, params, moe_text.MoETextDecoder(cfg, params, torch.float32)


def _feats(n: int, seed: int = 2) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, TINY["cnn_feature_dim"]), generator=g)
    return x / x.sum(1, keepdim=True)


def test_layout_matches_the_reference():
    for cfg in (MoETextConfig(**TINY), MoETextConfig()):
        assert moe_text.param_shapes(cfg) == ref.param_shapes(
            dataclasses.asdict(cfg))


def test_the_benchmark_config_is_the_published_one():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "kimi-vl-a3b-text-coco-fc7.json")) as f:
        values = json.load(f)
    cfg = MoETextConfig.from_dict(values)
    assert (cfg.num_hidden_layers, cfg.n_routed_experts,
            cfg.num_experts_per_tok, cfg.vocab_size) == (27, 64, 6, 163840)
    assert len(cfg.prompt_ids) == 16 and cfg.prefix_len == 17
    assert cfg.moe_layers == 26
    for key, value in (("q_lora_rank", 1536), ("n_group", 8),
                       ("scoring_func", "softmax")):
        with pytest.raises(ValueError, match=key):
            MoETextConfig.from_dict({**values, key: value})


def test_prefill_and_cached_decode_equal_the_reference_forward(tiny):
    """The prefix prefilled once, then each position decoded through the
    latent cache: logits equal the reference's whole-sequence forward."""
    cfg, params, dec = tiny
    feats = _feats(3)
    tokens = torch.tensor([[1, 7, 8, 9, 10, 11], [1, 20, 30, 40, 50, 60],
                           [1, 3, 3, 3, 3, 3]])
    with torch.no_grad():
        want = ref.log_probs(params, ref.hidden(
            params, dataclasses.asdict(cfg), feats, tokens).reshape(
                -1, cfg.hidden_size)).view(3, 6, -1)
        prefix = moe_text.prefill(dec, feats)
        cache = torch.zeros(cfg.num_hidden_layers, 3, 6,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        got = torch.stack([torch.log_softmax(moe_text.decode_step(
            dec, prefix, cache, t, tokens[:, t]), -1) for t in range(6)], 1)
    assert prefix.shape == (cfg.num_hidden_layers, 3, cfg.prefix_len,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_absorbed_decode_equals_the_expanded_form(tiny):
    """One layer's attention at the last position: W_kvb folded into the
    query and the output over a prefix and a cache of its own, against
    the expanded per-head keys and values over the whole sequence."""
    cfg, _, dec = tiny
    g = torch.Generator().manual_seed(3)
    n, s, s0 = 4, 9, 5
    x = torch.randn((n, s, cfg.hidden_size), generator=g)
    pos = torch.arange(s)
    with torch.no_grad():
        for i in range(cfg.num_hidden_layers):
            entries = moe_text.latent(dec, i, x, pos)
            full = moe_text.attention_expanded(dec, i, x, entries, pos)
            # rows 0, 1 share one image's prefix, 2, 3 another's (K = 2)
            prefix = entries[::2, :s0]
            own = entries[:, s0:]
            last = moe_text.attention_absorbed(dec, i, x[:, -1], prefix, own,
                                               pos[-1:])
            torch.testing.assert_close(last[::2], full[::2, -1], rtol=0,
                                       atol=1e-5)


def _expert(x, gate_up, down):
    g, u = (x @ gate_up).chunk(2, -1)
    return (F.silu(g) * u) @ down


def test_grouped_experts_equal_a_per_token_loop(tiny):
    cfg, params, dec = tiny
    g = torch.Generator().manual_seed(4)
    x = torch.randn((37, cfg.hidden_size), generator=g)
    for j in range(cfg.moe_layers):
        i = cfg.first_k_dense_replace + j
        pre = f"layers/{i}/"
        with torch.no_grad():
            got = moe_text.moe(dec, j, x)
            idx, w = moe_text.route(dec, j, x)
        want = []
        for t in range(x.shape[0]):
            y = _expert(x[t], params[pre + "shared/gate_up"],
                        params[pre + "shared/down"])
            for e, wt in zip(idx[t].tolist(), w[t]):
                y = y + wt * _expert(x[t], params[pre + "experts/gate_up"][e],
                                     params[pre + "experts/down"][e])
            want.append(y)
        torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=1e-5)


def test_grouped_product_plain_version_takes_empty_groups():
    g = torch.Generator().manual_seed(5)
    x = torch.randn((10, 6), generator=g)
    w = torch.randn((4, 6, 3), generator=g)
    offs = torch.tensor([3, 3, 9, 10], dtype=torch.int32)
    got = moe_text.grouped_mm(x, w, offs)
    want = torch.cat([x[:3] @ w[0], x[3:9] @ w[2], x[9:] @ w[3]])
    torch.testing.assert_close(got, want)


def test_the_router_bias_picks_and_never_weights(tiny):
    """The experts are the top k of ``s + bias``; their weights are ``s``
    there over its sum (``norm_topk_prob``) times the scaling factor."""
    cfg, params, dec = tiny
    g = torch.Generator().manual_seed(6)
    x = torch.randn((64, cfg.hidden_size), generator=g)
    i = cfg.first_k_dense_replace
    s = torch.sigmoid(x @ params[f"layers/{i}/router"])
    bias = params[f"layers/{i}/router_bias"]
    idx, w = moe_text.route(dec, 0, x)
    assert torch.equal(idx, (s + bias).topk(cfg.num_experts_per_tok).indices)
    assert not torch.equal(idx, s.topk(cfg.num_experts_per_tok).indices)
    picked = s.gather(1, idx)
    torch.testing.assert_close(
        w, picked / picked.sum(-1, keepdim=True) * cfg.routed_scaling_factor)
    torch.testing.assert_close(w.sum(-1), torch.full(
        (64,), cfg.routed_scaling_factor))


def test_the_expert_counter_counts_every_routed_token(tiny):
    cfg, _, dec = tiny
    moe_text.reset_expert_counts(dec)
    x = torch.randn((50, cfg.hidden_size))
    with torch.no_grad():
        idx, _ = moe_text.route(dec, 1, x)
        moe_text.moe(dec, 1, x)
    counts = moe_text.expert_counts(dec)
    want = torch.bincount(idx.reshape(-1), minlength=cfg.n_routed_experts)
    assert counts["tokens"][1] == want.tolist() and counts["tokens"][0] == [
        0] * cfg.n_routed_experts
    assert sum(counts["tokens"][1]) == 50 * cfg.num_experts_per_tok
    assert counts["active"] == [0, int((want > 0).sum())]
    assert counts["busiest"] == [0, int(want.max())]
    with torch.no_grad():
        moe_text.moe(dec, 1, x[:20])
    again = moe_text.expert_counts(dec)
    assert again["busiest"][1] == int(want.max()) + int(torch.bincount(
        idx[:20].reshape(-1), minlength=cfg.n_routed_experts).max())
    moe_text.reset_expert_counts(dec)
    assert moe_text.expert_counts(dec) == {
        "tokens": [[0] * cfg.n_routed_experts] * 2, "active": [0, 0],
        "busiest": [0, 0]}


def test_cache_reorder_takes_each_parents_entries():
    cache = torch.arange(2 * 6 * 4 * 1, dtype=torch.float32).view(2, 6, 4, 1)
    before = cache.clone()
    parent = torch.tensor([[2, 2, 0], [1, 0, 0]])      # B = 2, K = 3
    moe_text.reorder_cache(cache, parent, 1)
    src = [2, 2, 0, 4, 3, 3]
    assert torch.equal(cache[:, :, :2], before[:, src, :2])
    assert torch.equal(cache[:, :, 2:], before[:, :, 2:])
