"""The MoE text decoder's pieces on the CUDA card: the top-k kernel at
the decoder's search shape (3,072 hypotheses over 163,840 words, k = 3),
the grouped expert product against its plain version at an expert
layer's shapes, and a tiny decoder's search captured and replayed
against its eager search and, in float32, against the plain reference.

Needs the card and skips without one.  This file imports nothing of
JAX, so the card's machine runs it without ``tests/conftest.py``:

    python -m pytest --noconftest -m card tests/test_torch_moe_card.py
"""

import dataclasses

import pytest
import torch

from lrcn_tpu_torch.config import MoETextConfig
from lrcn_tpu_torch.decode import beam
from lrcn_tpu_torch.models import moe_text
from lrcn_tpu_torch.ops.kernels import (topk_logsumexp,
                                        topk_logsumexp_reference)
from lrcn_tpu_torch.ops.kernels.topk_lse import topk_lse_route
from portbench.reference import kimi_vl_text as ref
from portbench.reference.precision import strict_float32

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
            num_experts_per_tok=2, kv_lora_rank=16, qk_rope_head_dim=8,
            qk_nope_head_dim=16, v_head_dim=16, cnn_feature_dim=24,
            projector_dim=32, prompt_ids=(5, 9, 11))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_topk_at_the_search_shape_is_exact():
    device = _card()
    g = torch.Generator(device=device).manual_seed(31)
    logits = torch.randn((3072, 163840), generator=g, device=device) * 3
    assert topk_lse_route(logits, 3) == "block"
    before = topk_logsumexp.launches_by_route["block"]
    vals, idx, lse = topk_logsumexp(logits, 3)
    assert topk_logsumexp.launches_by_route["block"] == before + 1
    want = topk_logsumexp_reference(logits, 3)
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    torch.testing.assert_close(lse, want[2], rtol=0, atol=1e-4)


@pytest.mark.card
def test_grouped_product_matches_its_plain_version():
    device = _card()
    g = torch.Generator(device=device).manual_seed(32)
    rows, groups, k_dim, n_dim = 4096, 66, 2048, 2816
    x = torch.randn((rows, k_dim), generator=g, device=device).bfloat16()
    w = torch.randn((groups, n_dim, k_dim), generator=g,
                    device=device).bfloat16().transpose(1, 2)
    counts = torch.randint(0, 2 * rows // groups, (groups,), generator=g,
                           device=device)
    counts[5] = 0
    counts[-1] = rows - counts[:-1].sum().clamp(max=rows)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    got = moe_text.grouped_mm(x, w, offs)
    want = moe_text._grouped_mm_plain(x, w, offs)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2 * want.float().abs().max().item())


def _tiny(dtype: str, device):
    cfg = MoETextConfig(**TINY, compute_dtype=dtype)
    g = torch.Generator(device=device).manual_seed(33)
    params = moe_text.init_params(cfg, g, std=0.2)
    return cfg, params, moe_text.MoETextDecoder(cfg, params,
                                                getattr(torch, dtype))


@pytest.mark.card
def test_tiny_search_replays_its_eager_search():
    device = _card()
    cfg, _, dec = _tiny("bfloat16", device)
    g = torch.Generator(device=device).manual_seed(34)
    a, b = (torch.rand((16, cfg.cnn_feature_dim), generator=g,
                       device=device) for _ in range(2))
    want = beam.search_fn(dec, b, beam_width=3, max_words=8)
    for feats in (a, a, b):
        got = beam.search(dec, feats, beam_width=3, max_words=8)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)


@pytest.mark.card
def test_tiny_float32_search_equals_the_reference():
    device = _card()
    cfg, params, dec = _tiny("float32", device)
    g = torch.Generator(device=device).manual_seed(35)
    feats = torch.rand((6, cfg.cnn_feature_dim), generator=g, device=device)
    with strict_float32():
        tokens, scores = beam.search_fn(dec, feats, beam_width=3,
                                        max_words=8)
        words, want = ref.beam_search(params, dataclasses.asdict(cfg), feats,
                                      3, 8)
    for row, w in zip(tokens.tolist(), words):
        assert row[1:1 + len(w)] == w
    torch.testing.assert_close(scores, want, rtol=0, atol=1e-3)
