"""The port's decoder and searches against the JAX package, on the CPU.

Both packages get the same parameters (``lrcn_tpu.models.lrcn.init_params``
converted with ``params_from_numpy``) and the same numpy features.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.decode import beam as jax_beam
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu_torch.core.vocab import BOS_ID, EOS_ID
from lrcn_tpu_torch.decode import beam as torch_beam
from lrcn_tpu_torch.models import lrcn as torch_lrcn
from lrcn_tpu_torch.models.lrcn import params_from_numpy

CPU = torch.device("cpu")


def _model(cfg, seed):
    params = jax_lrcn.init_params(jax.random.PRNGKey(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def small():
    """The decode tests' config (tests/test_decode.py)."""
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    params, tree = _model(cfg, 3)
    feats = np.random.default_rng(0).normal(
        size=(6, cfg.cnn_feature_dim)).astype(np.float32)
    return cfg, params, tree, feats


@pytest.mark.parametrize("dtype,tol", [
    # f32: same operands, other summation order
    (torch.float32, dict(rtol=1e-5, atol=1e-5)),
    # bf16: same bf16-rounded operands, f32 sums in another order
    (torch.bfloat16, dict(rtol=0, atol=1e-4)),
])
def test_decode_step_logits_match_jax(small, dtype, tol):
    cfg, params, tree, feats = small
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    decoder = params_from_numpy(tree, CPU, dtype)
    rng = np.random.default_rng(1)
    b_dim = feats.shape[0]
    tokens = rng.integers(0, cfg.vocab_size, b_dim)
    state = [rng.standard_normal((b_dim, h)).astype(np.float32)
             for h in (16, 16, 12, 12)]

    j_proj = jax_lrcn.cnn_projection(params, jnp.asarray(feats), jdt)
    j_state, j_logits = jax_lrcn.decode_step(
        params, jax_lrcn.LSTMState(*map(jnp.asarray, state)),
        jnp.asarray(tokens), j_proj, jdt)

    t_proj = torch_lrcn.cnn_projection(decoder, torch.from_numpy(feats))
    np.testing.assert_allclose(t_proj.numpy(), np.asarray(j_proj), **tol)
    t_state, t_logits = torch_lrcn.decode_step(
        decoder, torch_lrcn.LSTMState(*map(torch.from_numpy, state)),
        torch.from_numpy(tokens), t_proj)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               **tol)
    for t, j in zip(t_state, j_state):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _torch_search(decoder, feats, **kw):
    tokens, scores = torch_beam.beam_search(decoder, torch.from_numpy(feats),
                                            **kw)
    return tokens.numpy(), scores.numpy()


def _assert_tokens_equal(got, ref, got_scores, ref_scores):
    """Exact tokens; where they differ, report the score gap of the rows
    (a near-tie that vals - lse and log_softmax round apart)."""
    bad = np.flatnonzero((got != ref).any(axis=1))
    assert bad.size == 0, (
        f"rows {bad.tolist()} differ; score gaps "
        f"{np.abs(got_scores[bad] - ref_scores[bad]).tolist()}\n"
        f"port {got[bad].tolist()}\njax  {ref[bad].tolist()}")


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_beam_search_tokens_match_jax_f32(small, k):
    cfg, params, tree, feats = small
    decoder = params_from_numpy(tree, CPU, torch.float32)
    ref_t, ref_s = jax_beam.beam_search(params, jnp.asarray(feats),
                                        beam_width=k, max_words=12,
                                        compute_dtype=jnp.float32)
    ref_t, ref_s = np.asarray(ref_t), np.asarray(ref_s)
    tokens, scores = _torch_search(decoder, feats, beam_width=k,
                                   max_words=12)
    assert tokens.shape == (feats.shape[0], 14)
    assert (tokens[:, 0] == BOS_ID).all()
    _assert_tokens_equal(tokens, ref_t, scores, ref_s)
    # scores: the same sums, rounded as vals - lse against log_softmax
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5, atol=1e-5)
    # the explicit plain path (what the card's kernels are held against)
    plain_t, plain_s = _torch_search(decoder, feats, beam_width=k,
                                     max_words=12, use_kernels=False)
    np.testing.assert_array_equal(plain_t, tokens)
    np.testing.assert_array_equal(plain_s, scores)


@pytest.mark.parametrize("entry", ["beam_search", "search"])
@pytest.mark.parametrize("k", [9, 12])
def test_wide_beams_match_jax_f32(small, k, entry):
    """Beam widths above 8, which the JAX package takes (``lax.top_k``)
    and the port once refused."""
    cfg, params, tree, feats = small
    decoder = params_from_numpy(tree, CPU, torch.float32)
    ref_t, ref_s = jax_beam.beam_search(params, jnp.asarray(feats),
                                        beam_width=k, max_words=12,
                                        compute_dtype=jnp.float32)
    ref_t, ref_s = np.asarray(ref_t), np.asarray(ref_s)
    tokens, scores = getattr(torch_beam, entry)(
        decoder, torch.from_numpy(feats), beam_width=k, max_words=12)
    tokens, scores = tokens.numpy(), scores.numpy()
    assert tokens.shape == (feats.shape[0], 14)
    _assert_tokens_equal(tokens, ref_t, scores, ref_s)
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5, atol=1e-5)


def test_beam_search_matches_jax_pallas_path():
    """The JAX beam search through its Pallas LSTM kernel (interpret mode,
    as tests/test_pallas.py runs it) against the port's, which runs the
    kernel's plain version on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    cfg = LRCNConfig(hidden=(32, 32), embed=24, cnn_feature_dim=48,
                     vocab_size=50, compute_dtype="float32")
    params, tree = _model(cfg, 0)
    feats = np.random.default_rng(1).standard_normal((4, 48)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref_t, ref_s = jax_beam.beam_search(
            params, jnp.asarray(feats), beam_width=3, max_words=8,
            compute_dtype=jnp.float32, use_pallas=True)
    ref_t, ref_s = np.asarray(ref_t), np.asarray(ref_s)
    decoder = params_from_numpy(tree, CPU, torch.float32)
    tokens, scores = _torch_search(decoder, feats, beam_width=3,
                                   max_words=8)
    _assert_tokens_equal(tokens, ref_t, scores, ref_s)
    np.testing.assert_allclose(scores, ref_s, rtol=1e-5, atol=1e-5)


def test_greedy_tokens_match_jax_f32(small):
    cfg, params, tree, feats = small
    decoder = params_from_numpy(tree, CPU, torch.float32)
    ref_t, ref_s = jax_beam.greedy_search(params, jnp.asarray(feats),
                                          max_words=12,
                                          compute_dtype=jnp.float32)
    tokens, scores = torch_beam.greedy_search(
        decoder, torch.from_numpy(feats), max_words=12)
    _assert_tokens_equal(tokens.numpy(), np.asarray(ref_t), scores.numpy(),
                         np.asarray(ref_s))
    np.testing.assert_allclose(scores.numpy(), np.asarray(ref_s),
                               rtol=1e-5, atol=1e-5)


def test_done_rows_get_eos_filler(small):
    """After a row's first EOS every later column is EOS filler."""
    cfg, params, tree, feats = small
    decoder = params_from_numpy(tree, CPU, torch.float32)
    tokens, _ = _torch_search(decoder, feats, beam_width=3, max_words=12)
    for row in tokens:
        gen = row[1:]
        hits = np.flatnonzero(gen == EOS_ID)
        if hits.size:
            assert (gen[hits[0]:] == EOS_ID).all()


@pytest.mark.parametrize("beam_width", [1, 3])
def test_grouped_and_rows_search_equal_per_batch(small, beam_width):
    cfg, params, tree, feats = small
    decoder = params_from_numpy(tree, CPU, torch.float32)
    kw = dict(max_words=10)
    groups = torch.from_numpy(
        np.concatenate([feats, feats[::-1]]).reshape(2, 6, -1).copy())
    if beam_width == 1:
        g_tok, g_sc = torch_beam.greedy_search_grouped(decoder, groups, **kw)
    else:
        g_tok, g_sc = torch_beam.beam_search_grouped(
            decoder, groups, beam_width=beam_width, **kw)
    assert g_tok.shape == (2, 6, 12) and g_sc.shape == (2, 6)
    idx = torch.tensor([[0, 5, 2], [3, 3, 1]])
    r_tok, r_sc = torch_beam.rows_search(
        decoder, groups[0], idx, beam_width=beam_width, **kw)
    assert r_tok.shape == (2, 3, 12)
    for g in range(2):
        p_tok, p_sc = torch_beam.search(decoder, groups[g],
                                        beam_width=beam_width, **kw)
        np.testing.assert_array_equal(g_tok[g].numpy(), p_tok.numpy())
        np.testing.assert_allclose(g_sc[g].numpy(), p_sc.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r_tok[g].numpy(),
                                      g_tok[0][idx[g]].numpy())
