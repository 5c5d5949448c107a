"""The port's temperature sampling and best-of-N search against the JAX
package, on the CPU.

``jax.random`` streams cannot be reproduced in torch, so the tests draw
JAX's Gumbel noise (what ``jax.random.categorical`` adds to the tempered
logits: one ``gumbel(step_rng, (B, V))`` per step, ``step_rngs =
split(rng, max_words + 1)``) and inject it into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.decode import sample as jax_sample
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu_torch.core.vocab import BOS_ID, EOS_ID, Vocab
from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.decode import sample
from lrcn_tpu_torch.decode.writer import detokenize_batch, generate_captions
from lrcn_tpu_torch.models.lrcn import params_from_numpy

CPU = torch.device("cpu")
MAX_WORDS = 12


@pytest.fixture(scope="module")
def small():
    """The decode tests' config (tests/test_decode.py), f32."""
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=10,
                     vocab_size=25)
    params = jax_lrcn.init_params(jax.random.PRNGKey(3), cfg)
    decoder = params_from_numpy(jax.tree.map(np.asarray, params), CPU,
                                torch.float32)
    feats = np.random.default_rng(0).normal(size=(6, 10)).astype(np.float32)
    return cfg, params, decoder, feats


def jax_gumbel(rng, rows: int, vocab: int) -> np.ndarray:
    """The noise ``lrcn_tpu.decode.sample.sample_search`` draws from
    ``rng``: (max_words+1, rows, V)."""
    keys = jax.random.split(rng, MAX_WORDS + 1)
    return np.stack([np.asarray(jax.random.gumbel(k, (rows, vocab),
                                                  jnp.float32))
                     for k in keys])


def test_categorical_is_argmax_of_gumbel_plus_logits():
    """The identity the injected noise relies on, in this JAX version."""
    rng = jax.random.PRNGKey(4)
    logits = jax.random.normal(jax.random.PRNGKey(5), (7, 25))
    want = jax.random.categorical(rng, logits, axis=-1)
    got = jnp.argmax(jax.random.gumbel(rng, (7, 25), jnp.float32) + logits,
                     axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("temperature", [1.0, 2.0, 0.5])
def test_sample_search_matches_jax(small, temperature):
    """Tokens exactly JAX's, scores within 1e-5 (f32)."""
    cfg, params, decoder, feats = small
    rng = jax.random.PRNGKey(11)
    want_t, want_s = jax_sample.sample_search(
        params, jnp.asarray(feats), rng, temperature=temperature,
        max_words=MAX_WORDS, compute_dtype=jnp.float32)
    noise = torch.from_numpy(jax_gumbel(rng, feats.shape[0], cfg.vocab_size))
    tokens, scores = sample.sample_search(
        decoder, torch.from_numpy(feats), temperature=temperature,
        max_words=MAX_WORDS, gumbel=noise)
    assert tokens.shape == (feats.shape[0], MAX_WORDS + 2)
    assert (tokens[:, 0] == BOS_ID).all()
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    # the plain path (what the kernel path is held against on the card)
    plain = sample.sample_search(
        decoder, torch.from_numpy(feats), temperature=temperature,
        max_words=MAX_WORDS, gumbel=noise, use_kernels=False)
    assert torch.equal(plain[0], tokens) and torch.equal(plain[1], scores)


def test_best_of_n_search_matches_jax(small):
    """Same draws, same selection (the first best of each image's N)."""
    cfg, params, decoder, feats = small
    n = 5
    rng = jax.random.PRNGKey(2)
    want_t, want_s = jax_sample.best_of_n_search(
        params, jnp.asarray(feats), rng, n_samples=n, temperature=2.0,
        max_words=MAX_WORDS, compute_dtype=jnp.float32)
    noise = torch.from_numpy(jax_gumbel(rng, feats.shape[0] * n,
                                        cfg.vocab_size))
    tokens, scores = sample.best_of_n_search(
        decoder, torch.from_numpy(feats), n_samples=n, temperature=2.0,
        max_words=MAX_WORDS, gumbel=noise)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s),
                               rtol=1e-5, atol=1e-5)
    # the selection is each image's best draw, first among equals
    all_t, all_s = sample.sample_search(
        decoder, torch.from_numpy(feats).repeat_interleave(n, 0),
        temperature=2.0, max_words=MAX_WORDS, gumbel=noise)
    all_s = all_s.view(-1, n)
    best = all_s.argmax(1)
    assert (all_s.max(1).values == scores).all()
    for b in range(feats.shape[0]):
        assert torch.equal(all_t[b * n + best[b]], tokens[b])


def test_best_of_n_keeps_the_first_of_equal_scores(small):
    """Identical draws (the same noise for an image's N rows) tie; the
    first is kept, as ``jnp.argmax`` keeps it."""
    cfg, params, decoder, feats = small
    n = 3
    one = torch.from_numpy(jax_gumbel(jax.random.PRNGKey(0),
                                      feats.shape[0], cfg.vocab_size))
    noise = one.repeat_interleave(n, dim=1)
    tokens, scores = sample.best_of_n_search(
        decoder, torch.from_numpy(feats), n_samples=n, max_words=MAX_WORDS,
        gumbel=noise)
    first, first_s = sample.sample_search(
        decoder, torch.from_numpy(feats), temperature=2.0,
        max_words=MAX_WORDS, gumbel=one)
    assert torch.equal(tokens, first) and torch.equal(scores, first_s)


def test_done_rows_freeze(small):
    """After a row's first EOS: EOS filler, a frozen score."""
    cfg, params, decoder, feats = small
    gen = torch.Generator().manual_seed(0)
    feats_t = torch.from_numpy(np.repeat(feats, 8, axis=0))
    tokens, scores = sample.sample_search(decoder, feats_t, temperature=1.5,
                                          max_words=MAX_WORDS, generator=gen)
    ended = 0
    for row in tokens.numpy():
        hits = np.flatnonzero(row[1:] == EOS_ID)
        if hits.size:
            ended += 1
            assert (row[1 + hits[0]:] == EOS_ID).all()
    assert ended > 0
    assert torch.isfinite(scores).all() and (scores <= 0).all()


def test_generator_noise_is_seeded(small):
    """Without injected noise the draws come from the generator: the same
    seed repeats, another seed differs; noise is Gumbel(0, 1)."""
    cfg, params, decoder, feats = small
    feats_t = torch.from_numpy(np.repeat(feats, 8, axis=0))
    run = lambda seed: sample.best_of_n_search(
        decoder, feats_t, n_samples=4, max_words=MAX_WORDS,
        generator=torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    g = sample.gumbel_noise((200_000,), torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(float(g.mean()), 0.5772, atol=0.01)


def test_writer_sample_lines_are_the_best_of_n_rows(small):
    """``generate_captions(sample_n=...)``: each batch of ``batch_size``
    ids (the last padded with its last id) is one best-of-N search drawing
    from the writer's generator in order, and its lines detokenize the
    selected rows."""
    cfg, params, decoder, feats = small
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    store = FeatureStore(dim=10, normalized=True)
    rng = np.random.default_rng(2)
    for i in range(7):
        store.add(100 + i, np.abs(rng.standard_normal(10)).astype(np.float32))
    ids = [100 + i for i in (3, 0, 6, 1, 5, 2, 4)]
    lines = generate_captions(decoder, vocab, store, ids, device="cpu",
                              max_words=MAX_WORDS, batch_size=3,
                              sample_n=4, temperature=1.5,
                              generator=torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    want = []
    for start in range(0, len(ids), 3):
        chunk = ids[start:start + 3]
        padded = chunk + [chunk[-1]] * (3 - len(chunk))
        tokens, _ = sample.best_of_n_search(
            decoder, torch.from_numpy(store.gather(padded)), n_samples=4,
            temperature=1.5, max_words=MAX_WORDS, generator=gen)
        want += detokenize_batch(tokens.numpy()[:len(chunk)], vocab)
    assert lines == want and len(lines) == len(ids)
    assert all(line.endswith(".") for line in lines)
