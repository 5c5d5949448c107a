"""The port's batch-sharded decoding and mesh service against the JAX
package, on the CPU: ``sharded_beam_search`` (beam and greedy) over a
4-entry mesh that lists the CPU four times against JAX's on 4 of the
pytest process's virtual devices, tokens exactly equal at f32; and
``CaptionService(mesh=)`` by id, by features and by image against JAX's
``CaptionService(mesh=)``, captions equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.parallel import make_mesh as jax_make_mesh
from lrcn_tpu.parallel.decode import sharded_beam_search as jax_sharded
from lrcn_tpu.serve.service import CaptionService as JaxCaptionService
from lrcn_tpu_torch.data.feature_store import FeatureStore as TorchStore
from lrcn_tpu_torch.decode.beam import search
from lrcn_tpu_torch.parallel import make_mesh
from lrcn_tpu_torch.parallel.decode import (DataShards, shard_for_decode,
                                            sharded_beam_search)
from lrcn_tpu_torch.serve import CaptionService
from lrcn_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_serve import _uint8_images, tiny, tiny_joint  # noqa: F401

CPU = torch.device("cpu")


def cpu_mesh(n):
    return make_mesh((n, 1), devices=[CPU] * n)


@pytest.mark.parametrize("beam_width", [3, 1])
def test_sharded_search_matches_jax(tiny, beam_width):
    """16 rows over 4 shards, beam 3 and greedy: tokens exactly JAX's,
    and the same as one unsharded search."""
    cfg, _, params, store, root = tiny
    decoder = load_checkpoint(str(root / "ckpt"), CPU)["decoder"]
    feats = store.table()[:16] / store.table()[:16].sum(1, keepdims=True)
    want, want_scores = jax_sharded(params, feats, jax_make_mesh((4, 1)),
                                    beam_width=beam_width, max_words=8,
                                    compute_dtype=jnp.float32)
    tokens, scores = sharded_beam_search(decoder, feats, cpu_mesh(4),
                                         beam_width=beam_width, max_words=8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5, atol=1e-6)
    whole, _ = search(decoder, torch.from_numpy(feats),
                      beam_width=beam_width, max_words=8)
    np.testing.assert_array_equal(tokens.numpy(), whole.numpy())


def test_shard_for_decode_splits_contiguously(tiny):
    _, _, _, store, root = tiny
    decoder = load_checkpoint(str(root / "ckpt"), CPU)["decoder"]
    feats = store.table()[:8]
    pairs = shard_for_decode(decoder, feats, cpu_mesh(4))
    assert [p[0] for p in pairs] == [decoder] * 4      # one device: shared
    np.testing.assert_array_equal(
        torch.cat([p[1] for p in pairs]).numpy(), feats)
    assert [len(p[1]) for p in pairs] == [2] * 4
    with pytest.raises(ValueError, match="do not split"):
        shard_for_decode(decoder, store.table()[:6], cpu_mesh(4))
    assert DataShards(cpu_mesh(2)).split(6) == [slice(0, 3), slice(3, 6)]


def test_replicas_are_cached_per_source_object():
    """One copy per source object and device, reused while the object is
    the same; an entry whose source is another object (an id reused after
    the first one was freed) is not returned for it."""
    meta = torch.device("meta")
    shards = DataShards(make_mesh((2, 1), devices=[CPU, meta]))
    a, b = torch.ones(3), torch.zeros(3)
    here, there = shards.replicate(a)
    assert here is a and there.device == meta
    assert shards.replicate(a)[1] is there
    assert shards.replicate(b)[1] is not there
    stale = torch.empty(3, device=meta)
    shards._copies[(id(b), meta)] = (a, stale)     # another object's entry
    fresh = shards.replicate(b)[1]
    assert fresh is not stale and fresh.device == meta


def _mesh_services(tiny, n, **kw):
    cfg, vocab, params, store, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    ported = CaptionService(cfg, ck["decoder"], ck["vocab"],
                            store=TorchStore.load(str(root / "store")),
                            mesh=cpu_mesh(n), **kw)
    ref = JaxCaptionService(cfg, params, vocab, store=store,
                            compute_dtype=jnp.float32,
                            mesh=jax_make_mesh((n, 1)), **kw)
    return ported, ref


@pytest.mark.parametrize("n_ids", [3, 17])
def test_mesh_service_ids_and_features_match_jax(tiny, n_ids):
    """By id (a single batch and a grouped burst above decode_batch) and
    by features, over a 2-shard mesh: captions equal to JAX's mesh
    service."""
    ported, ref = _mesh_services(tiny, 2, beam_width=2, max_words=8,
                                 decode_batch=4)
    try:
        assert ported.device == CPU
        ids = tiny[3].ids()[:n_ids]
        assert ported.caption_ids(ids) == ref.caption_ids(ids)
        rows = list(tiny[3].table()[:n_ids] * 2.0)
        assert ported.caption_features(rows) == ref.caption_features(rows)
    finally:
        ported.close()
        ref.close()


def test_mesh_service_images_match_jax(tiny_joint):
    """By image through a width-0.05 VGG: each encoder batch of 2 splits
    over 2 shards; captions equal to JAX's mesh service."""
    cfg, vocab, decoder, cnn, avg, path = tiny_joint
    ck = load_checkpoint(str(path), CPU)
    kw = dict(beam_width=2, max_words=8, decode_batch=4, encode_batch=2)
    ported = CaptionService(cfg, ck["decoder"], ck["vocab"], vgg=ck["vgg"],
                            average_image=ck["average_image"],
                            mesh=cpu_mesh(2), **kw)
    ref = JaxCaptionService(cfg, decoder, vocab, vgg_params=cnn,
                            average_image=avg, compute_dtype=jnp.float32,
                            mesh=jax_make_mesh((2, 1)), **kw)
    try:
        images = _uint8_images(21, 5)
        assert ported.caption_images(images) == ref.caption_images(images)
    finally:
        ported.close()
        ref.close()


def test_mesh_service_divisibility_error_matches_jax(tiny):
    cfg, vocab, params, store, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    with pytest.raises(ValueError) as port_err:
        CaptionService(cfg, ck["decoder"], ck["vocab"], decode_batch=6,
                       mesh=cpu_mesh(4))
    with pytest.raises(ValueError) as jax_err:
        JaxCaptionService(cfg, params, vocab, decode_batch=6,
                          compute_dtype=jnp.float32,
                          mesh=jax_make_mesh((4, 1)))
    assert str(port_err.value) == str(jax_err.value)
    assert "divisible by the mesh's data axis (4)" in str(port_err.value)
