"""The port's serving slice against the JAX package, on the CPU: checkpoint
(decoder-only and joint) and feature-store files cross between the
packages, and the port's ``CaptionService`` (by id, by features, by image)
and ``generate_captions`` give the JAX package's captions in f32."""

import functools
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.core.vocab import Vocab
from lrcn_tpu.data.feature_store import FeatureStore
from lrcn_tpu.decode.writer import generate_captions as jax_generate
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu.models.joint import JointParams
from lrcn_tpu.serve.service import CaptionService as JaxCaptionService
from lrcn_tpu.train.checkpoint import save_checkpoint
from lrcn_tpu_torch.data.feature_store import FeatureStore as TorchStore
from lrcn_tpu_torch.decode.writer import generate_captions
from lrcn_tpu_torch.serve import CaptionService
from lrcn_tpu_torch.train.checkpoint import load_checkpoint

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A JAX-written f32 checkpoint and feature store (the tiny serving
    config of tests/test_serve.py)."""
    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=8, compute_dtype="float32")
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    params = jax_lrcn.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    feats = {100 + i: np.abs(rng.standard_normal(cfg.cnn_feature_dim)
                             ).astype(np.float32) for i in range(40)}
    store = FeatureStore.from_dict(feats, normalized=False)
    root = tmp_path_factory.mktemp("jax_written")
    save_checkpoint(str(root / "ckpt"), params, vocab, cfg, step=7, epoch=2)
    store.save(str(root / "store"))
    return cfg, vocab, params, store, root


def test_jax_checkpoint_loads_in_port(tiny):
    cfg, vocab, params, _, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    for field in ("hidden", "embed", "cnn_feature_dim", "vocab_size",
                  "compute_dtype", "beam_width"):
        assert getattr(ck["cfg"], field) == getattr(cfg, field), field
    assert ck["vocab"].words == vocab.words
    assert (ck["step"], ck["epoch"]) == (7, 2)
    decoder = ck["decoder"]
    assert decoder.compute_dtype == torch.float32   # from the config
    np.testing.assert_array_equal(decoder.lstm1_w.numpy(),
                                  np.asarray(params["lstm1"]["w"]))
    np.testing.assert_array_equal(decoder.w_out.numpy(),
                                  np.asarray(params["w_out"]))
    bf16 = load_checkpoint(str(root / "ckpt"), CPU, torch.bfloat16)
    assert bf16["decoder"].lstm2_w.dtype == torch.bfloat16
    assert bf16["decoder"].embedding.dtype == torch.float32
    assert ck["vgg"] is None and ck["average_image"] is None


def test_incomplete_checkpoint_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), CPU)


def test_feature_store_crosses_packages(tiny, tmp_path):
    _, _, _, store, root = tiny
    ported = TorchStore.load(str(root / "store"))
    assert ported.ids() == store.ids() and not ported.normalized
    np.testing.assert_array_equal(ported.table(), store.table())
    ported.save(str(tmp_path / "back"))
    back = FeatureStore.load(str(tmp_path / "back"))
    np.testing.assert_array_equal(back.gather(store.ids()),
                                  store.gather(store.ids()))


def _services(tiny, **kw):
    cfg, vocab, params, store, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    ported = CaptionService(cfg, ck["decoder"], ck["vocab"], device=CPU,
                            store=TorchStore.load(str(root / "store")),
                            **kw)
    ref = JaxCaptionService(cfg, params, vocab, store=store,
                            compute_dtype=jnp.float32, **kw)
    return ported, ref


@pytest.mark.parametrize("n_ids", [1, 5, 17])
def test_caption_ids_match_jax_service(tiny, n_ids):
    """Single requests and bursts above decode_batch (grouped searches)."""
    ported, ref = _services(tiny, beam_width=2, max_words=8, decode_batch=4)
    try:
        ids = tiny[3].ids()[:n_ids]
        got = ported.caption_ids(ids)
        assert got == ref.caption_ids(ids)
        assert all(line.endswith(" .") or line == "." for line in got)
    finally:
        ported.close()
        ref.close()


def test_caption_features_match_jax_service(tiny):
    ported, ref = _services(tiny, beam_width=3, max_words=8, decode_batch=4)
    try:
        rows = list(tiny[3].table()[:11] * 3.0)   # raw, unnormalized
        assert ported.caption_features(rows) == ref.caption_features(rows)
        with pytest.raises(ValueError):
            ported.caption_features([np.ones(5, np.float32)])
    finally:
        ported.close()
        ref.close()


def test_concurrent_requests_and_stats(tiny):
    ported, ref = _services(tiny, beam_width=2, max_words=6, decode_batch=4,
                            max_wait_ms=20.0)
    try:
        ported.warmup()
        ids = tiny[3].ids()
        want = dict(zip(ids, ref.caption_ids(ids)))
        results, errors = {}, []

        def client(chunk):
            try:
                for i, line in zip(chunk, ported.caption_ids(chunk)):
                    results[i] = line
            except Exception as e:   # surfaced by the assert below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(ids[s::8],))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        assert results == want
        stats = ported.stats()["decode_ids"]
        assert stats["requests"] >= len(ids) and stats["errors"] == 0
    finally:
        ported.close()
        ref.close()


@pytest.mark.parametrize("beam_width,resident", [(3, True), (3, False),
                                                 (1, True)])
def test_generate_captions_lines_match_jax_writer(tiny, beam_width,
                                                  resident):
    cfg, vocab, params, store, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    ids = store.ids()[:29] + store.ids()[:3]     # ragged tail, repeats
    kw = dict(beam_width=beam_width, max_words=9, batch_size=4,
              scan_depth=3, resident_store=resident)
    ref = jax_generate(params, vocab, store, ids,
                       compute_dtype=jnp.float32, **kw)
    got = generate_captions(ck["decoder"], ck["vocab"],
                            TorchStore.load(str(root / "store")), ids,
                            device=CPU, **kw)
    assert "\n".join(got).encode() == "\n".join(ref).encode()


# --- joint (CNN + decoder) checkpoints and the encoder stage ---


@pytest.fixture(scope="module")
def tiny_joint(tmp_path_factory):
    """A JAX-written f32 joint checkpoint (``JointParams``, the layout of
    the JAX joint trainer: ``cnn/...``, ``decoder/...`` and
    ``average_image.npy``) with the tiny config of tests/test_serve.py and
    a width-scaled VGG (8 channels, fc width 16)."""
    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=16, compute_dtype="float32")
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    decoder = jax_lrcn.init_params(jax.random.PRNGKey(0), cfg)
    # jitted: one compile instead of one per layer shape
    cnn = jax.jit(functools.partial(
        jax_vgg.init_vgg_params, width_multiplier=0.05,
        fc_dim=cfg.cnn_feature_dim))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(8)
    cnn = {name: {"w": np.asarray(layer["w"]),
                  "b": (rng.standard_normal(layer["b"].shape) * 0.1
                        ).astype(np.float32)}
           for name, layer in cnn.items()}
    avg = rng.uniform(90, 130, (224, 224, 3)).astype(np.float32)
    root = tmp_path_factory.mktemp("jax_joint")
    save_checkpoint(str(root / "ckpt"), JointParams(cnn=cnn, decoder=decoder),
                    vocab, cfg, step=3)
    np.save(str(root / "ckpt" / "average_image.npy"), avg)
    return cfg, vocab, decoder, cnn, avg, root / "ckpt"


@pytest.mark.parametrize("with_average_image", [True, False])
def test_jax_joint_checkpoint_loads_in_port(tiny_joint, with_average_image):
    """The decoder comes from ``decoder/``, the encoder from ``cnn/``, the
    mean image from ``average_image.npy`` (zeros without one): the
    counterpart of ``lrcn_tpu/cli.py:_joint_encoder``."""
    cfg, vocab, decoder, cnn, avg, path = tiny_joint
    if not with_average_image:
        import shutil
        path = shutil.copytree(path, path.parent / "no_avg")
        (path / "average_image.npy").unlink()
    ck = load_checkpoint(str(path), CPU)
    assert ck["vocab"].words == vocab.words and ck["step"] == 3
    for key in ("lstm1/w", "lstm2/b", "w_cnn", "embedding", "w_out"):
        module, _, leaf = key.rpartition("/")
        want = decoder[module][leaf] if module else decoder[leaf]
        got = getattr(ck["decoder"], key.replace("/", "_"))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vgg = ck["vgg"]
    assert vgg is not None and vgg.compute_dtype == torch.float32
    for name, layer in cnn.items():
        w = np.asarray(layer["w"])
        if name == "fc6":
            w = w.reshape(-1, w.shape[-1])
        np.testing.assert_array_equal(getattr(vgg, f"{name}_w").numpy(), w)
        np.testing.assert_array_equal(getattr(vgg, f"{name}_b").numpy(),
                                      layer["b"])
    want_avg = avg if with_average_image else np.zeros_like(avg)
    np.testing.assert_array_equal(ck["average_image"], want_avg)
    bf16 = load_checkpoint(str(path), CPU, torch.bfloat16)["vgg"]
    assert bf16.conv1_1_w.dtype == torch.bfloat16
    assert bf16.conv1_1_b.dtype == torch.float32


def _image_services(tiny_joint, **kw):
    cfg, vocab, decoder, cnn, avg, path = tiny_joint
    ck = load_checkpoint(str(path), CPU)
    ported = CaptionService(cfg, ck["decoder"], ck["vocab"], device=CPU,
                            vgg=ck["vgg"], average_image=ck["average_image"],
                            **kw)
    ref = JaxCaptionService(cfg, decoder, vocab, vgg_params=cnn,
                            average_image=avg, compute_dtype=jnp.float32,
                            **kw)
    return ported, ref


def _uint8_images(seed, n):
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 256, (n, 224, 224, 3)).astype(np.uint8))


def test_caption_images_match_jax_service(tiny_joint):
    """Five images through an encode batch of 2 (padded last batch) and a
    decode batch of 4: captions equal to the JAX service's at f32."""
    ported, ref = _image_services(tiny_joint, beam_width=2, max_words=8,
                                  decode_batch=4, encode_batch=2)
    try:
        images = _uint8_images(21, 5)
        got = ported.caption_images(images)
        assert got == ref.caption_images(images)
        assert all(line.endswith(" .") or line == "." for line in got)
        assert ported.stats()["encode"]["requests"] == 5
        assert ported.caption_images([]) == []
    finally:
        ported.close()
        ref.close()


def test_caption_image_bytes_match_jax_service(tiny_joint):
    from PIL import Image

    ported, ref = _image_services(tiny_joint, beam_width=3, max_words=8,
                                  decode_batch=4, encode_batch=2)
    try:
        blobs = []
        for i, img in enumerate(_uint8_images(22, 3)):
            buf = io.BytesIO()
            Image.fromarray(img[: 200 + 20 * i]).save(buf, format="PNG")
            blobs.append(buf.getvalue())
        ported.warmup()
        assert ported.caption_image_bytes(blobs) == \
            ref.caption_image_bytes(blobs)
        with pytest.raises(ValueError, match="blob 1"):
            ported.caption_image_bytes([blobs[0], b"not an image"])
    finally:
        ported.close()
        ref.close()


def test_service_without_encoder_refuses_images(tiny, tiny_joint):
    cfg, vocab, params, store, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    svc = CaptionService(cfg, ck["decoder"], ck["vocab"], device=CPU)
    try:
        with pytest.raises(RuntimeError, match="no encoder"):
            svc.caption_images(_uint8_images(0, 1))
        assert "encode" not in svc.stats()
    finally:
        svc.close()
    joint = load_checkpoint(str(tiny_joint[5]), CPU)
    with pytest.raises(ValueError, match="features"):
        CaptionService(cfg, ck["decoder"], ck["vocab"], device=CPU,
                       vgg=joint["vgg"])    # fc7 width 16, decoder's 8


def test_caption_ids_on_an_empty_store_match_jax_service(tiny):
    """A service over a store with no rows: ``caption_ids([])`` gives
    ``[]`` and ``caption_ids([5])`` the store's ``KeyError``, in both
    packages (the port raised ``RuntimeError`` for both)."""
    cfg, vocab, params, _, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    ported = CaptionService(cfg, ck["decoder"], ck["vocab"], device=CPU,
                            store=TorchStore(dim=10), beam_width=2,
                            max_words=4)
    ref = JaxCaptionService(cfg, params, vocab, store=FeatureStore(dim=10),
                            compute_dtype=jnp.float32, beam_width=2,
                            max_words=4)
    try:
        assert ported.caption_ids([]) == ref.caption_ids([]) == []
        errors = []
        for svc in (ported, ref):
            with pytest.raises(KeyError) as err:
                svc.caption_ids([5])
            errors.append(str(err.value))
        assert errors[0] == errors[1] == "'missing features for image 5'"
    finally:
        ported.close()
        ref.close()


def test_caption_jpeg_bytes_match_jax_service(tiny_joint):
    """JPEG bodies decode through the native loader in both packages, so
    the services see the same pixels and give the same captions."""
    from PIL import Image

    ported, ref = _image_services(tiny_joint, beam_width=2, max_words=8,
                                  decode_batch=4, encode_batch=2)
    try:
        blobs = []
        for i, img in enumerate(_uint8_images(23, 3)):
            buf = io.BytesIO()
            Image.fromarray(img[: 190 + 17 * i]).save(buf, format="JPEG",
                                                      quality=90)
            blobs.append(buf.getvalue())
        assert ported.caption_image_bytes(blobs) == \
            ref.caption_image_bytes(blobs)
    finally:
        ported.close()
        ref.close()


@pytest.mark.parametrize("normalize", [False, True])
def test_generate_captions_normalize_matches_jax_writer(tiny, normalize):
    """``normalize=`` overrides the store's flag (the unnormalized store
    read raw, or normalized on the fly) as in the JAX writer."""
    cfg, vocab, params, store, root = tiny
    ck = load_checkpoint(str(root / "ckpt"), CPU)
    ids = store.ids()[:9]
    kw = dict(beam_width=2, max_words=7, batch_size=4, scan_depth=2,
              resident_store=False, normalize=normalize)
    ref = jax_generate(params, vocab, store, ids, compute_dtype=jnp.float32,
                       **kw)
    got = generate_captions(ck["decoder"], ck["vocab"],
                            TorchStore.load(str(root / "store")), ids,
                            device=CPU, **kw)
    assert got == ref
