"""The port's native host code against the JAX package's, on the CPU:
the C++ sources are byte copies, they build into the port's own build
directory (the HTTP front end and the load generator too), and the port's
image loaders give the JAX package's pixels for every file (JPEGs through
the native loader, PNGs and undecodable JPEGs through PIL), with the
native libraries on and off."""

import ctypes
import filecmp
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from lrcn_tpu.data import images as jax_images
from lrcn_tpu.native import imageloader_library as jax_imageloader
from lrcn_tpu_torch import native
from lrcn_tpu_torch.data import images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_native.py:_make_jpegs's sizes: landscape, portrait, exact,
# wide, large (DCT-scaled decode) and odd
SIZES = [(300, 400), (400, 300), (224, 224), (250, 600), (1024, 768),
         (231, 240)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JPEGs of tests/test_native.py, a PNG, a PNG named .jpg (native
    decode fails, PIL rescues), a grayscale JPEG and a corrupt blob."""
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    jpegs = []
    for i, (h, w) in enumerate(SIZES):
        path = str(root / f"img{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype("uint8")
                        ).save(path, quality=92)
        jpegs.append(path)
    gray = str(root / "gray.jpeg")
    Image.fromarray(rng.integers(0, 255, (260, 230)).astype("uint8")
                    ).save(gray, quality=85)
    jpegs.append(gray)
    png = str(root / "img.png")
    Image.fromarray(rng.integers(0, 255, (240, 300, 3)).astype("uint8")
                    ).save(png)
    fake = str(root / "png_named.jpg")
    Image.fromarray(rng.integers(0, 255, (250, 226, 3)).astype("uint8")
                    ).save(fake, format="PNG")
    return {"jpegs": jpegs, "png": png, "fake_jpeg": fake,
            "corrupt": b"not an image at all"}


def test_cpp_sources_are_byte_copies():
    for name in ("imageloader.cpp", "bleu.cpp", "httpserve.cpp",
                 "loadgen.cpp"):
        assert filecmp.cmp(os.path.join(REPO, "lrcn_tpu", "native", name),
                           os.path.join(REPO, "lrcn_tpu_torch", "native",
                                        name), shallow=False), name


def test_libraries_build_into_the_port_build_dir(monkeypatch):
    """Both build (as the JAX package's do here, tests/test_native.py),
    under ``build/lrcn_tpu_torch/native/`` with the source hash in the
    name; ``LRCN_NATIVE=0`` turns both off."""
    assert jax_imageloader() is not None
    for name, lib in (("imageloader", native.imageloader_library()),
                      ("bleu", native.bleu_library())):
        assert lib is not None, name
        path = native.library_path(name)
        assert path.exists()
        assert path.parent == native.BUILD_DIR
        assert os.path.relpath(path, REPO).startswith(
            os.path.join("build", "lrcn_tpu_torch", "native", f"lib{name}_"))
    monkeypatch.setenv("LRCN_NATIVE", "0")
    assert native.imageloader_library() is None
    assert native.bleu_library() is None
    assert native.httpserve_library() is None
    assert native.loadgen_binary() is None
    assert images.load_batch_native(["x.jpg"]) is None
    assert images.decode_blobs_native([b"x"]) is None


def test_front_end_and_loadgen_build_into_the_port_build_dir():
    """The HTTP front end builds as ``libhttpserve_<hash>.so`` and the load
    generator as the executable ``lrcn_loadgen_<hash>``, both in
    ``build/lrcn_tpu_torch/native/``, each name changing with its source's
    bytes and flags; the front end's C entry points have their argtypes."""
    lib = native.httpserve_library()
    assert lib is not None and lib._lrcn_configured
    assert lib.lrcn_serve_start.restype is ctypes.c_void_p
    path = native.library_path("httpserve")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libhttpserve_") and path.suffix == ".so"
    exe = native.loadgen_binary()
    assert exe == str(native.loadgen_path())
    assert os.path.relpath(exe, REPO).startswith(
        os.path.join("build", "lrcn_tpu_torch", "native", "lrcn_loadgen_"))
    assert os.access(exe, os.X_OK)
    usage = subprocess.run([exe], capture_output=True, text=True, timeout=30)
    assert usage.returncode == 2 and "usage" in usage.stderr
    assert native.loadgen_path() != native._hashed(
        "loadgen", native.LOADGEN_FLAGS + ("-g",), "lrcn_loadgen_{}")
    assert native.library_path("httpserve") != native.library_path("bleu")


def test_native_batch_decode_matches_jax(files):
    paths = files["jpegs"] + [files["fake_jpeg"]]
    got, ok = images.load_batch_native(paths)
    want, want_ok = jax_images.load_batch_native(paths)
    assert ok.tolist() == want_ok.tolist() == [True] * (len(paths) - 1) + [
        False]
    np.testing.assert_array_equal(got, want)
    assert (got[-1] == 0).all()
    blobs = [Path(p).read_bytes() for p in paths] + [files["corrupt"]]
    got, ok = images.decode_blobs_native(blobs)
    want, want_ok = jax_images.decode_blobs_native(blobs)
    assert ok.tolist() == want_ok.tolist()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native_on", [True, False])
def test_loaders_give_the_jax_pixels(files, monkeypatch, native_on):
    """``load_images``, ``load_blobs`` and ``load_preprocessed`` equal the
    JAX package's pixel for pixel: JPEGs, a grayscale JPEG, a PNG, a PNG
    named .jpg, a corrupt blob (flagged, zero in both)."""
    if not native_on:
        monkeypatch.setenv("LRCN_NATIVE", "0")
    jpegs = files["jpegs"] + [files["fake_jpeg"]]
    np.testing.assert_array_equal(images.load_images(jpegs),
                                  jax_images.load_images(jpegs))
    mixed = jpegs[:2] + [files["png"]]      # not all JPEGs: PIL for all
    np.testing.assert_array_equal(images.load_images(mixed),
                                  jax_images.load_images(mixed))
    for path in jpegs + [files["png"]]:
        np.testing.assert_array_equal(images.load_preprocessed(path),
                                      jax_images.load_preprocessed(path))
    blobs = [Path(p).read_bytes() for p in jpegs + [files["png"]]]
    blobs.append(files["corrupt"])
    got, ok = images.load_blobs(blobs)
    want, want_ok = jax_images.load_blobs(blobs)
    assert ok.tolist() == want_ok.tolist() == [True] * (len(blobs) - 1) + [
        False]
    np.testing.assert_array_equal(got, want)


def test_native_jpegs_differ_from_pil(files):
    """The loaders above are pinned to the native decode: its resampler is
    not PIL's, so a PIL-only port would not give the JAX pixels."""
    path = files["jpegs"][0]
    pil = images.resize_crop(images.decode_image(path))
    assert not np.array_equal(images.load_preprocessed(path), pil)


def test_joint_trainer_loads_the_jax_pixels(files):
    """``JointTrainer._load_images`` decodes a batch's ids through
    ``load_images`` in both packages: the same uint8 batch."""
    from lrcn_tpu.config import LRCNConfig as JaxConfig
    from lrcn_tpu.core.vocab import Vocab as JaxVocab
    from lrcn_tpu.data.batcher import Batch as JaxBatch
    from lrcn_tpu.train.joint import JointTrainer as JaxJointTrainer
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.core.vocab import Vocab
    from lrcn_tpu_torch.data.batcher import Batch
    from lrcn_tpu_torch.train.joint import JointTrainer

    paths = {10 + i: p for i, p in enumerate(files["jpegs"])}
    ids = np.array([12, 10, 15, 15], np.int64)    # a padded row repeats
    tokens = np.zeros((4, 3), np.int32)
    lengths = np.array([3, 2, 1, -1], np.int32)
    kw = dict(hidden=(8, 8), embed=4, cnn_feature_dim=8, vocab_size=10)
    port = JointTrainer(LRCNConfig(**kw), Vocab(["a"]), paths,
                        np.zeros((224, 224, 3), np.float32), device="cpu")
    ref = JaxJointTrainer(JaxConfig(**kw), JaxVocab(["a"]), paths,
                          np.zeros((224, 224, 3), np.float32))
    got = port._load_images(Batch(ids, tokens, lengths))
    want = ref._load_images(JaxBatch(ids, tokens, lengths))
    assert got.dtype == np.uint8 and got.shape == (4, 224, 224, 3)
    np.testing.assert_array_equal(got, want)
    chunk = port._load_chunk([Batch(ids, tokens, lengths)] * 2)
    assert chunk[0].shape == (2, 4, 224, 224, 3)
    np.testing.assert_array_equal(chunk[0][1], want)

