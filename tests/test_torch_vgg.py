"""The port's VGG-16 encoder path against the JAX package, on the CPU.

On CPU tensors the conv kernel's wrapper computes its plain PyTorch
version; these tests hold that version against the Pallas kernel in
interpret mode and against ``lax.conv_general_dilated``, the port's
``vgg16_fc7`` against JAX's, and the host image pipeline and
``extract_features`` against the JAX module's, on the same numpy inputs.
Sizes are small: ``width_multiplier=0.05`` (8 channels), fc width 16,
224x224 images (fc6 needs the 7x7 map).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lrcn_tpu.data import images as jax_images
from lrcn_tpu.data.feature_store import FeatureStore
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu.ops.pallas.conv3x3 import fused_conv3x3_relu as jax_conv
from lrcn_tpu_torch.data import images as torch_images
from lrcn_tpu_torch.data.feature_store import FeatureStore as TorchStore
from lrcn_tpu_torch.models import vgg as torch_vgg
from lrcn_tpu_torch.ops.kernels import conv3x3 as conv_module
from lrcn_tpu_torch.ops.kernels import (conv3x3_relu_reference,
                                        fused_conv3x3_relu)

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# conv, kernel's plain version vs the Pallas kernel and lax.conv:
#  f32: the same operands summed in another order -> rtol = atol = 1e-4
#       (the tolerance of tests/test_pallas.py);
#  bf16: the same bf16 operands, exact products, f32 sums in another
#       order, then one rounding to bf16 -> at most one bf16 ulp apart,
#       i.e. rtol 2**-7, plus 1e-5 for sums that straddle ReLU's zero.
CONV_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# fc7, max |port - JAX| relative to max |fc7|:
#  f32: 13 convs and two matmuls in another summation order -> 1e-5;
#  bf16: JAX's plain path rounds each conv's output to bf16 BEFORE adding
#       the bias (vgg.py:_conv), the port after (the Pallas kernel's
#       order), so each of 13 layers may differ by a bf16 ulp -> 3e-2.
FC7_RTOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}

CONV_SHAPES = [(2, 8, 8, 16, 32), (1, 14, 14, 64, 64), (2, 16, 12, 8, 8),
               (1, 28, 28, 96, 40), (2, 13, 17, 5, 7)]


def _conv_inputs(shape, seed=0):
    b_dim, h, w_dim, c, f = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b_dim, h, w_dim, c)).astype(np.float32),
            (rng.standard_normal((3, 3, c, f)) * 0.1).astype(np.float32),
            (rng.standard_normal((f,)) * 0.5).astype(np.float32))


def _port_conv(fn, x, w, b, dtype, apply_relu=True):
    y = fn(torch.from_numpy(x), torch.from_numpy(w).to(dtype),
           torch.from_numpy(b), apply_relu=apply_relu)
    assert y.dtype == dtype and y.shape == x.shape[:3] + w.shape[-1:]
    return y.float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_matches_pallas_interpret(shape, dtype):
    x, w, b = _conv_inputs(shape)
    ref = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), compute_dtype=JAX_DTYPES[dtype],
                              interpret=True)).astype(np.float32)
    got = _port_conv(fused_conv3x3_relu, x, w, b, dtype)
    np.testing.assert_allclose(got, ref, **CONV_TOL[dtype])
    plain = conv3x3_relu_reference(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), dtype)
    np.testing.assert_array_equal(plain.float().numpy(), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_without_relu_matches_pallas_interpret(dtype):
    x, w, b = _conv_inputs((1, 8, 8, 8, 8), seed=1)
    ref = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), compute_dtype=JAX_DTYPES[dtype],
                              apply_relu=False, interpret=True)
                     ).astype(np.float32)
    got = _port_conv(fused_conv3x3_relu, x, w, b, dtype, apply_relu=False)
    assert got.min() < 0    # negatives survive
    np.testing.assert_allclose(got, ref, **CONV_TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 13, 17, 5, 7), (1, 28, 28, 96, 40)])
def test_conv_matches_lax_conv(shape):
    x, w, b = _conv_inputs(shape, seed=2)
    ref = jax.nn.relu(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b)
    got = _port_conv(fused_conv3x3_relu, x, w, b, torch.float32)
    np.testing.assert_allclose(got, np.asarray(ref),
                               **CONV_TOL[torch.float32])


def test_conv_casts_input_to_compute_dtype():
    """An f32 input to a bf16 conv is rounded to bf16 first
    (``conv3x3.py:85``)."""
    x, w, b = _conv_inputs((1, 6, 6, 8, 8), seed=3)
    t = lambda a: torch.from_numpy(a)
    got = fused_conv3x3_relu(t(x), t(w).bfloat16(), t(b))
    rounded = fused_conv3x3_relu(t(x).bfloat16(), t(w).bfloat16(), t(b))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, rounded)


def test_conv_validates_shapes():
    z = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError):     # C mismatch, as conv3x3.py:74-75
        fused_conv3x3_relu(z(1, 8, 8, 4), z(3, 3, 8, 8), z(8))
    with pytest.raises(ValueError):     # 5x5 filters
        fused_conv3x3_relu(z(1, 8, 8, 4), z(5, 5, 4, 8), z(8))
    with pytest.raises(ValueError):     # bias length
        fused_conv3x3_relu(z(1, 8, 8, 4), z(3, 3, 4, 8), z(7))
    with pytest.raises(ValueError):     # not NHWC
        fused_conv3x3_relu(z(8, 8, 4), z(3, 3, 4, 8), z(8))
    with pytest.raises(TypeError):
        fused_conv3x3_relu(z(1, 8, 8, 4), z(3, 3, 4, 8).double(), z(8))


def test_conv_device_tensors_never_take_the_plain_version(monkeypatch):
    """Only CPU tensors take the plain version: a CUDA tensor goes to the
    op's CUDA implementation, which raises unless it is on an sm_90 card,
    and a ``meta`` tensor to its fake implementation (shapes only)."""
    def forbidden(*args, **kwargs):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(conv_module, "conv3x3_relu_reference", forbidden)
    meta = lambda *s: torch.empty(s, device="meta")
    args = (meta(1, 8, 8, 4), meta(3, 3, 4, 8).bfloat16(), meta(8))
    before = conv_module.fused_conv3x3_relu.launches
    with pytest.raises(RuntimeError):
        conv_module.conv3x3_relu_cuda(*args)
    y = conv_module.fused_conv3x3_relu(*args)
    assert y.device.type == "meta" and y.shape == (1, 8, 8, 8)
    assert y.dtype == torch.bfloat16
    assert conv_module.fused_conv3x3_relu.launches == before


# --- the encoder ---


@pytest.fixture(scope="module")
def tiny_vgg():
    """JAX's width-scaled VGG params as numpy, with nonzero biases
    (jitted: one compile instead of one per layer shape)."""
    init = jax.jit(functools.partial(jax_vgg.init_vgg_params,
                                     width_multiplier=0.05, fc_dim=16))
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for layer in params.values():
        layer["b"] = (rng.standard_normal(layer["b"].shape) * 0.1
                      ).astype(np.float32)
    return params


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 224, 224, 3)) * 50).astype(np.float32)


def _assert_fc7_close(got, ref, dtype):
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= FC7_RTOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vgg16_fc7_matches_jax(tiny_vgg, dtype):
    img = _images(0, 2)
    ref = np.asarray(jax_vgg.vgg16_fc7(tiny_vgg, jnp.asarray(img),
                                       compute_dtype=JAX_DTYPES[dtype]))
    encoder = torch_vgg.vgg_params_from_numpy(tiny_vgg, "cpu", dtype)
    assert encoder.conv3_3_w.dtype == dtype
    assert encoder.conv3_3_b.dtype == torch.float32
    got = torch_vgg.vgg16_fc7(encoder, torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (2, 16)
    assert (got < 0).any()      # no relu7 (vgg.py:148-150)
    _assert_fc7_close(got.numpy(), ref, dtype)
    plain = torch_vgg.vgg16_fc7(encoder, torch.from_numpy(img),
                                use_kernels=False)
    assert torch.equal(plain, got)


def test_vgg16_fc7_grouped_and_l1_normalize_match_jax(tiny_vgg):
    img = _images(1, 4).reshape(2, 2, 224, 224, 3)
    ref = np.asarray(jax_vgg.vgg16_fc7_scan(tiny_vgg, jnp.asarray(img),
                                            compute_dtype=jnp.float32))
    encoder = torch_vgg.vgg_params_from_numpy(tiny_vgg, "cpu",
                                              torch.float32)
    got = torch_vgg.vgg16_fc7_grouped(encoder, torch.from_numpy(img))
    assert got.shape == (2, 2, 16)
    _assert_fc7_close(got.numpy(), ref, torch.float32)
    np.testing.assert_allclose(
        torch_vgg.l1_normalize(got).numpy(),
        np.asarray(jax_vgg.l1_normalize(jnp.asarray(got.numpy()))),
        rtol=1e-6, atol=0)


def test_vgg_params_bridge_accepts_flat_keys_and_checks_them(tiny_vgg):
    flat = {f"{layer}/{p}": v for layer, d in tiny_vgg.items()
            for p, v in d.items()}
    encoder = torch_vgg.vgg_params_from_numpy(flat, "cpu", torch.float32)
    w6 = tiny_vgg["fc6"]["w"]
    np.testing.assert_array_equal(encoder.fc6_w.numpy(),
                                  w6.reshape(-1, w6.shape[-1]))
    np.testing.assert_array_equal(encoder.conv1_1_w.numpy(),
                                  tiny_vgg["conv1_1"]["w"])
    del flat["conv4_2/b"]
    with pytest.raises(KeyError):
        torch_vgg.vgg_params_from_numpy(flat, "cpu", torch.float32)


def test_max_pool_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 6, 10, 3)
                                                 ).astype(np.float32)
    ref = np.asarray(jax_vgg._maxpool(jnp.asarray(x)))
    np.testing.assert_array_equal(
        torch_vgg.max_pool(torch.from_numpy(x)).numpy(), ref)


# --- MatConvNet import ---


def _small_vgg_layers(rng, fc_dim=24):
    """Width-scaled VGG layer weights keyed by name (order as in the .mat);
    the layout of tests/test_vgg.py."""
    weights, c_in = {}, 3
    for name in torch_vgg.CONV_NAMES:
        weights[name] = (
            rng.standard_normal((3, 3, c_in, 8)).astype(np.float32),
            rng.standard_normal((8, 1)).astype(np.float32))
        c_in = 8
    weights["fc6"] = (
        rng.standard_normal((7, 7, c_in, fc_dim)).astype(np.float32),
        rng.standard_normal((fc_dim, 1)).astype(np.float32))
    weights["fc7"] = (
        rng.standard_normal((1, 1, fc_dim, fc_dim)).astype(np.float32),
        rng.standard_normal((fc_dim, 1)).astype(np.float32))
    return weights


@pytest.mark.parametrize("release", ["beta16", "2014"])
def test_load_matconvnet_matches_jax(tmp_path, release):
    """Both release layouts: beta16+ (weights cell, meta.normalization,
    full-image averageImage) and 2014 (filters/biases fields, top-level
    normalization, per-channel averageImage)."""
    from scipy.io import savemat

    rng = np.random.default_rng(3)
    layers = []
    for name, (w, b) in _small_vgg_layers(rng).items():
        layers.append({"name": name, "type": "conv",
                       "weights": np.array([w, b], dtype=object)}
                      if release == "beta16" else
                      {"name": name, "type": "conv", "filters": w,
                       "biases": b})
        layers.append({"name": "relu" + name.split("conv")[-1],
                       "type": "relu"})
    layers.append({"name": "fc8", "type": "conv"})   # never reached
    if release == "beta16":
        norm = {"meta": {"normalization": {"averageImage": rng.standard_normal(
            (224, 224, 3)).astype(np.float32)}}}
    else:
        norm = {"normalization": {"averageImage": np.array(
            [122.0, 116.0, 104.0], np.float32).reshape(1, 1, 3)}}
    path = str(tmp_path / f"{release}.mat")
    savemat(path, {"layers": np.array(layers, dtype=object), **norm})

    ref, ref_avg = jax_vgg.load_matconvnet(path)
    got, got_avg = torch_vgg.load_matconvnet(path)
    assert set(got) == set(ref)
    for name in ref:
        for p in ("w", "b"):
            np.testing.assert_array_equal(got[name][p],
                                          np.asarray(ref[name][p]))
    assert got["fc7"]["w"].shape == (24, 24)
    np.testing.assert_array_equal(got_avg, ref_avg)
    torch_vgg.vgg_params_from_numpy(got, "cpu", torch.float32)


def test_fc6_matlab_flatten_matches_jax():
    w2 = np.random.default_rng(4).standard_normal((7 * 7 * 512, 8)
                                                  ).astype(np.float32)
    np.testing.assert_array_equal(torch_vgg._fc6_weight(w2),
                                  jax_vgg._fc6_weight(w2))
    with pytest.raises(ValueError):
        torch_vgg._fc6_weight(np.zeros((5, 8), np.float32))


# --- host image pipeline and extraction ---


@pytest.fixture(scope="module")
def png_paths(tmp_path_factory):
    """PNG files of assorted sizes and modes (both packages decode PNGs
    through PIL, so their pixels must be equal)."""
    root = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(11)
    paths = {}
    for i, (h, w, mode) in enumerate([(240, 260, "RGB"), (300, 224, "RGB"),
                                      (224, 500, "L"), (231, 257, "RGB"),
                                      (256, 256, "RGB")]):
        shape = (h, w, 3) if mode == "RGB" else (h, w)
        pixels = rng.integers(0, 256, shape).astype(np.uint8)
        path = str(root / f"img{i}.png")
        Image.fromarray(pixels, mode).save(path)
        paths[500 + i] = path
    return paths


def test_host_pipeline_matches_jax(png_paths):
    paths = list(png_paths.values())
    np.testing.assert_array_equal(torch_images.load_images(paths),
                                  jax_images.load_images(paths))
    for p in paths[:2]:
        img = torch_images.decode_image(p)
        np.testing.assert_array_equal(img, jax_images.decode_image(p))
        np.testing.assert_array_equal(torch_images.resize_crop(img),
                                      jax_images.resize_crop(img))
    avg = np.random.default_rng(2).standard_normal((224, 224, 3)
                                                   ).astype(np.float32)
    np.testing.assert_array_equal(
        torch_images.preprocess(paths[0], avg, device="cpu").numpy(),
        np.asarray(jax_images.preprocess(paths[0], avg)))
    blobs = [open(p, "rb").read() for p in paths[:2]] + [b"not an image"]
    got, ok = torch_images.load_blobs(blobs)
    ref, ref_ok = jax_images.load_blobs(blobs)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(got, ref)


def test_preprocess_defaults_to_the_card(png_paths):
    """Like the JAX counterpart, ``preprocess`` puts the image on the
    device unless asked for the CPU: with no card it raises rather than
    return a CPU tensor."""
    path = next(iter(png_paths.values()))
    avg = np.zeros((224, 224, 3), np.float32)
    if torch.cuda.is_available():
        assert torch_images.preprocess(path, avg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            torch_images.preprocess(path, avg)
    assert torch_images.preprocess(path, avg, "cpu").device.type == "cpu"


def test_extract_features_matches_jax(tiny_vgg, png_paths, tmp_path):
    """Rows against JAX's at f32, normalize=False; a ragged last batch, a
    short last group, and the final atomic flush."""
    avg = np.full((224, 224, 3), 110.0, np.float32)
    encoder = torch_vgg.vgg_params_from_numpy(tiny_vgg, "cpu",
                                              torch.float32)
    kw = dict(batch_size=2, scan_depth=2, normalize=False)
    ref = jax_images.extract_features(png_paths, tiny_vgg, avg,
                                      compute_dtype=jnp.float32, **kw)
    got = torch_images.extract_features(
        png_paths, encoder, avg, checkpoint_dir=str(tmp_path / "ckpt"), **kw)
    ids = list(png_paths)
    assert got.ids() == ref.ids() == ids and not got.normalized
    _assert_fc7_close(got.gather(ids), ref.gather(ids), torch.float32)
    flushed = TorchStore.load(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(flushed.gather(ids), got.gather(ids))


def test_extract_features_resumes_and_normalizes(tiny_vgg, png_paths):
    """Ids already in the store are skipped (lrcn.jl:203); new rows are
    L1-normalized as JAX normalizes them."""
    avg = np.zeros((224, 224, 3), np.float32)
    encoder = torch_vgg.vgg_params_from_numpy(tiny_vgg, "cpu",
                                              torch.float32)
    ids = list(png_paths)
    sentinel = np.full(16, 7.0, np.float32)
    store = TorchStore(dim=16, normalized=True)
    store.add(ids[1], sentinel)
    got = torch_images.extract_features(png_paths, encoder, avg,
                                        store=store, batch_size=3)
    assert got is store and sorted(got.ids()) == sorted(ids)
    np.testing.assert_array_equal(got.get(ids[1]), sentinel)
    rest = [i for i in ids if i != ids[1]]
    ref = jax_images.extract_features(
        {i: png_paths[i] for i in rest}, tiny_vgg, avg,
        store=FeatureStore(dim=16, normalized=True), batch_size=3,
        compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.gather(rest), ref.gather(rest),
                               rtol=1e-4, atol=1e-6)
