"""Image preprocessing and batched fc7 extraction (counterpart of
``lrcn_tpu/data/images.py``).

Host half, copied from the JAX module: decode (optionally downloading a
URL, lrcn.jl:751-754), resize so the SHORTEST side is 224 with the
reference's integer arithmetic ``(dim * 224) ÷ min(dims)`` (lrcn.jl:756),
center-crop 224x224 (:757-759), grayscale -> 3 channels (:761-763).
JPEGs decode first through the threaded C++ loader
(``lrcn_tpu_torch/native/imageloader.cpp``, a byte-identical copy of the
JAX package's), and a row it cannot decode is rescued through PIL, as in
the JAX module; so both packages give the same pixels for every file.
Other formats (PNG, ...), and every file when the loader is unavailable
(no libjpeg, ``LRCN_NATIVE=0``), decode through PIL.  PIL is imported
inside the functions that use it, so importing this module needs no PIL.

Device half: uint8 -> float32, minus the mean image (lrcn.jl:771), then
VGG-16 to fc7, over groups of batches with one upload and one readback
per group (``normalize_and_fc7``, the counterpart of
``_normalize_and_fc7_scan``), and the service's encoder batch
(``images_to_fc7``: normalize, fc7, L1-normalize).  On a card each call
of either, from the second of a shape on, is one replay of the CUDA
graph captured for that shape (``utils/graphs.py``), as JAX jits both.  Images stay (H, W, 3) NHWC end
to end.
"""

from __future__ import annotations

import functools
import os
import tempfile
import urllib.request
from typing import Sequence

import numpy as np
import torch

from lrcn_tpu_torch import require_cuda
from lrcn_tpu_torch.data.feature_store import FeatureStore, l1_normalize
from lrcn_tpu_torch.models import vgg
from lrcn_tpu_torch.models.vgg import VGGEncoder, vgg16_fc7_fn
from lrcn_tpu_torch.utils import graphs
from lrcn_tpu_torch.utils.profiling import span

CROP = 224


def decode_image(path_or_url: str) -> np.ndarray:
    """Decode an image file (or URL) to (H, W, 3) uint8 RGB.

    Reference: download at lrcn.jl:752-754, load at :755, grayscale
    promotion at :761-763.
    """
    from PIL import Image

    path = path_or_url
    if "://" in path_or_url:
        suffix = os.path.splitext(path_or_url.split("?")[0])[1] or ".jpg"
        fd, path = tempfile.mkstemp(suffix=suffix)
        os.close(fd)
        urllib.request.urlretrieve(path_or_url, path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def resize_crop(image: np.ndarray) -> np.ndarray:
    """Shortest-side-224 resize + center crop -> (224, 224, 3) uint8.

    Uses the reference's integer resize arithmetic (lrcn.jl:756) and crop
    offsets (lrcn.jl:757-759).
    """
    from PIL import Image

    h, w = image.shape[:2]
    m = min(h, w)
    new_h, new_w = (h * CROP) // m, (w * CROP) // m
    im = Image.fromarray(image).resize((new_w, new_h), Image.BILINEAR)
    arr = np.asarray(im, np.uint8)
    i0 = (new_h - CROP) // 2
    j0 = (new_w - CROP) // 2
    return arr[i0:i0 + CROP, j0:j0 + CROP]


def load_batch_native(paths: Sequence[str], n_threads: int | None = None
                      ) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode+resize+crop a batch of JPEGs with the C++ threaded loader.

    Returns (images (N,224,224,3) uint8, ok (N,) bool) or None when the
    native library is unavailable.  Rows whose decode failed are zeroed and
    flagged; callers fall back to PIL for those.
    """
    import ctypes

    from lrcn_tpu_torch.native import imageloader_library

    lib = imageloader_library()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    n = len(paths)
    out = np.zeros((n, CROP, CROP, 3), np.uint8)
    status = (ctypes.c_int * n)()
    c_paths = (ctypes.c_char_p * n)(
        *[os.fsencode(p) for p in paths])
    lib.lrcn_load_images(
        c_paths, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), status,
        n_threads)
    ok = np.asarray(status[:], np.int32) == 0
    return out, ok


def decode_blobs_native(blobs: Sequence[bytes],
                        n_threads: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray] | None:
    """Decode+resize+crop encoded JPEG blobs with the C++ threaded
    loader, from memory.  Returns (images (N,224,224,3) uint8, ok (N,)
    bool) or None when the native library is unavailable."""
    import ctypes

    from lrcn_tpu_torch.native import imageloader_library

    lib = imageloader_library()
    if lib is None:
        return None
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    n = len(blobs)
    out = np.zeros((n, CROP, CROP, 3), np.uint8)
    status = (ctypes.c_int * n)()
    c_blobs = (ctypes.c_char_p * n)(*blobs)
    sizes = (ctypes.c_longlong * n)(*[len(b) for b in blobs])
    lib.lrcn_load_images_mem(
        c_blobs, sizes, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), status,
        n_threads)
    ok = np.asarray(status[:], np.int32) == 0
    return out, ok


def load_blobs(blobs: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Encoded image blobs -> ((N,224,224,3) uint8, ok (N,) bool).

    Threaded native JPEG decode first, PIL rescue per failed row (PNG
    and other formats); ok[i] is False only when both fail, and that row
    stays zero.  ``CaptionService.caption_image_bytes`` runs through
    here."""
    import io

    from PIL import Image

    n = len(blobs)
    native = decode_blobs_native(blobs)
    if native is not None:
        imgs, ok = native
    else:
        imgs = np.zeros((n, CROP, CROP, 3), np.uint8)
        ok = np.zeros(n, bool)
    for idx in np.flatnonzero(~ok):
        try:
            with Image.open(io.BytesIO(blobs[idx])) as im:
                imgs[idx] = resize_crop(
                    np.asarray(im.convert("RGB"), np.uint8))
            ok[idx] = True
        except Exception:   # noqa: BLE001 — bad bytes stay flagged
            pass
    return imgs, ok


def load_preprocessed(path: str) -> np.ndarray:
    """One image -> (224,224,3) uint8: native JPEG fast path, PIL fallback."""
    if path.lower().endswith((".jpg", ".jpeg")):
        native = load_batch_native([path])
        if native is not None and native[1][0]:
            return native[0][0]
    return resize_crop(decode_image(path))


def load_images(paths: Sequence[str]) -> np.ndarray:
    """Decode+resize+crop a batch -> (N, 224, 224, 3) uint8.

    Native threaded JPEG loader when every path is a JPEG, with PIL
    rescue for rows whose native decode fails; plain PIL otherwise.
    """
    if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths):
        native = load_batch_native(paths)
        if native is not None:
            imgs, ok = native
            for idx in np.flatnonzero(~ok):   # PIL rescue per failure
                imgs[idx] = resize_crop(decode_image(paths[idx]))
            return imgs
    return np.stack([resize_crop(decode_image(p)) for p in paths])


def normalize_batch(images_u8: torch.Tensor, average_image: torch.Tensor
                    ) -> torch.Tensor:
    """(B, 224, 224, 3) uint8 -> float32, 255-scale minus mean image.

    The reference loads 0..1 floats and computes ``255 * x - avg``
    (lrcn.jl:771); uint8 pixels are already 255-scaled.
    """
    return images_u8.float() - average_image


def preprocess(path_or_url: str, average_image: np.ndarray,
               device="cuda") -> torch.Tensor:
    """Single-image pipeline -> (1, 224, 224, 3) float32 on ``device``:
    the card unless the caller asks for the CPU, as the JAX counterpart
    returns a device array.  Raises for "cuda" where there is no card."""
    device = torch.device(device)
    if device.type == "cuda":
        device = require_cuda(device)
    img = torch.tensor(resize_crop(decode_image(path_or_url))[None])
    avg = torch.tensor(np.asarray(average_image, np.float32))
    return normalize_batch(img.to(device), avg.to(device))


def normalize_and_fc7(encoder: VGGEncoder, images_u8: torch.Tensor,
                      average_image: torch.Tensor,
                      use_kernels: bool = True) -> torch.Tensor:
    """(K, B, 224, 224, 3) uint8 -> (K, B, F7) fc7, on the encoder's device.

    The 255-scale/mean-subtract preprocessing (lrcn.jl:771) runs on the
    device batch by batch, and the K batches go back to back with no host
    sync: the caller uploads once and reads back once per K*B images.  On
    a card with ``use_kernels`` the K batches are one graph replay.
    """
    body = functools.partial(_normalize_and_fc7_fn, encoder,
                             use_kernels=use_kernels)
    return graphs.run(encoder, ("normalize_fc7",), body,
                      (images_u8, average_image), graph=use_kernels)


def _normalize_and_fc7_fn(encoder: VGGEncoder, images_u8: torch.Tensor,
                          average_image: torch.Tensor,
                          use_kernels: bool = True) -> torch.Tensor:
    return torch.stack([vgg16_fc7_fn(encoder,
                                     normalize_batch(batch, average_image),
                                     use_kernels)
                        for batch in images_u8])


def images_to_fc7(encoder: VGGEncoder, images_u8: torch.Tensor,
                  average_image: torch.Tensor) -> torch.Tensor:
    """(B, 224, 224, 3) uint8 -> (B, F7) L1-normalized fc7 rows: the
    service's encoder batch, exactly the reference's live path
    (``normalize_batch``, VGG-16 to fc7, ``input/sum(input)``,
    lrcn.jl:597), on the encoder's device.  On a card, one graph replay.
    """
    return graphs.run(encoder, ("images_fc7",),
                      functools.partial(_images_to_fc7_fn, encoder),
                      (images_u8, average_image))


def _images_to_fc7_fn(encoder: VGGEncoder, images_u8: torch.Tensor,
                      average_image: torch.Tensor) -> torch.Tensor:
    return vgg.l1_normalize(vgg16_fc7_fn(
        encoder, normalize_batch(images_u8, average_image)))


def extract_features(
    image_paths: dict[int, str],
    encoder: VGGEncoder,
    average_image: np.ndarray,
    *,
    store: FeatureStore | None = None,
    batch_size: int = 64,
    normalize: bool = True,
    scan_depth: int = 8,
    checkpoint_dir: str | None = None,
    flush_every: int = 8,
) -> FeatureStore:
    """Batched fc7 extraction into a FeatureStore (lrcn.jl:190-221).

    Semantics of the JAX ``extract_features``: resumable (ids already in
    ``store`` are skipped, lrcn.jl:203); the last partial batch is padded
    to ``batch_size``; ``scan_depth`` batches go to the device as one
    group (one upload, one readback); a depth-1 host thread decodes group
    N+1 while the device runs group N.  With ``checkpoint_dir``, an atomic
    snapshot (:meth:`FeatureStore.save_atomic`) lands every
    ``flush_every`` groups and once at the end.  The compute dtype is the
    encoder's.

    Spans (``utils/profiling.py:span``): ``lrcn.extract`` around the
    call; inside it, for each group, ``lrcn.extract.wait_decode`` (the
    prefetched decode's ``result()``), ``lrcn.extract.upload``
    (the pixels to the device), ``lrcn.extract.readback`` (the fc7 call
    and its copy to the host) and ``lrcn.extract.store`` (L1
    normalization and the store's ``add``s).
    """
    from concurrent.futures import ThreadPoolExecutor

    with span("lrcn.extract"):
        todo = (store.missing(image_paths) if store is not None
                else list(dict.fromkeys(int(i) for i in image_paths)))
        if store is not None:
            store.reserve(len(todo))
        device = encoder.device
        avg = torch.from_numpy(np.asarray(average_image, np.float32)
                               ).to(device)

        def load_host_batch(ids: list) -> np.ndarray:
            imgs = load_images([image_paths[i] for i in ids])
            pad = batch_size - len(ids)
            if pad:
                imgs = np.concatenate(
                    [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
            return imgs

        def load_host_group(id_batches: list[list]) -> np.ndarray:
            return np.stack([load_host_batch(ids) for ids in id_batches])

        id_batches = [todo[s:s + batch_size]
                      for s in range(0, len(todo), batch_size)]
        id_groups = [id_batches[s:s + scan_depth]
                     for s in range(0, len(id_batches), scan_depth)]
        with ThreadPoolExecutor(max_workers=1) as pool:
            # depth-1 prefetch: exactly one in-flight decode future
            next_future = (pool.submit(load_host_group, id_groups[0])
                           if id_groups else None)
            for gi, group in enumerate(id_groups):
                with span("lrcn.extract.wait_decode"):
                    imgs = next_future.result()
                next_future = (
                    pool.submit(load_host_group, id_groups[gi + 1])
                    if gi + 1 < len(id_groups) else None)
                with span("lrcn.extract.upload"):
                    imgs = torch.from_numpy(imgs).to(device)
                with span("lrcn.extract.readback"):
                    group_feats = normalize_and_fc7(encoder, imgs, avg
                                                    ).cpu().numpy()
                with span("lrcn.extract.store"):
                    for ids, feats in zip(group, group_feats):
                        feats = feats[:len(ids)]
                        if normalize:
                            feats = l1_normalize(feats)
                        # the store's dim comes from the encoder's output
                        if store is None:
                            store = FeatureStore(dim=feats.shape[-1],
                                                 normalized=normalize)
                            store.reserve(len(todo))
                        for i, f in zip(ids, feats):
                            store.add(i, f)
                if (checkpoint_dir is not None and flush_every > 0
                        and (gi + 1) % flush_every == 0
                        and gi + 1 < len(id_groups)):
                    store.save_atomic(checkpoint_dir)
        if store is None:
            store = FeatureStore(normalized=normalize)
        if checkpoint_dir is not None:
            store.save_atomic(checkpoint_dir)
        return store
