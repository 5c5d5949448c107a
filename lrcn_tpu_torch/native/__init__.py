"""Native (C++) host libraries, loaded with ctypes (counterpart of
``lrcn_tpu/native/__init__.py``, for the two libraries the port uses).

- ``imageloader.cpp``: threaded JPEG decode + shortest-side-224 resize +
  center crop (libjpeg), the first decoder of ``data/images.py``;
- ``bleu.cpp``: the multi-bleu statistics core of ``evaluation/bleu.py``.

Both sources are byte-identical copies of the JAX package's, so the two
packages decode the same pixels and count the same n-grams.  They are
host code, not device kernels: each builds at first use with ``g++ -O3
-std=c++17 -shared -fPIC`` into ``build/lrcn_tpu_torch/native/`` at the
root of the checkout, under a name that carries a hash of the source and
the flags.  Where a library cannot be built or loaded (no compiler, no
libjpeg) its accessor returns None and the caller takes its pure-Python
path, as in the JAX package; ``LRCN_NATIVE=0`` disables both.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[1] / "build" / "lrcn_tpu_torch" / "native"

COMPILE_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LINK_FLAGS = {"imageloader": ("-ljpeg", "-pthread"), "bleu": ()}

_lock = threading.Lock()
_cache: dict[str, ctypes.CDLL | None] = {}


def native_enabled() -> bool:
    return os.environ.get("LRCN_NATIVE", "1") != "0"


def library_path(name: str) -> Path:
    """Where ``lib<name>.so`` for the current source and flags lives."""
    flags = COMPILE_FLAGS + LINK_FLAGS[name]
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update((SOURCE_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path | None:
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *COMPILE_FLAGS, "-o", str(tmp),
           str(SOURCE_DIR / f"{name}.cpp"), *LINK_FLAGS[name]]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)    # atomic: no reader sees half a file
    return lib


def load_library(name: str) -> ctypes.CDLL | None:
    """Build (if needed) and load ``lib<name>.so``; None if unavailable."""
    if not native_enabled():
        return None
    with _lock:
        if name not in _cache:
            path = _build(name)
            lib = None
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:
                    lib = None
            _cache[name] = lib
        return _cache[name]


def imageloader_library() -> ctypes.CDLL | None:
    """The threaded JPEG loader with argtypes configured, or None."""
    lib = load_library("imageloader")
    if lib is None:
        return None
    if not getattr(lib, "_lrcn_configured", False):
        lib.lrcn_load_images.restype = ctypes.c_int
        lib.lrcn_load_images.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.lrcn_load_images_mem.restype = ctypes.c_int
        lib.lrcn_load_images_mem.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(
                ctypes.c_longlong), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib._lrcn_configured = True
    return lib


def bleu_library() -> ctypes.CDLL | None:
    """The BLEU core with argtypes configured, or None."""
    lib = load_library("bleu")
    if lib is None:
        return None
    if not getattr(lib, "_lrcn_configured", False):
        lib.lrcn_bleu_stats_new.restype = ctypes.c_void_p
        lib.lrcn_bleu_stats_free.argtypes = [ctypes.c_void_p]
        lib.lrcn_bleu_accumulate.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int]
        lib.lrcn_bleu_get.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_longlong)]
        lib._lrcn_configured = True
    return lib
