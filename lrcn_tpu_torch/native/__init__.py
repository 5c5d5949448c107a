"""Native (C++) host code, built with g++ at first use (counterpart of
``lrcn_tpu/native/__init__.py``).

- ``imageloader.cpp``: threaded JPEG decode + shortest-side-224 resize +
  center crop (libjpeg), the first decoder of ``data/images.py``;
- ``bleu.cpp``: the multi-bleu statistics core of ``evaluation/bleu.py``;
- ``httpserve.cpp``: the HTTP front end of ``serve/native_http.py``
  (accept, parse, queue and respond in C++ threads; Python enters once
  per coalesced batch);
- ``loadgen.cpp``: a standalone closed- and open-loop HTTP load
  generator, an executable run as a subprocess so that the client's
  threads never share the server's interpreter.

All four sources are byte-identical copies of the JAX package's, so the
two packages decode the same pixels, count the same n-grams and speak the
same HTTP.  They are host code, not device kernels: each builds at first
use into ``build/lrcn_tpu_torch/native/`` at the root of the checkout,
under a name that carries a hash of the source and the flags, through a
temporary file and ``os.replace``.  Where something cannot be built or
loaded (no compiler, no libjpeg) its accessor returns None: the image
loader's and BLEU's callers take their pure-Python paths, as in the JAX
package, while the native front end refuses to start.  ``LRCN_NATIVE=0``
disables all four.
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
LINK_FLAGS = {"imageloader": ("-ljpeg", "-pthread"), "bleu": (),
              "httpserve": ("-pthread",)}
LOADGEN_FLAGS = ("-O2", "-std=c++17", "-pthread")

_lock = threading.Lock()
_build_locks: dict[str, threading.Lock] = {}
_cache: dict[str, ctypes.CDLL | None] = {}


def native_enabled() -> bool:
    return os.environ.get("LRCN_NATIVE", "1") != "0"


def _hashed(name: str, flags: tuple[str, ...], pattern: str) -> Path:
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update((SOURCE_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / pattern.format(digest.hexdigest()[:16])


def library_path(name: str) -> Path:
    """Where ``lib<name>.so`` for the current source and flags lives."""
    return _hashed(name, COMPILE_FLAGS + LINK_FLAGS[name],
                   f"lib{name}_{{}}.so")


def loadgen_path() -> Path:
    """Where the load generator for the current source and flags lives."""
    return _hashed("loadgen", LOADGEN_FLAGS, "lrcn_loadgen_{}")


def _compile(source: str, target: Path, flags: tuple[str, ...],
             libs: tuple[str, ...] = ()) -> Path | None:
    """``g++ flags -o target source libs`` unless ``target`` exists; the
    compiler writes a temporary file that replaces ``target`` whole."""
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-o", str(tmp), str(SOURCE_DIR / source), *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, target)    # atomic: no reader sees half a file
    return target


def _build_lock(name: str) -> threading.Lock:
    """One lock per build: different targets compile at the same time."""
    with _lock:
        return _build_locks.setdefault(name, threading.Lock())


def load_library(name: str) -> ctypes.CDLL | None:
    """Build (if needed) and load ``lib<name>.so``; None if unavailable."""
    if not native_enabled():
        return None
    with _build_lock(name):
        if name not in _cache:
            path = _compile(f"{name}.cpp", library_path(name),
                            COMPILE_FLAGS, LINK_FLAGS[name])
            lib = None
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:
                    lib = None
            _cache[name] = lib
        return _cache[name]


def loadgen_binary() -> str | None:
    """Build (if needed) the load generator; its path, or None.

    An executable, not a library: the load must come from outside this
    process (and outside Python) for a serving measurement to time the
    server rather than the client (``loadgen.cpp``'s header)."""
    if not native_enabled():
        return None
    with _build_lock("loadgen"):
        path = _compile("loadgen.cpp", loadgen_path(), LOADGEN_FLAGS)
    return None if path is None else str(path)


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


def httpserve_library() -> ctypes.CDLL | None:
    """The native HTTP front end with argtypes configured, or None."""
    lib = load_library("httpserve")
    if lib is None:
        return None
    if not getattr(lib, "_lrcn_configured", False):
        LL = ctypes.c_longlong
        lib.lrcn_serve_start.restype = ctypes.c_void_p
        lib.lrcn_serve_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
        lib.lrcn_serve_port.restype = ctypes.c_int
        lib.lrcn_serve_port.argtypes = [ctypes.c_void_p]
        lib.lrcn_serve_next.restype = ctypes.c_int
        lib.lrcn_serve_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(LL), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.lrcn_serve_set_feature_dim.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.lrcn_serve_set_image_support.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.lrcn_serve_next_image.restype = LL
        lib.lrcn_serve_next_image.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(ctypes.c_char), LL, ctypes.c_int]
        lib.lrcn_serve_respond.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
        lib.lrcn_serve_set_vocab.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int]
        lib.lrcn_serve_set_id_rows.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL), LL]
        lib.lrcn_serve_ready.argtypes = [ctypes.c_void_p]
        lib.lrcn_serve_respond_tokens.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(LL), ctypes.POINTER(LL),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.lrcn_serve_error.argtypes = [ctypes.c_void_p, LL,
                                         ctypes.c_int, ctypes.c_char_p]
        lib.lrcn_serve_stop.argtypes = [ctypes.c_void_p]
        lib._lrcn_configured = True
    return lib
