"""Build the package's CUDA kernels with ``nvcc``, bind them with ctypes and
register each as a ``torch.library`` op.

Every ``csrc/*.cu`` file (with the shared ``csrc/*.cuh`` headers)
compiles, at first use, into one shared library with a plain C interface
under ``build/lrcn_tpu_torch/`` at the root of the checkout: one ``nvcc
-c`` per source, all started together, then one link.  The library's name
carries a hash of the sources and the flags, so an edited kernel rebuilds
and an unchanged one loads from the cache.
``nvcc``'s report (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<name>.log``.

Each kernel is the op ``lrcn::<name>`` (``define_op``): a CPU
implementation (the plain version), a CUDA implementation (the launch
through the library) and a fake one (shapes and dtypes only, for
``torch.export`` and the ``meta`` device).  The ops are registered in
Python on the dispatcher's lower-level ``torch.library.Library``, not
through ``torch.library.custom_op``, whose Python wrapper costs more host
time a launch.

Importing this module needs neither ``nvcc`` nor a GPU: the CPU tests
import every module of the package.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "lrcn_tpu_torch"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes; every entry point returns cudaGetLastError()
SIGNATURES = {
    # x, h, c, w, b, h_out, c_out, B, X, H, grid, route, stream
    "lrcn_lstm_step": [_P] * 7 + [_I] * 5 + [_P],
    # logits, vals, idx, lse, R, V, k, route, stream
    "lrcn_topk_lse": [_P] * 4 + [_I] * 4 + [_P],
    # x, w, b, y, B, H, W, C, F, relu, route, stream
    "lrcn_conv3x3": [_P] * 4 + [_I] * 7 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

NAMESPACE = "lrcn"
_ops = torch.library.Library(NAMESPACE, "FRAGMENT")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"liblrcn_tpu_torch_{digest.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands concurrently; (cmd, returncode, output) each."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    try:
        outs = [proc.communicate()[0] for proc in procs]
        return [(cmd, proc.returncode, out)
                for cmd, proc, out in zip(cmds, procs, outs)]
    finally:
        for proc in procs:      # only after an exception: stop the rest
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build() -> Path:
    """Compile the kernels unless the cached library for these sources
    exists; return its path.  Raises with nvcc's output on failure."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    work = Path(tempfile.mkdtemp(prefix=f"{path.stem}.", dir=BUILD_DIR))
    try:
        cu = [src for src in sources() if src.suffix == ".cu"]
        objs = [str(work / f"{src.stem}.o") for src in cu]
        results = _run_all([[nvcc, *COMPILE_FLAGS, "-o", obj, str(src)]
                            for src, obj in zip(cu, objs)])
        tmp = work / path.name
        if all(rc == 0 for _, rc, _ in results):
            results += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *objs]])
        log = "".join(" ".join(cmd) + "\n" + out for cmd, _, out in results)
        path.with_suffix(".log").write_text(log)
        failed = [rc for _, rc, _ in results if rc != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        os.replace(tmp, path)   # atomic: no reader sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


@contextlib.contextmanager
def on_device(device: torch.device):
    """Make ``device`` (a CUDA device with an index) the current CUDA
    device; yield the handle of its current stream, on which a C entry
    point launches.  Where it is current already, nothing is switched and
    the handle is read as an int directly (what ``current_stream(device)
    .cuda_stream`` gives, without building a Stream object): this runs on
    every launch."""
    if torch.cuda.current_device() == device.index:
        yield torch._C._cuda_getCurrentRawStream(device.index)
        return
    with torch.cuda.device(device):
        yield torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device: the most blocks a
    persistent kernel keeps in flight, one an SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(status: int, name: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def define_op(schema: str, *, cpu, cuda, fake) -> torch._ops.OpOverload:
    """Define the op ``lrcn::<schema>`` with its CPU, CUDA and fake
    implementations; return its overload, which the wrapper calls."""
    name = schema.split("(", 1)[0]
    _ops.define(schema)
    _ops.impl(name, cpu, "CPU")
    _ops.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_ops)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
