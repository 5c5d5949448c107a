"""Online serving: dynamic batching onto the CUDA decode path, and the
HTTP front ends: ``make_server`` (Python) and ``native_frontend`` (C++)."""

from lrcn_tpu_torch.serve.batcher import (  # noqa: F401
    BatcherOverloaded,
    BatcherStats,
    DynamicBatcher,
)
from lrcn_tpu_torch.serve.http import make_server  # noqa: F401
from lrcn_tpu_torch.serve.service import CaptionService  # noqa: F401


def native_frontend(*args, **kwargs):
    """Construct the C++ HTTP front end (``serve/native_http.py``); raises
    if the native library cannot be built or loaded."""
    from lrcn_tpu_torch.serve.native_http import NativeFrontend
    return NativeFrontend(*args, **kwargs)
