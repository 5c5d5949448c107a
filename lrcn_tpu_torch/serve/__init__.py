"""Online serving: dynamic batching onto the CUDA decode path, and the
HTTP front end (``make_server``)."""

from lrcn_tpu_torch.serve.batcher import (  # noqa: F401
    BatcherOverloaded,
    BatcherStats,
    DynamicBatcher,
)
from lrcn_tpu_torch.serve.http import make_server  # noqa: F401
from lrcn_tpu_torch.serve.service import CaptionService  # noqa: F401
