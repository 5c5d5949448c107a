"""Online serving: dynamic batching onto the CUDA decode path."""

from lrcn_tpu_torch.serve.batcher import (  # noqa: F401
    BatcherOverloaded,
    BatcherStats,
    DynamicBatcher,
)
from lrcn_tpu_torch.serve.service import CaptionService  # noqa: F401
