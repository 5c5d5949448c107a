from lrcn_tpu_torch.data.batcher import (  # noqa: F401
    Batch,
    bucket_batches,
    equal_length_batches,
    epoch_order,
)
from lrcn_tpu_torch.data.feature_store import (  # noqa: F401
    FeatureStore,
    l1_normalize,
)
from lrcn_tpu_torch.data.pipeline import prefetch_to_device  # noqa: F401
