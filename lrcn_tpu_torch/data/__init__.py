from lrcn_tpu_torch.data.feature_store import (  # noqa: F401
    FeatureStore,
    l1_normalize,
)
