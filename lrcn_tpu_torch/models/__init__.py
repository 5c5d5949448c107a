from lrcn_tpu_torch.models import lrcn  # noqa: F401
from lrcn_tpu_torch.models.lrcn import (  # noqa: F401
    LRCNDecoder,
    params_from_numpy,
)
