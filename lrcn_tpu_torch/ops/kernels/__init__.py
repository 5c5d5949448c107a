"""Hand-written CUDA kernels for sm_90a, one wrapper module each, plus the
``nvcc`` build (``build.py``).  Each kernel is a ``torch.library`` op
(``lrcn::lstm_step``, ``lrcn::topk_lse``, ``lrcn::conv3x3_relu``), which
importing this package registers; every wrapper calls its op, keeps its
plain PyTorch version beside it and counts its launches in
``<wrapper>.launches`` (``launches.py``: once a call, whether the call
launched eagerly or replayed a captured CUDA graph)."""

from lrcn_tpu_torch.ops.kernels.conv3x3 import (  # noqa: F401
    conv3x3_relu_reference,
    fused_conv3x3_relu,
)
from lrcn_tpu_torch.ops.kernels.lstm_step import (  # noqa: F401
    fused_lstm_step,
    lstm_step_reference,
)
from lrcn_tpu_torch.ops.kernels.topk_lse import (  # noqa: F401
    topk_logsumexp,
    topk_logsumexp_reference,
)
