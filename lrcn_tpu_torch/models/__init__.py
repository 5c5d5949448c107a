from lrcn_tpu_torch.models import lrcn, moe_text, vgg  # noqa: F401
from lrcn_tpu_torch.models.lrcn import (  # noqa: F401
    LRCNDecoder,
    LRCNParams,
    init_params,
    params_from_numpy,
)
from lrcn_tpu_torch.models.moe_text import MoETextDecoder  # noqa: F401
from lrcn_tpu_torch.models.vgg import (  # noqa: F401
    VGGEncoder,
    vgg_params_from_numpy,
)
