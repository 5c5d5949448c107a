from lrcn_tpu_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from lrcn_tpu_torch.train.joint import (  # noqa: F401
    identity_average_image,
    is_joint_checkpoint,
)
from lrcn_tpu_torch.train.metrics import MetricsLogger  # noqa: F401
from lrcn_tpu_torch.train.trainer import Trainer  # noqa: F401
