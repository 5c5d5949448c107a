from lrcn_tpu_torch.train.checkpoint import load_checkpoint  # noqa: F401
from lrcn_tpu_torch.train.joint import (  # noqa: F401
    identity_average_image,
    is_joint_checkpoint,
)
