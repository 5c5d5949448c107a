from lrcn_tpu_torch.train.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from lrcn_tpu_torch.train.metrics import MetricsLogger  # noqa: F401
from lrcn_tpu_torch.train.trainer import Trainer  # noqa: F401


def __getattr__(name: str):
    # ``JointTrainer`` loads on first use: its module imports
    # ``models/joint.py``, which imports this package's trainer
    if name == "JointTrainer":
        from lrcn_tpu_torch.train.joint import JointTrainer
        return JointTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
