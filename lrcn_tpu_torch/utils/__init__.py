from lrcn_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace"]
