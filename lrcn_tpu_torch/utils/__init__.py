from lrcn_tpu_torch.utils.profiling import span, trace

__all__ = ["span", "trace"]
