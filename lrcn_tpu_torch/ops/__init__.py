from lrcn_tpu_torch.ops.lstm import (  # noqa: F401
    lstm_cell_update,
    lstm_recurrent_gates,
    lstm_step,
    matmul,
)
