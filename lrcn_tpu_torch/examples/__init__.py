"""Runnable examples of the port, the counterparts of the repository's
``examples/`` scripts:

    python -m lrcn_tpu_torch.examples.synthetic_end_to_end [--device cuda|cpu] [workdir]
    python -m lrcn_tpu_torch.examples.serving_quickstart [--device cuda|cpu]

Each runs on the card unless the caller asks for the CPU; a CUDA device
that is not there raises (``require_cuda``), nothing falls back to the
CPU.
"""
