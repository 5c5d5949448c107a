"""lrcn_tpu_torch — the LRCN caption decoder on PyTorch and an NVIDIA H100.

A port of ``lrcn_tpu`` (JAX on a TPU), which stays the reference.  The
layout mirrors ``lrcn_tpu``, so each module's counterpart has the same
path.  This package imports ``torch`` and nothing of JAX or ``lrcn_tpu``.

Layer map:

- ``lrcn_tpu_torch.serve``    dynamic batcher + ``CaptionService``
- ``lrcn_tpu_torch.train``    decoder ``Trainer`` and joint CNN+decoder
  ``JointTrainer`` (optax's Adam and clip rules), checkpoints in the JAX
  package's format (read and written, optimizer state included), metrics
  logger
- ``lrcn_tpu_torch.decode``   batched beam / greedy search, best-of-N
  sampling, writers and eval-file helpers
- ``lrcn_tpu_torch.models``   the LRCN decoder (``LRCNDecoder`` for
  decoding, ``LRCNParams`` and the teacher-forced loss for training), the
  VGG-16 encoder (``VGGEncoder``; ``VGGParams`` for training) and the
  joint step (``models/joint.py``)
- ``lrcn_tpu_torch.ops``      plain LSTM ops; ``ops/kernels`` the CUDA
  kernels (fused LSTM step, top-k + log-sum-exp, conv3x3) and their build
- ``lrcn_tpu_torch.data``     the on-disk feature store, caption batching,
  device prefetch, images
- ``lrcn_tpu_torch.evaluation`` multi-BLEU and reference files
- ``lrcn_tpu_torch.native``   the host C++ libraries (JPEG loader, BLEU
  core), built with g++ at first use
- ``lrcn_tpu_torch.core``     vocabulary and caption tokenizer
- ``lrcn_tpu_torch.parallel`` the device mesh, batch-sharded decoding,
  data x vocabulary-parallel and pipelined training over
  ``torch.distributed`` (one rank per mesh entry)

Kernels run on CUDA tensors; on CPU tensors every kernel wrapper computes
its plain PyTorch version, which is what the CPU tests hold against JAX.
Training runs no kernel: its losses (decoder and joint) are plain PyTorch
with autograd.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# the kernels are compiled for sm_90a (Hopper) only
KERNEL_CAPABILITY = (9, 0)


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``, with the current CUDA device's
    index filled in for a bare ``"cuda"``, so that devices compare equal
    to the ones tensors report."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


_verified: set[torch.device] = set()   # devices that passed require_cuda


def require_cuda(device) -> torch.device:
    """Return ``device`` as a ``torch.device``; raise unless it is a CUDA
    device on an sm_90 card, which the kernels are built for.  A device
    with an index that passed once is not queried again (a card's
    capability does not change): the kernel wrappers call this on every
    launch."""
    device = torch.device(device)
    if device in _verified:
        return device
    if device.type != "cuda":
        raise RuntimeError(f"the CUDA kernels need a CUDA device, got "
                           f"{device}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no CUDA "
                           "device for the kernels")
    capability = torch.cuda.get_device_capability(device)
    if capability != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} is sm_{capability[0]}"
            f"{capability[1]}; the kernels are built for sm_90a")
    if device.index is not None:
        _verified.add(device)
    return device
