"""Plain PyTorch references that decide ``correct``.

They follow the published models (LRCN: Donahue et al., arXiv:1411.4389,
and the reference implementation ``lrcn.jl``; VGG-16: arXiv:1409.1556)
in float32 with TF32 off, one operation at a time, and import nothing of
``lrcn_tpu_torch``, ``lrcn_tpu`` or ``jax``.  Every function takes an
optional ``quant``, applied to the operands of every product and to its
cotangent: the lower-precision control (``precision.py``).
"""
