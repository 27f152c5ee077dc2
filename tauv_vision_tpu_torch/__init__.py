"""PyTorch / CUDA port of ``tauv_vision_tpu`` for one NVIDIA Hopper card.

Mirrors the JAX package's layout (``ops``, ``models``, ``serving``) so
each module's counterpart is easy to find.  It imports ``torch`` and
``numpy`` and never JAX; from the JAX package it reads only the JAX-free
``tauv_vision_tpu.configs`` and ``tauv_vision_tpu.eval.detection_eval``.

The kernels that the JAX package wrote in Pallas are CUDA C++ under
``csrc/``, built and loaded by ``kernels.py``.  Each has a plain PyTorch
version beside its wrapper: the wrapper takes the plain version for a
tensor on the CPU and launches the kernel (or raises) for a CUDA tensor.
"""
