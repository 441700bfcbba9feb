"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Imports torch, numpy and the standard library only; the JAX package
(``repro``) is the reference the port's tests hold it against.
"""
