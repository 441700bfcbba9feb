"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a wrapper that dispatches on the tensors' device
(``ops.py``).  ``build.py`` compiles ``csrc/`` with nvcc."""
