"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a wrapper that dispatches on the tensors' device
(``ops.py``).  ``build.py`` compiles ``csrc/`` with nvcc."""


def launch_counts() -> dict:
    """Each kernel's launches in this process so far, by the name of the
    TPU function it ports (the wrappers' counters: a wrapper adds one
    where it launches its kernel and nowhere else)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.wkv6 import ops as wops
    return {"paged_attention": pops.launches,
            "flash_attention": fops.launches,
            "paged_prefix_extend": pops.extend_launches,
            "int8_matmul": qmm.launches,
            "w8a8_decode_matmul": qmm.decode_launches,
            "fp8_decode_matmul": qmm.fp8_launches,
            "rmsnorm": rops.launches,
            "wkv6": wops.launches}
