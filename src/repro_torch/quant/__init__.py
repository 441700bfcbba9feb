"""Weight quantization of the port: quantized linears and tree
quantization (``qops.py``), and the calibration algorithms whose scales
``quantize_tree(calib=)`` folds (``calibrate.py``)."""
from repro_torch.quant.qops import (QUANT_TARGETS, memory_bytes,
                                    quantize_linear, quantize_tree,
                                    quantized_matmul)

__all__ = ["QUANT_TARGETS", "memory_bytes", "quantize_linear",
           "quantize_tree", "quantized_matmul"]
