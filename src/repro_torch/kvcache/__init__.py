"""KV-cache subsystem of the port: CacheSpec plus allocation, writes and
views (bf16, int8 and fp8 page pools; see ``cache.py``)."""
from repro_torch.kvcache.cache import (alloc_contiguous, alloc_paged,
                                       decode_write, kv_views,
                                       paged_scatter_prefill, paged_views,
                                       paged_write_batch, pool_bytes,
                                       prefill_write)
from repro_torch.kvcache.quant import (dequantize, quantize,
                                       quantize_with_scale, requantize)
from repro_torch.kvcache.spec import (ELEM_BYTES, FP8, QMAX, STORE_DTYPES,
                                      CacheSpec, cache_kv_heads,
                                      kv_bytes_per_token, normalize_dtype,
                                      paged_pool_shape)

__all__ = ["CacheSpec", "ELEM_BYTES", "FP8", "QMAX", "STORE_DTYPES",
           "alloc_contiguous", "alloc_paged", "cache_kv_heads", "decode_write",
           "dequantize", "kv_bytes_per_token", "kv_views", "normalize_dtype",
           "paged_pool_shape", "paged_scatter_prefill", "paged_views",
           "paged_write_batch", "pool_bytes", "prefill_write", "quantize",
           "quantize_with_scale", "requantize"]
