"""KV-cache subsystem of the port: CacheSpec plus allocation, writes and
views (bf16 pools; see ``cache.py``)."""
from repro_torch.kvcache.cache import (alloc_contiguous, alloc_paged,
                                       paged_scatter_prefill, paged_views,
                                       paged_write_batch, prefill_write)
from repro_torch.kvcache.spec import (FP8, QMAX, STORE_DTYPES, CacheSpec,
                                      cache_kv_heads, normalize_dtype,
                                      paged_pool_shape)

__all__ = ["CacheSpec", "FP8", "QMAX", "STORE_DTYPES", "alloc_contiguous",
           "alloc_paged", "cache_kv_heads", "normalize_dtype",
           "paged_pool_shape", "paged_scatter_prefill", "paged_views",
           "paged_write_batch", "prefill_write"]
