"""Port parity: the port's bf16 KV cache (allocation, batched prefill
scatter, per-token paged writes, staging-cache writes) against
``repro.kvcache`` on the same numpy inputs — pools and block tables must
be bit-equal after the same write sequence."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kvcache as jkv  # noqa: E402
from repro.configs.base import AttentionConfig as JAttn  # noqa: E402
from repro.serve.paged import set_block_table_rows as j_set_rows  # noqa: E402
from repro_torch import kvcache as tkv  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs.base import AttentionConfig as TAttn  # noqa: E402
from repro_torch.serve.paged import (PageAllocator,  # noqa: E402
                                     set_block_table_rows)

torch.manual_seed(0)


def _bits(x) -> np.ndarray:
    """Raw bits of a bf16 array/tensor, for bit-equality checks."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("kind,h,kvh,style", [
    ("gqa", 4, 2, "full"), ("gqa", 8, 8, "gqa"), ("gqa", 4, 2, "mqa"),
    ("mha", 4, 4, "full")])
def test_alloc_shapes_match(kind, h, kvh, style):
    ja = JAttn(kind=kind, num_heads=h, num_kv_heads=kvh, head_dim=16)
    ta = TAttn(kind=kind, num_heads=h, num_kv_heads=kvh, head_dim=16)
    for layout in ("contiguous", "paged"):
        jspec = jkv.CacheSpec(layout=layout, style=style, page_size=8)
        tspec = tkv.CacheSpec(layout=layout, style=style, page_size=8)
        assert jspec.stored_kv_heads(ja) == tspec.stored_kv_heads(ta)
        if layout == "paged":
            j = jkv.alloc_paged(jspec, ja, 3, 7, 2)
            t = tkv.alloc_paged(tspec, ta, 3, 7, 2)
        else:
            j = jkv.alloc_contiguous(jspec, ja, 3, 24)
            t = tkv.alloc_contiguous(tspec, ta, 3, 24)
        assert set(j) == set(t)
        for name in j:
            assert tuple(j[name].shape) == tuple(t[name].shape), name
            assert str(j[name].dtype) == str(t[name].dtype).split(".")[-1]
    assert tkv.paged_pool_shape(4, 100, 16) == jkv.paged_pool_shape(4, 100,
                                                                    16)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_pools_are_refused(dtype):
    a = TAttn(num_heads=4, num_kv_heads=2, head_dim=16)
    with pytest.raises(NotImplementedError):
        tkv.alloc_paged(tkv.CacheSpec(layout="paged", dtype=dtype), a, 2, 5,
                        2)
    with pytest.raises(NotImplementedError):
        tkv.alloc_contiguous(tkv.CacheSpec(dtype=dtype), a, 2, 8)


@pytest.mark.parametrize("page", [4, 8])
def test_scatter_and_decode_writes_bit_equal(page):
    """Admission scatter of a right-padded batch (ragged lengths, one
    empty row) then several lock-step decode writes — including slots
    whose rows point at the null page and positions past the last page
    (the pad-safe clamp) — leave identical pools and block tables."""
    rng = np.random.default_rng(0)
    n_slots, kvh, d, pps = 3, 2, 16, 3
    n_pages = n_slots * pps + 1
    a_j = JAttn(num_heads=4, num_kv_heads=kvh, head_dim=d)
    a_t = TAttn(num_heads=4, num_kv_heads=kvh, head_dim=d)
    j = jkv.alloc_paged(jkv.CacheSpec(layout="paged", page_size=page), a_j,
                        n_slots, n_pages, pps)
    t = tkv.alloc_paged(tkv.CacheSpec(layout="paged", page_size=page), a_t,
                        n_slots, n_pages, pps)
    alloc = PageAllocator(n_pages, pps, n_slots)
    for slot, need in ((0, 3), (2, 2)):                 # slot 1 stays free
        alloc.alloc(slot, need)
    slots = np.asarray([0, 2], np.int32)
    jc = j_set_rows({"kv": j}, slots, alloc.table[slots])["kv"]
    set_block_table_rows([{"blk0": {"kv": t}}], slots, alloc.table[slots])

    t_pad = 2 * page
    k_rows = rng.normal(size=(2, t_pad, kvh, d)).astype(np.float32)
    v_rows = rng.normal(size=(2, t_pad, kvh, d)).astype(np.float32)
    lengths = np.asarray([t_pad - 1, page + 1], np.int32)
    jc = jkv.paged_scatter_prefill(
        jc, jnp.asarray(slots), jnp.asarray(lengths),
        jnp.asarray(k_rows, jnp.bfloat16), jnp.asarray(v_rows, jnp.bfloat16))
    tkv.paged_scatter_prefill(
        t, torch.from_numpy(slots), torch.from_numpy(lengths),
        torch.from_numpy(k_rows).bfloat16(),
        torch.from_numpy(v_rows).bfloat16())

    pos = np.asarray([lengths[0], 0, lengths[1]], np.int32)
    for step in range(page + 2):
        k_new = rng.normal(size=(n_slots, kvh, d)).astype(np.float32)
        v_new = rng.normal(size=(n_slots, kvh, d)).astype(np.float32)
        p = pos + step
        p[2] = min(p[2], pps * page + 3)       # past the horizon: clamped
        jc = jkv.paged_write_batch(jc, jnp.asarray(p),
                                   jnp.asarray(k_new, jnp.bfloat16),
                                   jnp.asarray(v_new, jnp.bfloat16))
        tkv.paged_write_batch(t, torch.from_numpy(p),
                              torch.from_numpy(k_new).bfloat16(),
                              torch.from_numpy(v_new).bfloat16())
    np.testing.assert_array_equal(np.asarray(jc["block_table"]),
                                  t["block_table"].numpy())
    # page 0 is the null page: duplicate garbage writes land there in an
    # order neither side defines, and no read ever reaches it
    for name in ("k_pages", "v_pages"):
        np.testing.assert_array_equal(_bits(jc[name])[1:],
                                      _bits(t[name])[1:])


def test_staging_prefill_write_bit_equal():
    rng = np.random.default_rng(1)
    a_j = JAttn(num_heads=4, num_kv_heads=2, head_dim=16)
    a_t = TAttn(num_heads=4, num_kv_heads=2, head_dim=16)
    j = jkv.alloc_contiguous(jkv.CacheSpec(), a_j, 2, 12)
    t = tkv.alloc_contiguous(tkv.CacheSpec(), a_t, 2, 12)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    j = jkv.prefill_write(j, {"k": jnp.asarray(k), "v": jnp.asarray(v)})
    tkv.prefill_write(t, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)})
    for name in ("k", "v"):
        np.testing.assert_array_equal(_bits(j[name]), _bits(t[name]))
    assert torch.equal(tensor_from_numpy(np.asarray(j["k"])), t["k"])
