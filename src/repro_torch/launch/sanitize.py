"""Small launches of the kernels that stage tiles through ``cp.async`` or
TMA rings (B1 paged decode, B6 fp8 decode, B5 W8A8 decode on its
tensor-core step, B2 prefix extend, B3 flash prefill, B4 tiled W8A8 on
its wgmma step, B8 WKV-6) or share a warp's registers across rows (B7
RMSNorm, on each of its steps), for a run under NVIDIA's
compute-sanitizer:

    compute-sanitizer --tool racecheck python -m repro_torch.launch.sanitize
    compute-sanitizer --tool synccheck python -m repro_torch.launch.sanitize

Each case is one launch at a small shape, on the tensor-core step and
(B1, B6) the FMA step, held to its plain version so that a hazard the
tool reports can be told from a wrong result.  Prints one line a case
and exits non-zero if a result is off.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.int8_matmul import ops as qmm
from repro_torch.kernels.int8_matmul.ref import (fp8_decode_ref,
                                                 int8_matmul_ref,
                                                 quantize_rowwise,
                                                 w8a8_decode_ref)
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_prefix_extend_ref)
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.wkv6 import ops as wops
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
from repro_torch.quant.qops import quantize_linear

TOL = 2e-2


def _paged(g, dev, dt, h=12, kh=2, d=64, page=16, pps=8):
    lens = [0, 5, 100, pps * page]
    n = len(lens) * pps + 1
    qdt = torch.float32 if dt == torch.float32 else torch.bfloat16
    q = torch.randn((len(lens), h, d), generator=g, device=dev).to(qdt)
    ks = vs = None
    if dt == torch.int8:
        kp, vp = (torch.randint(-127, 128, (n, page, kh, d), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand((n, kh), generator=g, device=dev) * 0.05
                  + 0.01 for _ in range(2))
    else:
        kp, vp = (torch.randn((n, page, kh, d), generator=g,
                              device=dev).to(dt) for _ in range(2))
    bt = (torch.randperm(n - 1, generator=g, device=dev) + 1)[:len(lens) * pps]
    bt = bt.reshape(len(lens), pps).to(torch.int32).contiguous()
    return (q, kp, vp, bt, torch.tensor(lens, dtype=torch.int32, device=dev),
            ks, vs)


def _cases(g, dev):
    bf16 = torch.bfloat16
    for dt, h, kh in ((bf16, 12, 2), (bf16, 32, 1), (torch.int8, 12, 1),
                      (torch.float32, 12, 2)):
        args = _paged(g, dev, dt, h, kh)
        yield (f"B1 {str(dt)[6:]} pools H{h}/{kh}", pops.paged_attention,
               paged_attention_ref, args)
    for x_dt in (bf16, torch.float32):
        p = quantize_linear({"w": torch.randn((512, 256), generator=g,
                                              device=dev) * 0.02},
                            quant="fp8")
        x = torch.randn((8, 512), generator=g, device=dev).to(x_dt)
        yield (f"B6 {str(x_dt)[6:]} x", qmm.fp8_matmul_decode,
               fp8_decode_ref, (x, p["qw"], p["scale"]))
    # B5 on its tensor-core step: K 4,608 over N 128 plans 8 k-ranges (a
    # cluster of 8) of 9 stages each, so the 8-slot ring wraps; M 9 takes
    # two row blocks, the second one ragged
    p = quantize_linear({"w": torch.randn((4608, 128), generator=g,
                                          device=dev) * 0.02}, quant="int8")
    assert qmm.decode_split(9, 4608, 128, tc=True,
                            max_range_k=qmm.W8A8_TC_MAX_RANGE_K) == (8, 576)
    x = torch.randn((9, 4608), generator=g, device=dev).to(bf16)
    bias = torch.randn((128,), generator=g, device=dev).to(bf16)
    yield ("B5 tensor-core step",
           lambda x, w, s, b: qmm.w8a8_matmul_decode(x, w, s, bias=b),
           w8a8_decode_ref, (x, p["qw"], p["scale"], bias))
    # B7 on its warp step (13 rows: not a multiple of a block's 8 warps)
    # and on its long-row step (d 8,192)
    for rows, d in ((13, 1536), (3, 8192)):
        xr = torch.randn((rows, d), generator=g, device=dev).to(bf16)
        wr = torch.randn((d,), generator=g, device=dev).to(bf16)
        yield (f"B7 ({rows}, {d})", rops.rmsnorm, rmsnorm_ref, (xr, wr))
    q, kp, vp, bt, _, _, _ = _paged(g, dev, bf16, d=64)
    w = 16
    starts = torch.tensor([0, 5, 64, 100], dtype=torch.int32, device=dev)
    widths = torch.tensor([16, 3, 16, 9], dtype=torch.int32, device=dev)
    qc = torch.randn((4, w, 12, 64), generator=g, device=dev).to(bf16)
    kc, vc = (torch.randn((4, w, 2, 64), generator=g, device=dev).to(bf16)
              for _ in range(2))
    yield ("B2 bf16", pops.paged_prefix_extend_attention,
           paged_prefix_extend_ref,
           (qc, kp, vp, bt, starts, kc, vc, widths))
    qf, kf, vf = (torch.randn((2, 100, hh, 64), generator=g,
                              device=dev).to(bf16) for hh in (12, 2, 2))
    yield "B3 bf16", fops.flash_attention, attention_ref, (qf, kf, vf)
    # B4 on its wgmma step: two tiles of 256 rows, six 128-deep stages,
    # so the 4-stage ring wraps; ragged M and an N tail
    p = quantize_linear({"w": torch.randn((768, 144), generator=g,
                                          device=dev) * 0.02}, quant="int8")
    xq, xs = quantize_rowwise(torch.randn((300, 768), generator=g,
                                          device=dev).to(bf16))
    yield ("B4 wgmma step", qmm.int8_matmul,
           lambda *a: int8_matmul_ref(*a, out_dtype=bf16),
           (xq, p["qw"], xs, p["scale"]))
    # B8: three chunks, the last one ragged
    shape = (1, 150, 2, 64)
    r, k, v = (torch.randn(shape, generator=g, device=dev).to(bf16)
               for _ in range(3))
    lw = -torch.randn(shape, generator=g, device=dev).abs() * 0.1 - 0.01
    u = torch.randn((2, 64), generator=g, device=dev) * 0.1
    s0 = torch.randn((1, 2, 64, 64), generator=g, device=dev) * 0.2
    yield ("B8 bf16", lambda *a: wops.wkv6(*a)[0],
           lambda r, k, v, lw, u, s0: wkv6_chunked_ref(
               r.float(), k.float(), v.float(), lw, u, s0)[0],
           (r, k, v, lw, u, s0))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("sanitize: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for tag, fn, ref, args in _cases(g, dev):
        out = fn(*args)
        torch.cuda.synchronize()
        want = ref(*args)
        err = ((out.float() - want.float()).abs()
               / (want.float().abs() + 1.0)).max().item()
        ok = err <= TOL
        bad += not ok
        print(f"{tag}: max err {err:.2e} {'ok' if ok else 'OFF'}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
