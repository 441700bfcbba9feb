"""Device time of each kernel that one call of B1 (paged decode), B6 (fp8
decode matmul), B5 (W8A8 decode matmul), B4 (tiled W8A8 matmul), B8
(WKV-6) and B7 (RMSNorm) launches, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.kernel_profile

B1 at ``chip_smoke.py`` phase 3's timed shape (8 slots of lengths 0-1,024
summing to 3,075, 12 heads over 2 kv heads, D 128, page 256, bf16), B6
and B5 at phase 8's (M 8, K 1,536, N 8,960, bf16 x, bf16 bias), B4 at
phase 8's (M 4,096, K 1,536, N 8,960, bf16 out), B8 at phase 11's (B 1, S
2,048, H 32, D 64, bf16 r/k/v), B7 at phase 12's (4,096 rows of 1,536,
bf16); then each at a size that moves almost no bytes (B1 with every
length 0, B6, B5 and B4 at K 64, B8 at S 1, B7 at a decode step's 8
rows), the floor a call costs whatever its data.  Each call runs
``REPS`` times under ``torch.profiler`` on operand copies that together
exceed the L2; the result is every kernel's name, its runs per call and
its mean device time per run.  The last line is the same as JSON, with
the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess

import torch

from repro_torch.kernels.int8_matmul import ops as qmm
from repro_torch.kernels.int8_matmul.ref import quantize_rowwise
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.rmsnorm import ops as rops
from repro_torch.kernels.wkv6 import ops as wops
from repro_torch.quant.qops import quantize_linear

REPS, COPIES, SEED = 50, 8, 0
LENGTHS = (0, 1, 300, 1024, 517, 256, 77, 900)


def _paged_args(g, dev, lengths=LENGTHS):
    s_n, h, kh, d, page, pps = len(lengths), 12, 2, 128, 256, 4
    n = s_n * pps + 1
    q = torch.randn((s_n, h, d), generator=g, device=dev).bfloat16()
    kp = torch.randn((n, page, kh, d), generator=g, device=dev).bfloat16()
    vp = torch.randn((n, page, kh, d), generator=g, device=dev).bfloat16()
    bt = (torch.randperm(n - 1, generator=g, device=dev) + 1)[:s_n * pps]
    bt = bt.reshape(s_n, pps).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return (q, kp, vp, bt, lens)


def _decode_args(g, dev, k=1536, quant="fp8"):
    m, n = 8, 8960
    p = quantize_linear({"w": torch.randn((k, n), generator=g, device=dev)
                         * 0.02}, quant=quant)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    bias = (torch.randn((n,), generator=g, device=dev) * 0.1).bfloat16()
    return (x, p["qw"], p["scale"], bias)


def _int8_args(g, dev, k=1536):
    m, n = 4096, 8960
    p = quantize_linear({"w": torch.randn((k, n), generator=g, device=dev)
                         * 0.02}, quant="int8")
    xq, xs = quantize_rowwise(
        torch.randn((m, k), generator=g, device=dev).bfloat16())
    return (xq, p["qw"], xs, p["scale"])


def _rmsnorm_args(g, dev, rows=4096):
    x = torch.randn((rows, 1536), generator=g, device=dev).bfloat16()
    return (x, torch.randn((1536,), generator=g, device=dev).bfloat16())


def _wkv6_args(g, dev, s=2048):
    shape = (1, s, 32, 64)
    r, k, v = (torch.randn(shape, generator=g, device=dev).bfloat16()
               for _ in range(3))
    logw = -torch.randn(shape, generator=g, device=dev).abs() * 0.1 - 0.01
    u = torch.randn((32, 64), generator=g, device=dev) * 0.1
    s0 = torch.zeros((1, 32, 64, 64), device=dev)
    return (r, k, v, logw, u, s0)


def _profile(fn, copies) -> dict:
    """{kernel name: (runs per call, mean device ms per run)} of ``fn``."""
    for args in copies[:2]:
        fn(*args)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(REPS):
            fn(*copies[i % len(copies)])
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0.0)
        if t and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = (ev.count / REPS, t / 1e3 / ev.count)
    if not out:
        raise RuntimeError("the profiler saw no device time")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    res = {"card": smi}
    b6 = lambda x, w, s, b: qmm.fp8_matmul_decode(x, w, s,  # noqa: E731
                                                    bias=b)
    b5 = lambda x, w, s, b: qmm.w8a8_matmul_decode(x, w, s,  # noqa: E731
                                                     bias=b)
    for name, fn, make in (
            ("B1 paged decode", pops.paged_attention, _paged_args),
            ("B6 fp8 decode", b6, _decode_args),
            ("B5 W8A8 decode", b5,
             lambda g, dev: _decode_args(g, dev, quant="int8")),
            ("B4 tiled W8A8", qmm.int8_matmul, _int8_args),
            ("B8 WKV-6", wops.wkv6, _wkv6_args),
            ("B7 RMSNorm", rops.rmsnorm, _rmsnorm_args),
            ("B1 floor (lengths 0)", pops.paged_attention,
             lambda g, dev: _paged_args(g, dev, (0,) * len(LENGTHS))),
            ("B6 floor (K 64)", b6, lambda g, dev: _decode_args(g, dev, 64)),
            ("B5 floor (K 64)", b5,
             lambda g, dev: _decode_args(g, dev, 64, "int8")),
            ("B4 floor (K 64)", qmm.int8_matmul,
             lambda g, dev: _int8_args(g, dev, 64)),
            ("B8 floor (S 1)", wops.wkv6,
             lambda g, dev: _wkv6_args(g, dev, 1)),
            ("B7 floor (8 rows)", rops.rmsnorm,
             lambda g, dev: _rmsnorm_args(g, dev, 8))):
        per = _profile(fn, [make(g, dev) for _ in range(COPIES)])
        res[name] = {k: {"runs_per_call": r, "ms": ms}
                     for k, (r, ms) in per.items()}
        print(f"{name}: " + "; ".join(
            f"{k[:60]} x{r:g} {ms:.4f} ms" for k, (r, ms) in per.items()))
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
