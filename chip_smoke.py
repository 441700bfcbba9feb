"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device    — require CUDA, print the card's name and power limit,
                 turn TF32 off for fp32 products
  2. build     — compile the hand-written CUDA kernels from csrc/ (fails
                 if a tensor-core instantiation spills; prints ptxas's
                 wgmma serialisation notes)
  3. paged     — paged decode kernel vs its plain version, element by
                 element, at the serving shapes (8 slots, 12 heads over
                 2 kv heads, D 128, page 256), bf16 / fp32 / int8 / fp8
                 pools, with times; then bf16 / fp32 at the other head
                 shapes of the port's configs (EXTRA_SHAPES: groups of
                 1 to 32 query heads a kv head), int8 at 12 over 1, and
                 pages of 16 tokens (bf16 / int8 / fp8 pools);
                 each case names its step (tensor cores for bf16 q over
                 bf16 / int8 / fp8 pools, FMA for fp32) and is called
                 twice, bit-equal
  4. flash     — flash prefill kernel vs its plain version (B 8,
                 S in {8, 100, 512}, causal, bf16 / fp32, one windowed),
                 then the other head shapes; each case names the tile
                 step it took (tensor cores for bf16, FMA for fp32)
  5. e2e       — qwen2-1.5b at full width (28 layers, random weights from
                 a seed) served by the port's PagedEngine; checks token
                 counts, host syncs and the kernels' launch counts, and
                 one decode step's logits with kernels vs plain versions
  6. extend    — prefix-extend kernel vs its plain version (4 slots x 512
                 chunk rows over prefixes of 512-3072 tokens, timed;
                 fp32 / int8 / fp8 pools, W 1 and 5 with fp32 q over a
                 bf16 chunk, the other configs' head shapes, pages of
                 16 on bf16 / int8 / fp8 pools); each case names its
                 tile step (tensor cores for bf16 q and chunk
                 over bf16 / int8 / fp8 pools, FMA otherwise)
  7. sched     — the same model through the port's SchedEngine (FCFS,
                 prefix cache, chunked prefill of 600-3000-token prompts,
                 half behind a shared 1,024-token system prompt); checks
                 token counts, host syncs, all three kernels' launch
                 counts, prefix hits, a repeated prompt's tokens and
                 cached suffix, and one continuation chunk's logits with
                 kernels vs plain versions
  8. qmm       — the quantized-matmul kernels vs their plain versions at
                 qwen2-1.5b's linears: tiled W8A8 (B4, M 129 / 777 / 4,096,
                 each case tagged with its step, the wgmma-step cases
                 called twice, bit-equal; K / N tails on the wgmma step,
                 64-aligned and unaligned K on the ragged step) and W8A8
                 decode (B5, M 1 / 8 / 9 / 127 / 128, bf16 and fp32 x, on
                 the tensor-core step, each case called twice, bit-equal;
                 K 1,000 and N 1,000 on the ragged step; each case tagged
                 with its step) bit for bit against the plain
                 version on the CPU copy, fp8
                 decode (B6) element by element (bf16 x on the tensor
                 cores, called twice, bit-equal; one fp32-x case on the
                 FMA step); times; then the trap-4
                 line: the port's torch-op quantization on the card vs
                 the CPU, bit for bit
  9. qsched    — phase 7's scheduler drive with int8 weights and int8 KV
                 pools (8 requests, 4 behind the system prompt): launches
                 of B4 / B5 = 196 x the dispatches with M > 128 / <= 128
                 rows (decode steps included) and of B1-B3 as in phase 7,
                 every B4 launch on its wgmma step and every B5 launch on
                 its tensor-core step,
                 requant events, a repeated prompt; one continuation
                 chunk's and one decode step's logits with B4 / B5 equal
                 to the plain matmuls', and every B2 / B1 call of those
                 forwards on the int8 pools vs its plain version, element
                 by element
 10. fp8       — phase 5's PagedEngine drive with fp8 weights and fp8 KV
                 pools: B6 = 196 x the dispatches with M <= 128 rows,
                 every B6 and B1 launch on the tensor-core step
 11. wkv6      — the WKV-6 kernel (B8) vs its plain version on CPU copies
                 of the operands, o and the final state element by element
                 (B 1, H 32, D 64, S in {1, 16, 17, 64, 100, 3,000}; B 4,
                 S 512; zero and non-zero s0; bf16 and fp32 r/k/v), timed
                 at one 2,048-token admission
 12. rmsnorm   — the RMSNorm kernel (B7) vs its plain version within one
                 bf16 ulp (the reference's test_rmsnorm shapes, qwen2-1.5b's
                 4,096 and 8 rows, d 2,048, odd row counts, on the warp
                 step; d 8,192 and 1,001 on the long-row step; each case
                 tagged with its step and called twice, bit-equal), timed
                 beside F.rms_norm at 4,096 and 8 rows, then the two in
                 turns over 8 rounds (median ratio and its spread)
 13. rwkv      — rwkv6-1.6b at full width (24 layers) through the port's
                 eager Engine, 8 slots: 16 requests of 200-3,000 prompt
                 tokens; token counts, syncs = admissions + decode steps, B8
                 = 24 x admissions, a prompt in a reused slot gives the
                 fresh slot's tokens, one admission's logits with B8 vs
                 its plain version
 14. spec      — speculative decoding through the port's SpecEngine on
                 phase 7's settings: (a) qwen2-1.5b at full width, bf16,
                 n-gram drafts (k <= 4, adaptive), 8 requests of 600-3,000
                 tokens of repeated passages, 64 new tokens each: token
                 counts, syncs = chunk dispatches + verify rounds +
                 fallback blocks, B2 = 28 x (continuations + verify
                 rounds), B3 = 28 x fresh chunks, B1 = 28 x fallback decode
                 steps, B7 = 57 x forwards, all on the tensor cores / warp
                 step; a repeated prompt; one verify round (8 slots x W 5)
                 with every B2 call vs its plain version and the logits
                 vs the plain versions; B2 timed at that shape beside
                 SDPA and 5 x B1; (b) the draft-LM arm (draft_config_of:
                 1 layer, d 384, contiguous bf16 cache), 4 requests of
                 200-600 tokens, its syncs and B7 launches counted; (c)
                 float32 at 4 layers, full width: the n-gram arm on bf16
                 and int8 pools, self-speculation, a random shrunk draft
                 (nearly every draft rejected), and the n-gram and
                 shrunk-draft arms on int8 weights (the verify on B5, an
                 int8 draft LM) give the plain scheduler's greedy streams
                 token for token, and self-speculation accepts every draft
 15. eager     — the port's eager Engine over contiguous caches: (a)
                 qwen2-1.5b at full width, bf16, 8 slots, max_len 4,096,
                 16 requests of 200-3,000 tokens (at least 4 past
                 attn_chunk_min, 2,048), 32-64 new tokens: token counts,
                 syncs = admissions + decode steps, B3 = 28 x admissions,
                 B7 = 57 x forwards, all on the tensor-core / warp step,
                 a repeated prompt, the 2,048-token admission's logits vs
                 chunked attention and the plain RMSNorm; (b) int8
                 weights over an int8 cache and fp8 weights over an fp8
                 cache, 8 requests each: B4 = 196 x admissions past 128
                 tokens, B5 / B6 = 196 x decode steps; (c) float32 at 4
                 layers: the Engine's greedy streams equal the
                 PagedEngine's, and a copy with a 512-token window (B3
                 windowed) equals its plain versions
 16. resil     — resilient serving, float32 at 4 layers, full width,
                 SchedEngine with pages and chunks of 128: (a) chaos
                 seed=0,oom=0.05,fault=0.1,shrink=4, every request ok with
                 the fault-free stream, faults injected and recovered; (b)
                 0.3 s spikes against a 0.75 s deadline: timed_out; (c) 32
                 requests with the ladder, down to its shed rung with
                 retry-after hints; (d) SpecEngine n-gram under
                 draft=0.3,fault=0.1, the plain scheduler's streams; in
                 every arm the outcomes sum to the requests, every page is
                 freed and B1 / B2 / B3 / B7 ran once a layer for each
                 dispatch that got past the fault hook
B7 takes every RMSNorm of the qwen2-1.5b drives: 57 launches a forward
(phases 5, 7, 9, 10), every one on its warp step.  Every B1 / B2 / B3
launch of those drives (bf16 activations), every B4 and B5 launch of
phase 9 and every B6 launch of phase 10 must take the tensor-core step:
their tensor-core launch counts are printed beside the launch counts and
must equal them.  Launch counts are
zeroed just before each drive (phases 5, 7, 9, 10, 13-16) and read just
after it; peak memory is read for the set-up and, restarted, for the
drive.  Then one JSON
line of kernel numbers, and last the result line ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float8_e4m3fn": 1979e12,
              "int8": 1979e12, "float32": 67e12, "tfloat32": 495e12}

SEED = 0


def _torch():
    import torch
    return torch


# ---------------------------------------------------------------------------
# timing


def time_ms(fn, inputs, reps: int = 20, rounds: int = 5) -> float:
    """Median device time of one ``fn(*inputs[i])`` call, in ms.  The
    inputs cycle through several copies so that repeated calls do not find
    their operands in the 50 MB L2; a spin kernel queued first keeps the
    card busy while the host enqueues, so events time the kernels alone."""
    torch = _torch()
    for x in inputs[:2]:
        fn(*x)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def n_copies(bytes_per_copy: int) -> int:
    """Copies of a call's operands that together exceed the L2 twice."""
    return max(2, min(16, -(-100_000_000 // max(bytes_per_copy, 1))))


def bound(bytes_moved: float, flops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phases


def phase_device() -> dict:
    torch = _torch()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the GPU only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1 device] {name} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")
    return {"kind": name, "count": torch.cuda.device_count(), "smi": smi}


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    dt = time.perf_counter() - t0
    regs = {}
    for name, info in built.items():
        regs[name] = [ln.strip() for ln in info["log"].splitlines()
                      if "registers" in ln or "spill" in ln]
    tc = {n: _tc_ptxas(i["log"]) for n, i in built.items()}
    spills = {n: sp for n, (_, sp) in tc.items() if sp}
    out_dir = ROOT / "chiprun_out"
    if built and out_dir.is_dir():
        (out_dir / "ptxas.txt").write_text(
            "\n\n".join(f"== {n}\n{i['log']}" for n, i in built.items()))
    if spills:
        raise AssertionError(f"tensor-core tile step spills: {spills}")
    # ptxas notes a kernel whose wgmma instructions it had to serialise
    serial = {n: sum("wgmma.mma_async instructions are serialized" in ln
                     for ln in i["log"].splitlines())
              for n, i in built.items()}
    print(f"[2 build] {sorted(build.SOURCES)} in {dt:.1f}s "
          f"(compiled now: {sorted(built)}; "
          f"max registers: {_max_regs(regs)}; tensor-core instantiations "
          f"without spills: {sum(n for n, _ in tc.values())}; wgmma "
          f"serialisation notes: {sum(serial.values())})")
    return {"seconds": dt}


def _tc_ptxas(log: str) -> tuple:
    """(tensor-core tile-step instantiations, those that spill) in an
    ``nvcc -Xptxas=-v`` log: the entries of namespace ``tc_step`` and
    their ptxas spill lines."""
    entries, spilled, entry = 0, [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "tc_step" in ln else None
        elif entry and "spill stores" in ln:
            entries += 1
            if not ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                         "spill stores, 0 bytes spill loads"):
                spilled.append(entry)
            entry = None
    return entries, spilled


def _max_regs(regs: dict) -> dict:
    out = {}
    for name, lines in regs.items():
        vals = [int(ln.split("Used ")[1].split(" registers")[0])
                for ln in lines if "Used " in ln]
        out[name] = max(vals) if vals else None
    return out


def _paged_inputs(dtype_name: str, g, device, lengths, h=12, kh=2, d=128,
                  pps=4, page=256):
    torch = _torch()
    s_n = len(lengths)
    n = s_n * pps + 1
    qdt = torch.float32 if dtype_name == "float32" else torch.bfloat16
    q = torch.randn((s_n, h, d), generator=g, device=device).to(qdt)
    quant = dtype_name in ("int8", "float8_e4m3fn")
    if dtype_name == "int8":
        kp = torch.randint(-127, 128, (n, page, kh, d), generator=g,
                           device=device, dtype=torch.int8)
        vp = torch.randint(-127, 128, (n, page, kh, d), generator=g,
                           device=device, dtype=torch.int8)
    else:
        store = getattr(torch, dtype_name)
        kp = (torch.randn((n, page, kh, d), generator=g, device=device)
              * (4.0 if quant else 1.0)).to(store)
        vp = (torch.randn((n, page, kh, d), generator=g, device=device)
              * (4.0 if quant else 1.0)).to(store)
    ks = vs = None
    if quant:
        ks = torch.rand((n, kh), generator=g, device=device) * 0.05 + 0.01
        vs = torch.rand((n, kh), generator=g, device=device) * 0.05 + 0.01
    perm = torch.randperm(n - 1, generator=g, device=device) + 1
    bt = perm[: s_n * pps].reshape(s_n, pps).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, bt, lens, ks, vs


#: element-wise limits, |out - ref| <= atol * v_rms + rtol * |ref|, by
#: output type: rtol is two units in the last place of the output (bf16
#: keeps 8 significant bits), atol is rounding noise relative to the
#: root mean square of the (dequantized) values V that outputs average
RTOL = {"bfloat16": 1.6e-2, "float32": 1e-5}
ATOL = {"bfloat16": 1e-3, "float32": 1e-5}


def check_close(tag: str, out, ref, v_rms: float) -> str:
    """Hold ``out`` to ``ref`` element by element; raise on any element
    past its limit.  Returns the case's line: the max error, the limit
    used and the worst element's share of its limit."""
    return check_close_share(tag, out, ref, v_rms)[0]


def check_close_share(tag: str, out, ref, v_rms: float) -> tuple:
    """``check_close``'s line and the worst element's share of its
    limit."""
    torch = _torch()
    kind = "float32" if ref.dtype == torch.float32 else "bfloat16"
    atol, rtol = ATOL[kind] * v_rms, RTOL[kind]
    o, r = out.float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(o).all():
        raise AssertionError(f"{tag}: output {tuple(out.shape)} not finite "
                             f"or not of shape {tuple(ref.shape)}")
    err = (o - r).abs()
    worst = (err / (atol + rtol * r.abs())).max().item()
    line = (f"{tag} err {err.max().item():.2e} (limit {atol:.1e} + "
            f"{rtol:.1e}|ref|, worst {worst:.2f} of it)")
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: an element is past its limit: {line}")
    return line, worst


def paged_bytes_flops(q, kp, bt, lens, ks):
    page, kh, d = kp.shape[1], kp.shape[2], kp.shape[3]
    live = int(lens.clamp(max=bt.shape[1] * page).sum())
    live_pages = int(sum(-(-min(int(x), bt.shape[1] * page) // page)
                         for x in lens.tolist()))
    kv = 2 * live * kh * d * kp.element_size()
    scales = 2 * live_pages * kh * 4 if ks is not None else 0
    io = 2 * q.numel() * q.element_size()
    meta = bt.numel() * 4 + lens.numel() * 4
    flops = 4.0 * live * q.shape[1] * d
    return kv + scales + io + meta, flops


#: (heads, kv heads, head dim) the port's configs give each kernel beyond
#: the timed qwen2-1.5b shape (12, 2, 128): llama3.2-1b, stablelm-1.6b,
#: a group of 8, qwen2-1.5b and llama3.2-1b with one stored kv head
#: (kv_cache_style "mqa": groups of 12 and 32), and the smoke configs
EXTRA_SHAPES = [(32, 8, 64), (32, 32, 64), (16, 2, 128), (12, 1, 128),
                (32, 1, 64), (4, 2, 16), (4, 1, 16), (4, 4, 16)]


def phase_paged(records: list) -> None:
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED)
    # a free slot (0), one token, a partial last page, the full horizon
    lengths = [0, 1, 300, 1024, 517, 256, 77, 900]
    cases = [(dt, 12, 2, 128, 256) for dt in ("bfloat16", "float32", "int8",
                                              "float8_e4m3fn")]
    cases += [(dt, h, kh, d, 256) for h, kh, d in EXTRA_SHAPES
              for dt in ("bfloat16", "float32")]
    cases.append(("int8", 12, 1, 128, 256))
    # pages of 16 tokens: a 64-token tile spans four pages
    cases += [(dt, 12, kh, 128, 16) for dt, kh in (
        ("bfloat16", 2), ("int8", 2), ("float8_e4m3fn", 2), ("bfloat16", 1))]
    line = []
    for dt_name, h, kh, d, page in cases:
        args = _paged_inputs(dt_name, g, device, lengths, h, kh, d,
                             pps=1024 // page, page=page)
        tc0 = ops.tc_launches
        out = ops.paged_attention(*args)
        tag = (f"{dt_name} H{h}/{kh} D{d}" + (f" page {page}"
                                              if page != 256 else "")
               + _step_tag(ops.tc_launches - tc0, dt_name != "float32"))
        again = ops.paged_attention(*args)
        ref = paged_attention_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"paged {tag}: a repeated call differs")
        q, kp, vp, bt, lens, ks, vs = args
        v = vp.float() if vs is None else vp.float() * vs[:, None, :, None]
        v_rms = v.pow(2).mean().sqrt().item()
        line.append(check_close(tag, out, ref, v_rms))
        if not (out[0].float() == 0).all():
            raise AssertionError("paged: a length-0 slot must give zeros")
        if (dt_name, h, kh, page) != ("bfloat16", 12, 2, 256):
            continue
        err = (out.float() - ref.float()).abs().max().item()
        nbytes, flops = paged_bytes_flops(q, kp, bt, lens, ks)
        per_copy = kp.numel() * kp.element_size() * 2
        copies = [_paged_inputs(dt_name, g, device, lengths)
                  for _ in range(n_copies(per_copy))]
        ms = time_ms(ops.paged_attention, copies)
        plain_ms = time_ms(paged_attention_ref, copies, reps=5, rounds=3)
        # library yardstick: SDPA over the gathered contiguous context
        lib_in = []
        for (q_, kp_, vp_, bt_, ln_, _, _) in copies:
            t = bt_.shape[1] * kp_.shape[1]
            kc = kp_[bt_.long()].reshape(8, t, 2, 128).transpose(1, 2)
            vc = vp_[bt_.long()].reshape(8, t, 2, 128).transpose(1, 2)
            mask = (torch.arange(t, device=device)[None, :]
                    < ln_[:, None])[:, None, None, :]
            lib_in.append((q_[:, :, None, :], kc.contiguous(),
                           vc.contiguous(), mask))
        lib_ms = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=mm, enable_gqa=True), lib_in)
        b_ms, b_by = bound(nbytes, flops, dt_name)
        records.append({"name": "paged_attention", "route": "cuda",
                        "source": "src/repro_torch/csrc/paged_attention.cu",
                        "replaces": "src/repro/kernels/paged_attention/"
                                    "paged_attention.py:270",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "launches": 0})
        line.append(f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {lib_ms:.4f} "
                    f"bound {b_ms:.4f} ({b_by})")
    print(f"[3 paged] {len(cases)} cases, each repeated bit-equal; "
          + "; ".join(line))


def _flash_inputs(b, s, dt, g, device, h=12, kh=2, d=128):
    torch = _torch()
    q = torch.randn((b, s, h, d), generator=g, device=device).to(dt)
    k = torch.randn((b, s, kh, d), generator=g, device=device).to(dt)
    v = torch.randn((b, s, kh, d), generator=g, device=device).to(dt)
    return q, k, v


def flash_pairs(s: int, t: int, causal: bool, window) -> int:
    """Number of (query, key) pairs the mask lets through."""
    n = 0
    for i in range(s):
        hi = min(t - 1, i) if causal else t - 1
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def phase_flash(records: list) -> None:
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    bf16, f32 = torch.bfloat16, torch.float32
    line = []
    cases = [(s, dt, None, (12, 2, 128)) for s in (8, 100, 512)
             for dt in (bf16, f32)]
    cases.append((512, bf16, 128, (12, 2, 128)))
    cases += [(s, dt, None, shape) for shape in EXTRA_SHAPES
              if shape[2] != 128 for s in (100, 512) for dt in (bf16, f32)
              if s == 100 or shape[2] == 64]
    b = 8
    for s, dt, window, (h, kh, d) in cases:
        q, k, v = _flash_inputs(b, s, dt, g, device, h, kh, d)
        tc0 = ops.tc_launches
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        ref = attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        tag = (f"S{s} {str(dt)[6:]} H{h}/{kh} D{d}"
               + (f" w{window}" if window else "")
               + _step_tag(ops.tc_launches - tc0, dt == bf16))
        line.append(check_close(tag, out, ref, 1.0))   # v ~ N(0, 1)
        if not (s == 512 and dt == bf16 and window is None and h == 12):
            continue
        err = (out.float() - ref.float()).abs().max().item()
        copies = [_flash_inputs(b, s, dt, g, device) for _ in range(8)]
        ms = time_ms(lambda a, b_, c: ops.flash_attention(a, b_, c), copies)
        plain_ms = time_ms(lambda a, b_, c: attention_ref(a, b_, c), copies,
                           reps=5, rounds=3)
        lib_ms = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
            is_causal=True, enable_gqa=True), copies)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4.0 * b * 12 * 128 * flash_pairs(s, s, True, None)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        records.append({"name": "flash_attention", "route": "cuda",
                        "source": "src/repro_torch/csrc/flash_attention.cu",
                        "replaces": "src/repro/kernels/flash_attention/"
                                    "flash_attention.py:94",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "launches": 0})
        line.append(f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {lib_ms:.4f} "
                    f"bound {b_ms:.4f} ({b_by})")
    print("[4 flash] " + "; ".join(line))


def _step_tag(tc_launched: int, want_tc: bool) -> str:
    """The tile step one launch took, as a case's tag; raises if it is
    not the one its dtypes call for (tensor cores for bf16 operands, the
    FMA step for fp32)."""
    step = "tensor cores" if tc_launched == 1 else "FMA"
    if tc_launched not in (0, 1) or (tc_launched == 1) != want_tc:
        raise AssertionError(f"{tc_launched} tensor-core launches, want "
                             f"{int(want_tc)}")
    return f" [{step}]"


def _extend_inputs(pool: str, g, device, prefix, widths, w, h=12, kh=2,
                   d=128, q_dt=None, c_dt=None, pps=4, page=256):
    """Prefix-extend operands: pools of ``pool`` type with ``page``-token
    pages and ``pps`` pages a slot, prefix lengths and chunk widths per
    slot."""
    torch = _torch()
    q_dt = q_dt or (torch.float32 if pool == "float32" else torch.bfloat16)
    c_dt = c_dt or q_dt
    s_n = len(prefix)
    _, kp, vp, bt, _, ks, vs = _paged_inputs(pool, g, device, [0] * s_n,
                                             h, kh, d, pps=pps, page=page)
    q = torch.randn((s_n, w, h, d), generator=g, device=device).to(q_dt)
    ck = torch.randn((s_n, w, kh, d), generator=g, device=device).to(c_dt)
    cv = torch.randn((s_n, w, kh, d), generator=g, device=device).to(c_dt)
    i32 = dict(dtype=torch.int32, device=device)
    return (q, kp, vp, bt, torch.tensor(prefix, **i32), ck, cv,
            torch.tensor(widths, **i32), ks, vs)


def extend_bytes_flops(args):
    """Bytes each operand must move once and the operations the masks let
    through, for one prefix-extend call on these inputs."""
    q, kp, _, bt, pre, ck, _, wid, ks, _ = args
    s_n, w_n, h, d = q.shape
    page, kh = kp.shape[1], kp.shape[2]
    lens = [min(int(x), bt.shape[1] * page) for x in pre.tolist()]
    live_pages = sum(-(-n // page) for n in lens)
    kv = 2 * sum(lens) * kh * d * kp.element_size()
    scales = 2 * live_pages * kh * 4 if ks is not None else 0
    io = 2 * q.numel() * q.element_size() + 2 * ck.numel() * ck.element_size()
    meta = (bt.numel() + 2 * s_n) * 4
    pairs = sum(w_n * n + sum(min(i + 1, int(wd)) for i in range(w_n))
                for n, wd in zip(lens, wid.tolist()))
    return kv + scales + io + meta, 4.0 * pairs * h * d


def _extend_sdpa_inputs(args):
    """The library yardstick's operands: the gathered prefix and the chunk
    as one contiguous context, with the prefix and causal masks as one
    explicit boolean mask (gathered outside the timed call)."""
    torch = _torch()
    q, kp, vp, bt, pre, ck, cv, wid, _, _ = args
    s_n, w_n, h, d = q.shape
    page, kh = kp.shape[1], kp.shape[2]
    t = bt.shape[1] * page
    kc = torch.cat([kp[bt.long()].reshape(s_n, t, kh, d), ck.to(kp.dtype)], 1)
    vc = torch.cat([vp[bt.long()].reshape(s_n, t, kh, d), cv.to(vp.dtype)], 1)
    dev = q.device
    ctx_ok = torch.arange(t, device=dev)[None, None, :] < pre[:, None, None]
    jj = torch.arange(w_n, device=dev)
    chk_ok = ((jj[None, :] <= jj[:, None])[None]
              & (jj[None, None, :] < wid[:, None, None]))
    mask = torch.cat([ctx_ok.expand(s_n, w_n, t), chk_ok], -1)[:, None]
    return (q.transpose(1, 2).contiguous(), kc.transpose(1, 2).contiguous(),
            vc.transpose(1, 2).contiguous(), mask)


def phase_extend(records: list) -> None:
    """Prefix-extend kernel vs its plain version, element by element."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_prefix_extend_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    # (pool, W, (H, KH, D), q dtype, chunk dtype, page): the scheduler's
    # shape at every pool type; one and five queries (speculative verify's
    # widths) with fp32 q over a bf16 chunk; the other configs' head
    # shapes; pages of 16, where a 64-key tile spans four pages, each with
    # its own scales
    cases = [(pool, 512, (12, 2, 128), None, None, 256)
             for pool in ("bfloat16", "float32", "int8", "float8_e4m3fn")]
    cases += [("bfloat16", w, (12, 2, 128), f32, bf16, 256) for w in (1, 5)]
    cases += [(pool, 100, shape, None, None, 256) for shape in EXTRA_SHAPES
              for pool in ("bfloat16", "float32")]
    cases += [(pool, 100, (12, 2, 128), None, None, 16)
              for pool in ("bfloat16", "int8", "float8_e4m3fn")]
    line = []
    for pool, w, (h, kh, d), q_dt, c_dt, page in cases:
        # a chunk with no prefix, a page-aligned prefix, a partial last
        # page, the full horizon with width 0, and an empty row
        prefix = [0, 256, 300, 4 * 256, 0]
        widths = [w, max(w // 2, 1), w, 0, 0]
        args = _extend_inputs(pool, g, device, prefix, widths, w, h, kh, d,
                              q_dt, c_dt, pps=4 * 256 // page, page=page)
        tc0 = ops.extend_tc_launches
        out = ops.paged_prefix_extend_attention(*args)
        ref = paged_prefix_extend_ref(*args)
        torch.cuda.synchronize()
        _, _, vp, _, _, _, cv, _, _, vs = args
        v = vp.float() if vs is None else vp.float() * vs[:, None, :, None]
        v_rms = max(v.pow(2).mean().sqrt().item(),
                    cv.float().pow(2).mean().sqrt().item())
        tag = (f"{pool} W{w} H{h}/{kh} D{d}"
               + (f" q {str(q_dt)[6:]} chunk {str(c_dt)[6:]}" if q_dt else "")
               + (f" page {page}" if page != 256 else "")
               + _step_tag(ops.extend_tc_launches - tc0,
                           pool != "float32" and q_dt is None))
        line.append(check_close(tag, out, ref, v_rms))
        if not (out[4].float() == 0).all():
            raise AssertionError("extend: a row with no prefix and no chunk "
                                 "must give zeros")

    # the timed case: the scheduler's continuation chunks
    def timed():
        return _extend_inputs("bfloat16", g, device, [512, 1024, 2048, 3072],
                              [512] * 4, 512, pps=16)

    args = timed()
    tc0 = ops.extend_tc_launches
    out = ops.paged_prefix_extend_attention(*args)
    ref = paged_prefix_extend_ref(*args)
    torch.cuda.synchronize()
    line.append(check_close("timed bfloat16 W512 prefix 512-3072"
                            + _step_tag(ops.extend_tc_launches - tc0, True),
                            out, ref, 1.0))
    err = (out.float() - ref.float()).abs().max().item()
    nbytes, flops = extend_bytes_flops(args)
    copies = [args] + [timed() for _ in range(3)]
    ms = time_ms(ops.paged_prefix_extend_attention, copies, reps=10)
    plain_ms = time_ms(paged_prefix_extend_ref, copies[:2], reps=3, rounds=3)
    lib_in = [_extend_sdpa_inputs(a) for a in copies[:2]]
    lib_ms = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mm, enable_gqa=True), lib_in, reps=10)
    t_bytes, _ = bound(nbytes, 0.0, "bfloat16")
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    records.append({"name": "paged_prefix_extend", "route": "cuda",
                    "source": "src/repro_torch/csrc/paged_prefix_extend.cu",
                    "replaces": "src/repro/kernels/paged_attention/"
                                "paged_attention.py:209",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms, "launches": 0})
    line.append(f"ms {ms:.4f} plain {plain_ms:.4f} sdpa {lib_ms:.4f} bound "
                f"{b_ms:.4f} ({b_by}; bytes {t_bytes:.4f}, operations "
                f"{t_ops:.4f})")
    print("[6 extend] " + "; ".join(line))


#: qwen2-1.5b's linears (K, N): wq / wo, wk / wv, gate / up, down
QMM_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]
#: linears of one layer at each (K, N) of QMM_SHAPES
QMM_PER_LAYER = {(1536, 1536): 2, (1536, 256): 2, (1536, 8960): 2,
                 (8960, 1536): 1}
#: the quantized-matmul kernels' records: name, source, TPU kernel
QMM_KERNELS = {
    "B4": ("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
           "src/repro/kernels/int8_matmul/int8_matmul.py:68"),
    "B5": ("w8a8_decode_matmul", "src/repro_torch/csrc/w8a8_decode.cu",
           "src/repro/kernels/int8_matmul/int8_matmul.py:186"),
    "B6": ("fp8_decode_matmul", "src/repro_torch/csrc/fp8_decode.cu",
           "src/repro/kernels/int8_matmul/int8_matmul.py:248"),
}


def _qlinear(g, device, k, n, quant):
    """A quantized (K, N) linear from random weights, and a bf16 bias."""
    torch = _torch()
    from repro_torch.quant.qops import quantize_linear
    w = torch.randn((k, n), generator=g, device=device) * 0.02
    p = quantize_linear({"w": w}, quant=quant)
    bias = (torch.randn((n,), generator=g, device=device) * 0.1).bfloat16()
    return p["qw"], p["scale"], bias


def _cpu(t):
    return None if t is None else t.cpu()


def _qmm_check(g, device) -> str:
    """Every case of the phase: B5 at M 1, 8, 9, 127, 128, B6 at M 1, 8,
    128 and B4 at M 129, 777, 4,096 over qwen2-1.5b's linears, bf16 x,
    with and without a bias (B5, B6), and B5 with fp32 x at M 8 and 9;
    B5 off those shapes at M 8: K 1,000 and N 1,000 on its ragged step; B4
    off them in both out types: 300 x 1040 x 272 on its wgmma step (K and
    N tails), 257 x 512 x 129 and 257 x 513 x 129 on its ragged step.
    Each B4 and B5 case names its step and fails on the wrong one; a case
    on B4's wgmma step or B5's tensor-core step is called twice,
    bit-equal."""
    torch = _torch()
    from repro_torch.kernels.int8_matmul import ops
    from repro_torch.kernels.int8_matmul.ref import (fp8_decode_ref,
                                                     int8_matmul_ref,
                                                     quantize_rowwise,
                                                     w8a8_decode_ref)
    bf16 = torch.bfloat16

    errs = {"B4": 0.0, "B5": 0.0, "B6": 0.0}

    def equal(tag, out, ref):
        out = out.cpu()
        kind = tag[:2]
        errs[kind] = max(errs[kind],
                         (out.float() - ref.float()).abs().max().item())
        if not torch.equal(out, ref):
            bad = int((out != ref).sum())
            raise AssertionError(f"{tag}: {bad} elements differ from the "
                                 "plain version on the CPU copy")

    steps = {"wgmma": 0, "ragged": 0}
    b5_steps = {"tensor cores": 0, "ragged": 0}

    def b5(tag, x, qw, ws, b, want_tc):
        """B5 against its plain version on the CPU copy, tagged with the
        step it took; a tensor-core-step case is called twice,
        bit-equal."""
        tc0 = ops.decode_tc_launches
        out = ops.w8a8_matmul_decode(x, qw, ws, bias=b)
        tc = ops.decode_tc_launches - tc0
        if tc != int(want_tc):
            raise AssertionError(f"B5 {tag}: {tc} tensor-core-step launches, "
                                 f"want {int(want_tc)}")
        step = "tensor cores" if tc else "ragged"
        b5_steps[step] += 1
        if tc and not torch.equal(out, ops.w8a8_matmul_decode(x, qw, ws,
                                                              bias=b)):
            raise AssertionError(f"B5 {tag}: a repeated call differs")
        equal(f"B5 {tag} [{step}]", out,
              w8a8_decode_ref(_cpu(x), _cpu(qw), _cpu(ws), _cpu(b)))

    def b4(tag, xq, qw, xs, ws, dt, want_tc):
        """B4 against its plain version, tagged with the step it took; a
        wgmma-step case is called twice, bit-equal."""
        tc0 = ops.tc_launches
        out = ops.int8_matmul(xq, qw, xs, ws, out_dtype=dt)
        tc = ops.tc_launches - tc0
        if tc != int(want_tc):
            raise AssertionError(f"B4 {tag}: {tc} wgmma-step launches, want "
                                 f"{int(want_tc)}")
        step = "wgmma" if tc else "ragged"
        steps[step] += 1
        if tc and not torch.equal(out, ops.int8_matmul(xq, qw, xs, ws,
                                                       out_dtype=dt)):
            raise AssertionError(f"B4 {tag}: a repeated call differs")
        equal(f"B4 {tag} [{step}]", out,
              int8_matmul_ref(_cpu(xq), _cpu(qw), _cpu(xs), _cpu(ws), dt))

    n_cases, worst = 0, 0.0
    for k, n in QMM_SHAPES:
        qw, ws, bias = _qlinear(g, device, k, n, "int8")
        fw, fs, _ = _qlinear(g, device, k, n, "fp8")
        for m in (9, 127):
            x = torch.randn((m, k), generator=g, device=device).to(bf16)
            for b in (None, bias):
                b5(f"M{m} K{k} N{n} bias {b is not None}", x, qw, ws, b, True)
                n_cases += 1
        for m in (8, 9):
            x = torch.randn((m, k), generator=g, device=device)
            b5(f"M{m} K{k} N{n} fp32 x", x, qw, ws, bias, True)
            n_cases += 1
        for m in (1, 8, 128):
            x = torch.randn((m, k), generator=g, device=device).to(bf16)
            for b in (None, bias):
                tag = f"M{m} K{k} N{n} bias {b is not None}"
                b5(tag, x, qw, ws, b, True)
                tc0 = ops.fp8_tc_launches
                out = ops.fp8_matmul_decode(x, fw, fs, bias=b)
                step = _step_tag(ops.fp8_tc_launches - tc0, True)
                if not torch.equal(out, ops.fp8_matmul_decode(x, fw, fs,
                                                              bias=b)):
                    raise AssertionError(f"B6 {tag}: a repeated call "
                                         "differs")
                out = out.cpu()
                ref = fp8_decode_ref(_cpu(x), _cpu(fw), _cpu(fs), _cpu(b))
                line = check_close(f"B6 {tag}{step}", out, ref,
                                   ref.float().pow(2).mean().sqrt().item())
                errs["B6"] = max(errs["B6"], (out.float() - ref.float())
                                 .abs().max().item())
                worst = max(worst, float(line.split("worst ")[1].split()[0]))
                n_cases += 2
        for m in (129, 777, 4096):
            xq, xs = quantize_rowwise(
                torch.randn((m, k), generator=g, device=device).to(bf16))
            b4(f"M{m} K{k} N{n}", xq, qw, xs, ws, bf16, True)
            n_cases += 1
    # fp32 x: B6's FMA step
    fw, fs, bias = _qlinear(g, device, 1536, 256, "fp8")
    x = torch.randn((8, 1536), generator=g, device=device)
    tc0 = ops.fp8_tc_launches
    out = ops.fp8_matmul_decode(x, fw, fs, bias=bias)
    step = _step_tag(ops.fp8_tc_launches - tc0, False)
    ref = fp8_decode_ref(_cpu(x), _cpu(fw), _cpu(fs), _cpu(bias))
    line = check_close(f"B6 M8 K1536 N256 fp32 x{step}", out.cpu(), ref,
                       ref.float().pow(2).mean().sqrt().item())
    worst = max(worst, float(line.split("worst ")[1].split()[0]))
    n_cases += 1
    # B5 off the qwen2 shapes: K and N that rule out its tensor-core step
    for k, n in ((1000, 1536), (1536, 1000)):
        qw, ws, bias = _qlinear(g, device, k, n, "int8")
        x = torch.randn((8, k), generator=g, device=device).to(bf16)
        for b in (None, bias):
            b5(f"M8 K{k} N{n} bias {b is not None}", x, qw, ws, b, False)
            n_cases += 1
    # B4 off the qwen2 shapes: a K tail and an N tail on the wgmma step
    # (K, N multiples of 16), then the ragged step at a 64-aligned and an
    # unaligned K (N 129)
    for (m, k, n), want_tc in (((300, 1040, 272), True),
                               ((257, 512, 129), False),
                               ((257, 513, 129), False)):
        qw, ws, _ = _qlinear(g, device, k, n, "int8")
        xq, xs = quantize_rowwise(torch.randn((m, k), generator=g,
                                              device=device))
        for dt in (bf16, torch.float32):
            b4(f"{m}x{k}x{n} {str(dt)[6:]}", xq, qw, xs, ws, dt, want_tc)
            n_cases += 1
    return (f"{n_cases} cases: B4 (the {steps['wgmma']} wgmma-step cases "
            f"each called twice, bit-equal; {steps['ragged']} ragged-step "
            f"cases) and B5 (the {b5_steps['tensor cores']} tensor-core-step "
            f"cases each called twice, bit-equal; {b5_steps['ragged']} "
            f"ragged-step cases) bit-equal to the plain version on the CPU "
            f"copy; B6 (bf16 x on the tensor cores, each call repeated "
            f"bit-equal) worst element {worst:.2f} of its limit, max abs err "
            f"{errs['B6']:.3e}"), errs, b5_steps


def _qmm_times(kind: str, m: int, k: int, n: int, g, device) -> dict:
    """One call's device time of a quantized-matmul kernel, its plain
    version, its library call and a bf16 product over the dequantized
    weight, on cycled copies of the operands; and its bound."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.int8_matmul import ops
    from repro_torch.kernels.int8_matmul.ref import (fp8_decode_ref,
                                                     int8_matmul_ref,
                                                     quantize_rowwise,
                                                     w8a8_decode_ref)
    bf16 = torch.bfloat16
    quant = "fp8" if kind == "B6" else "int8"
    ops_n = 2.0 * m * k * n
    copies, bf_in = [], []
    for _ in range(n_copies(k * n + m * k * 2)):
        qw, ws, b = _qlinear(g, device, k, n, quant)
        x = torch.randn((m, k), generator=g, device=device).to(bf16)
        copies.append((x, qw, ws, b))
        bf_in.append((x, (qw.float() * ws).to(bf16)))
    if kind == "B4":
        ins = [(*quantize_rowwise(x), qw, ws) for x, qw, ws, _ in copies]
        ins = [(xq, qw, xs, ws) for xq, xs, qw, ws in ins]
        fn = lambda xq, qw, xs, ws: ops.int8_matmul(   # noqa: E731
            xq, qw, xs, ws, out_dtype=bf16)
        plain = lambda xq, qw, xs, ws: int8_matmul_ref(  # noqa: E731
            xq, qw, xs, ws, bf16)
        lib_in = [(xq, qw) for xq, qw, _, _ in ins]
        nbytes = m * k + k * n + 4 * m + 4 * n + 2 * m * n
    else:
        ins = copies
        fn = ((lambda x, qw, ws, b: ops.w8a8_matmul_decode(x, qw, ws, bias=b))
              if kind == "B5" else
              (lambda x, qw, ws, b: ops.fp8_matmul_decode(x, qw, ws, bias=b)))
        plain = w8a8_decode_ref if kind == "B5" else fp8_decode_ref
        # cuBLASLt's int8 product wants more than 16 rows: M padded to 32
        lib_in = [(F.pad(quantize_rowwise(x)[0], (0, 0, 0, 32 - m)), qw)
                  for x, qw, _, _ in copies]
        nbytes = m * k * 2 + k * n + 4 * n + 2 * n + 2 * m * n
    reps = 20 if kind != "B4" else 5
    ms = time_ms(fn, ins, reps=reps)
    plain_ms = time_ms(plain, ins[:2], reps=3, rounds=3)
    bf16_ms = time_ms(lambda x, w: x @ w, bf_in, reps=reps)
    lib_ms = (bf16_ms if kind == "B6"
              else time_ms(lambda a, w: torch._int_mm(a, w), lib_in,
                           reps=reps))
    b_ms, b_by = bound(nbytes, ops_n,
                       "float8_e4m3fn" if kind == "B6" else "int8")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bf16_ms": bf16_ms, "bound_ms": b_ms, "bound_by": b_by}


def phase_qmm(records: list) -> None:
    """B4 / B5 / B6 vs their plain versions at qwen2-1.5b's linears: B4
    and B5 bit for bit against the plain version computed on the CPU copy
    of the operands, B6 element by element (the phase 3-4 rule, atol
    relative to the output's rms); then each kernel's times at every
    linear shape (decode kernels at M 8, B4 at a 4,096-row chunk)."""
    torch = _torch()
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    text, errs, b5_steps = _qmm_check(g, device)
    line = [text]
    for kind, m in (("B5", 8), ("B6", 8), ("B4", 4096)):
        per_shape = {(k, n): _qmm_times(kind, m, k, n, g, device)
                     for k, n in QMM_SHAPES}
        layer = {key: sum(QMM_PER_LAYER[s] * t[key]
                          for s, t in per_shape.items())
                 for key in ("ms", "plain_ms", "library_ms", "bf16_ms",
                             "bound_ms")}
        name, src, repl = QMM_KERNELS[kind]
        rec = per_shape[(1536, 8960)]
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "max_abs_err": errs[kind], **rec,
                        "shape": [m, 1536, 8960], "launches": 0,
                        "layer_ms": layer})
        if kind == "B5":
            records[-1]["step_cases"] = b5_steps
        line.append(f"{kind} M{m}: " + ", ".join(
            f"K{k}xN{n} ms {t['ms']:.4f} plain {t['plain_ms']:.4f} lib "
            f"{t['library_ms']:.4f} bf16 {t['bf16_ms']:.4f} bound "
            f"{t['bound_ms']:.4f} ({t['bound_by']})"
            for (k, n), t in per_shape.items())
            + f"; one layer's 7 linears: ms {layer['ms']:.4f} bound "
            f"{layer['bound_ms']:.4f}")
    print("[8 qmm] " + "; ".join(line))


E2E_LAYERS = 28            # qwen2-1.5b's full depth
#: per-slot relative L2 error allowed between the logits with the kernels
#: and with their plain versions
LOGIT_REL_L2 = 2e-2


def _setup_peak_gb() -> float:
    """The peak device memory of a drive's set-up so far, in GB; the peak
    is then restarted, so that what is read after the drive is what its
    weights, pools and activations held (not the set-up's transients,
    such as the bf16 weights a quantized tree is made from)."""
    torch = _torch()
    gc.collect()
    torch.cuda.synchronize()
    gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return gb


def _swap_plain(fn, groups=("attention", "matmul", "norm")):
    """Run ``fn()`` with the ops of ``groups`` bound to their plain
    versions: the attention ops (B1-B3; "chunked" binds B3 alone to
    chunked attention), the quantized matmuls (B4-B6), RMSNorm (B7)
    and / or the WKV-6 recurrence (B8; "wkv_nudged" scales
    logw by 1 + 1e-6 first, a probe of how far rounding-level changes
    move the logits).  The comparison arm of the drives' logit checks;
    the port itself never does this."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.int8_matmul.ref import (fp8_decode_ref,
                                                     int8_matmul_ref,
                                                     w8a8_decode_ref)
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefix_extend_ref)
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
    from repro_torch.quant import qops
    plain = {"attention": [
        (fops, "flash_attention",
         lambda q, k, v, causal=True, window=None: attention_ref(
             q, k, v, causal=causal, window=window)),
        (pops, "paged_attention", paged_attention_ref),
        (pops, "paged_prefix_extend_attention", paged_prefix_extend_ref)],
        "matmul": [(qmm, "int8_matmul", int8_matmul_ref),
                   (qops, "w8a8_matmul_decode", w8a8_decode_ref),
                   (qops, "fp8_matmul_decode", fp8_decode_ref)],
        "norm": [(rops, "rmsnorm", rmsnorm_ref)],
        "chunked": [(fops, "flash_attention", _chunked_plain())],
        "wkv": [(wops, "wkv6", lambda r, k, v, lw, u, s0: wkv6_chunked_ref(
            r.float(), k.float(), v.float(), lw, u, s0))],
        "wkv_nudged": [(wops, "wkv6", lambda r, k, v, lw, u, s0:
                        wkv6_chunked_ref(r.float(), k.float(), v.float(),
                                         lw * (1 + 1e-6), u, s0))]}
    slots = [slot for g in groups for slot in plain[g]]
    saved = [getattr(mod, name) for mod, name, _ in slots]
    for mod, name, f in slots:
        setattr(mod, name, f)
    try:
        return fn()
    finally:
        for (mod, name, _), f in zip(slots, saved):
            setattr(mod, name, f)


def _live_v_rms(v_pages, v_scales, table, lens, fresh=()) -> float:
    """Root mean square of the (dequantized) V rows an attention call
    averages: each slot's first ``lens[s]`` positions through its
    block-table row, plus ``fresh`` rows (a chunk's own V)."""
    torch = _torch()
    page = v_pages.shape[1]
    rows = list(fresh)
    for row, n in zip(table.tolist(), lens.tolist()):
        if n <= 0:
            continue
        idx = torch.tensor(row[:-(-n // page)], device=v_pages.device).long()
        v = v_pages[idx].float()
        if v_scales is not None:
            v = v * v_scales[idx][:, None, :, None]
        rows.append(v.reshape(-1, *v.shape[2:])[:n])
    return torch.cat([r.float().reshape(-1) for r in rows]).pow(2).mean(
        ).sqrt().item()


def _attention_calls_vs_plain(fn) -> tuple:
    """Run ``fn()`` with every paged decode (B1) and prefix-extend (B2)
    launch also computed by its plain version on the same inputs and held
    to it element by element, by phases 3 and 6's rule; the forward goes
    on with the kernel's output.  Returns (fn's result, calls checked,
    the worst element's share of its limit over them)."""
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefix_extend_ref)
    shares = []
    b1, b2 = pops.paged_attention, pops.paged_prefix_extend_attention

    def decode(q, kp, vp, bt, lens, ks, vs):
        out = b1(q, kp, vp, bt, lens, ks, vs)
        shares.append(check_close_share(
            f"paged decode call {len(shares)}", out,
            paged_attention_ref(q, kp, vp, bt, lens, ks, vs),
            _live_v_rms(vp, vs, bt, lens))[1])
        return out

    def extend(q, kp, vp, bt, starts, k_new, v_new, lens, ks, vs):
        args = (q, kp, vp, bt, starts, k_new, v_new, lens, ks, vs)
        out = b2(*args)
        chunk = [v_new[i, :n] for i, n in enumerate(lens.tolist())]
        shares.append(check_close_share(
            f"prefix extend call {len(shares)}", out,
            paged_prefix_extend_ref(*args),
            _live_v_rms(vp, vs, bt, starts, chunk))[1])
        return out

    pops.paged_attention, pops.paged_prefix_extend_attention = decode, extend
    try:
        return fn(), len(shares), max(shares)
    finally:
        pops.paged_attention, pops.paged_prefix_extend_attention = b1, b2


def _worst_slot_rel_l2(tag: str, a, b, shape) -> tuple:
    """Hold one batch of logits with the kernels (a) to the plain
    versions (b): finite, of ``shape``, and every slot's relative L2 error
    within LOGIT_REL_L2.  bf16 activations round the two arms' attention
    outputs apart by up to an ulp (2^-8 relative) in each of 28 layers; a
    kernel that drops or misweights keys moves a slot's attention output
    by far more than that."""
    torch = _torch()
    if not (torch.isfinite(a).all() and tuple(a.shape) == shape):
        raise AssertionError(f"{tag} logits not finite / wrong shape")
    rel = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
    err = (a - b).abs().max().item()
    if not rel <= LOGIT_REL_L2:
        raise AssertionError(f"{tag} logits kernel vs plain: a slot's "
                             f"relative L2 error {rel:.3e} > "
                             f"{LOGIT_REL_L2} (max abs err {err:.3e})")
    return rel, err


def phase_e2e(records: list) -> dict:
    """qwen2-1.5b at full width through the port's PagedEngine."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.serve.paged import (PageAllocator,
                                         scatter_prefill_cache,
                                         set_block_table_rows)
    cfg = get_config("qwen2-1.5b").with_(num_layers=E2E_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    setup_gb = _setup_peak_gb()
    eng = PagedEngine(lm, params, n_slots=8, max_len=1024, page_size=256,
                      decode_block=8, seed=SEED)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    # warm-up: one short request (cuBLAS handles, first launches)
    eng.submit(rng.integers(0, cfg.vocab_size, (64,)), max_new_tokens=8)
    eng.run_to_completion()
    n_req = 12
    plens = rng.integers(64, 513, n_req)
    max_new = rng.integers(32, 65, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in plens]
    base = (eng.sync_count, eng.steps_run,
            eng.metrics.snapshot()["counters"])
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_launches().items()
                if k in ("paged_attention", "flash_attention", "rmsnorm")}
    tc = _tc_launches("e2e")
    cnt = eng.metrics.snapshot()["counters"]
    admits = int(cnt["serve_prefill_dispatches_total"]
                 - base[2]["serve_prefill_dispatches_total"])
    blocks = int(cnt["serve_decode_dispatches_total"]
                 - base[2]["serve_decode_dispatches_total"])
    syncs = eng.sync_count - base[0]
    steps = eng.steps_run - base[1]
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = len(done[i].out_tokens)
        if got != int(m):
            raise AssertionError(f"request {i}: {got} tokens, want {m}")
        if not all(0 <= t < cfg.vocab_size for t in done[i].out_tokens):
            raise AssertionError(f"request {i}: token out of vocab")
        n_tok += got
    if syncs != admits + blocks:
        raise AssertionError(f"{syncs} host syncs != {admits} admissions "
                             f"+ {blocks} decode blocks")
    if launches["paged_attention"] != cfg.num_layers * steps:
        raise AssertionError(f"paged launches {launches} != "
                             f"{cfg.num_layers} x {steps} decode steps")
    if launches["flash_attention"] != cfg.num_layers * admits:
        raise AssertionError(f"flash launches {launches} != "
                             f"{cfg.num_layers} x {admits} prefills")
    if launches["rmsnorm"] != NORMS_PER_FORWARD * (admits + steps):
        raise AssertionError(f"rmsnorm launches {launches} != "
                             f"{NORMS_PER_FORWARD} x {admits + steps} "
                             "forwards")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in records:
        if r["name"] in launches:
            r["launches"] = launches[r["name"]]
        if r["name"] in ("flash_attention", "paged_attention"):
            r["tc_launches"] = tc[r["name"]]

    # one admission prefill and one decode step, kernels vs plain versions,
    # on the same cache (the decode step rewrites the same K/V both times)
    n_s, pps = 8, 4
    alloc = PageAllocator(n_s * pps + 1, pps, n_s)
    cache = lm.init_paged_cache(n_s, n_s * pps + 1, pps, page_size=256)
    c_plens = rng.integers(100, 500, n_s).astype(np.int32)
    toks = np.zeros((n_s, 512), np.int64)
    for s, n in enumerate(c_plens):
        toks[s, :n] = rng.integers(0, cfg.vocab_size, n)
        alloc.alloc(s, alloc.pages_needed(int(n) + 8, 256))
    set_block_table_rows(cache, np.arange(n_s), alloc.table)
    dev = torch.device("cuda")
    t_toks = torch.as_tensor(toks, device=dev)
    t_plens = torch.as_tensor(c_plens, device=dev)

    def prefill():
        stage = lm.init_cache(n_s, 512, kv_dtype="bfloat16")
        return lm.prefill(eng.params, t_toks, stage, lengths=t_plens)

    pre_k, stage = prefill()
    pre_p, _ = _swap_plain(prefill)
    scatter_prefill_cache(cache, stage, torch.arange(n_s, device=dev),
                          t_plens)
    nxt = torch.argmax(pre_k, -1).to(torch.int32)

    def decode():
        return lm.decode_step(eng.params, nxt, cache, t_plens)[0]

    dec_k = decode()
    dec_p = _swap_plain(decode)
    torch.cuda.synchronize()
    errs = {tag: _worst_slot_rel_l2(tag, a, b, (n_s, cfg.vocab_size))
            for tag, a, b in (("prefill", pre_k, pre_p),
                              ("decode", dec_k, dec_p))}
    out = {"tokens_per_s": n_tok / wall, "ttft_p50_s": statistics.median(ttft),
           "wall_s": wall, "tokens": n_tok, "requests": n_req,
           "admissions": admits, "decode_blocks": blocks,
           "decode_steps": steps, "syncs": syncs, "peak_mem_gb": peak_gb,
           "setup_peak_gb": setup_gb, "setup_s": t_setup, "launches": launches,
           "tc_launches": tc, "logit_err": errs}
    print(f"[5 e2e] {cfg.name} {cfg.num_layers}L d{cfg.d_model} bf16 "
          f"kernels: {n_req} req, {n_tok} tokens in {wall:.3f}s "
          f"({n_tok / wall:.1f} tok/s), TTFT p50 {out['ttft_p50_s']:.4f}s, "
          f"{admits} admissions + {blocks} blocks = {syncs} syncs, "
          f"{steps} decode steps, launches {launches}, tensor-core "
          f"launches {tc}, peak mem "
          f"{peak_gb:.2f} GB (set-up {setup_gb:.2f} GB), logits kernel vs plain (worst slot's relative "
          f"L2 / max abs, limit {LOGIT_REL_L2}): prefill "
          f"{errs['prefill'][0]:.3e}/{errs['prefill'][1]:.3e} decode "
          f"{errs['decode'][0]:.3e}/{errs['decode'][1]:.3e}, setup "
          f"{t_setup:.1f}s")
    return out


SYS_PROMPT = 1024          # shared system prompt of phase 7, tokens
SCHED_REQUESTS = 16


def _counts(eng, tracer, since_events: int) -> dict:
    """Dispatch counts of a scheduler drive: continuation vs fresh chunk
    dispatches from the engine's own trace spans, decode blocks and steps
    from its counters."""
    spans = [e for e in tracer.events[since_events:]
             if e["name"] == "prefill_dispatch" and e["ph"] == "X"]
    return {"cont": sum(bool(e["args"]["cont"]) for e in spans),
            "fresh": sum(not e["args"]["cont"] for e in spans),
            "syncs": eng.sync_count, "steps": eng.steps_run,
            "blocks": int(eng.metrics.snapshot()["counters"][
                "serve_decode_dispatches_total"]),
            "prefill_tokens": eng.stats.prefill_tokens}


def phase_sched(records: list) -> dict:
    """qwen2-1.5b at full width through the port's SchedEngine: FCFS,
    prefix cache, chunked prefill of long prompts."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.sched import SchedEngine
    from repro_torch.serve.paged import PageAllocator, set_block_table_rows
    cfg = get_config("qwen2-1.5b").with_(num_layers=E2E_LAYERS)
    # phase 5's engine is held by reference cycles (its metrics close over
    # it): collect it so that the peak below is this drive's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    setup_gb = _setup_peak_gb()
    tracer = Tracer(enabled=True)
    page = 256
    eng = SchedEngine(lm, params, policy="fcfs", prefix_cache=True,
                      n_slots=8, max_len=4096, page_size=page,
                      prefill_chunk=512, decode_block=8, seed=SEED,
                      tracer=tracer)
    rng = np.random.default_rng(SEED + 7)
    vocab = cfg.vocab_size
    sys_prompt = rng.integers(0, vocab, SYS_PROMPT)
    # the system prompt, served once first: warms the prefix cache (and
    # the first launches)
    eng.submit(np.concatenate([sys_prompt, rng.integers(0, vocab, 100)]),
               max_new_tokens=8)
    eng.run_to_completion()
    torch.cuda.synchronize()
    plens = rng.integers(600, 3001, SCHED_REQUESTS)
    max_new = rng.integers(32, 65, SCHED_REQUESTS)
    prompts = []
    for i, n in enumerate(plens):
        if i % 2 == 0:                       # half share the system prompt
            n = max(int(n), SYS_PROMPT + 1)
            prompts.append(np.concatenate(
                [sys_prompt, rng.integers(0, vocab, n - SYS_PROMPT)]))
        else:
            prompts.append(rng.integers(0, vocab, int(n)))
    base = _counts(eng, tracer, 0)
    n_ev, hit0 = len(tracer.events), eng.stats.prefix_hit_tokens
    phase0 = (eng.t_prefill_s, eng.t_decode_s)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_launches().items()
                if k in ("paged_attention", "flash_attention",
                         "paged_prefix_extend", "rmsnorm")}
    tc = _tc_launches("sched")
    now = _counts(eng, tracer, n_ev)
    d = {k: now[k] - base[k] for k in ("syncs", "steps", "blocks",
                                        "prefill_tokens")}
    d["cont"], d["fresh"] = now["cont"], now["fresh"]
    hit = eng.stats.prefix_hit_tokens - hit0
    # host wall of the chunk dispatches and of the decode blocks, each
    # ending in its one sync
    t_pre, t_dec = (eng.t_prefill_s - phase0[0], eng.t_decode_s - phase0[1])
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = done[i].out_tokens
        if len(got) != int(m):
            raise AssertionError(f"request {i}: {len(got)} tokens, want {m}")
        if not all(0 <= t < vocab for t in got):
            raise AssertionError(f"request {i}: token out of vocab")
        n_tok += len(got)
    if d["syncs"] != d["cont"] + d["fresh"] + d["blocks"]:
        raise AssertionError(f"{d['syncs']} host syncs != {d['cont']} + "
                             f"{d['fresh']} chunk dispatches + "
                             f"{d['blocks']} decode blocks")
    want = {"paged_prefix_extend": cfg.num_layers * d["cont"],
            "flash_attention": cfg.num_layers * d["fresh"],
            "paged_attention": cfg.num_layers * d["steps"],
            "rmsnorm": NORMS_PER_FORWARD * (d["cont"] + d["fresh"]
                                            + d["steps"])}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"launches {launches} != {want} (28 x "
                             "continuation dispatches / fresh dispatches / "
                             "decode steps, 57 x forwards), or a kernel "
                             "never launched")
    if hit <= 0:
        raise AssertionError("no prompt token was served from the prefix "
                             "cache")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in records:
        if r["name"] == "paged_prefix_extend":
            r["launches"] = launches[r["name"]]
            r["tc_launches"] = tc[r["name"]]

    # one prompt served alone twice: identical tokens, and the second
    # time only the suffix past the cached pages is computed.  1,200
    # tokens: both runs' last chunk starts at 1,024, so it is the same
    # computation on the same pages
    repeat = rng.integers(0, vocab, 1200)
    runs = []
    for _ in range(2):
        before = eng.stats.prefill_tokens
        rid = eng.submit(repeat, max_new_tokens=16)
        req = eng.run_to_completion()[rid]
        runs.append((req.out_tokens, eng.stats.prefill_tokens - before,
                     req.prefix_hit_tokens))
    (tok_a, comp_a, _), (tok_b, comp_b, hit_b) = runs
    if tok_a != tok_b or comp_a != len(repeat) or hit_b != 1024 \
            or comp_b != len(repeat) - hit_b:
        raise AssertionError(f"repeat: tokens equal {tok_a == tok_b}, "
                             f"computed {comp_a} then {comp_b} with "
                             f"{hit_b} cached tokens")

    # one continuation chunk, kernels vs plain versions: prefixes written
    # by a first chunk, then a ragged chunk over them
    n_s, pps = 4, 16
    alloc = PageAllocator(n_s * pps + 1, pps, n_s)
    cache = lm.init_paged_cache(n_s, n_s * pps + 1, pps, page_size=page)
    for s in range(n_s):
        alloc.alloc(s, pps)
    set_block_table_rows(cache, np.arange(n_s), alloc.table)
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.arange(n_s, device=dev)
    starts = torch.tensor([512, 768, 1024, 256], **i32)
    first = torch.as_tensor(rng.integers(0, vocab, (n_s, 1024)), device=dev)
    lm.prefill_paged(eng.params, first, cache, slots,
                     torch.zeros(n_s, **i32), starts)
    chunk = torch.as_tensor(rng.integers(0, vocab, (n_s, 512)), device=dev)
    lens = torch.tensor([512, 300, 512, 100], **i32)

    def cont():
        return lm.prefill_paged(eng.params, chunk, cache, slots, starts,
                                lens, max_pages=4)[0]

    ext_k = cont()
    ext_p = _swap_plain(cont)
    torch.cuda.synchronize()
    rel, err = _worst_slot_rel_l2("continuation chunk", ext_k, ext_p,
                                  (n_s, vocab))
    out = {"tokens_per_s": n_tok / wall, "ttft_p50_s": statistics.median(ttft),
           "wall_s": wall, "tokens": n_tok, "requests": SCHED_REQUESTS,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "prefix_hit_tokens": hit, "computed_prefill_tokens":
           d["prefill_tokens"], "cont_dispatches": d["cont"],
           "fresh_dispatches": d["fresh"], "decode_blocks": d["blocks"],
           "decode_steps": d["steps"], "syncs": d["syncs"],
           "preemptions": eng.stats.preemptions, "peak_mem_gb": peak_gb,
           "setup_peak_gb": setup_gb,
           "prefill_wall_s": t_pre, "decode_wall_s": t_dec,
           "launches": launches, "tc_launches": tc,
           "repeat_computed": [comp_a, comp_b], "logit_err": (rel, err)}
    print(f"[7 sched] {cfg.name} {cfg.num_layers}L bf16 SchedEngine fcfs, "
          f"prefix cache, chunk 512: {SCHED_REQUESTS} req "
          f"({out['prompt_tokens']} prompt tokens, {hit} from the prefix "
          f"cache), {n_tok} tokens in {wall:.3f}s ({n_tok / wall:.1f} "
          f"tok/s), TTFT p50 {out['ttft_p50_s']:.4f}s, wall in chunk "
          f"dispatches {t_pre:.3f}s / decode blocks {t_dec:.3f}s, "
          f"{d['fresh']} fresh + "
          f"{d['cont']} continuation dispatches + {d['blocks']} blocks = "
          f"{d['syncs']} syncs, {d['steps']} decode steps, "
          f"{eng.stats.preemptions} preemptions, launches {launches}, "
          f"tensor-core launches {tc}, peak "
          f"mem {peak_gb:.2f} GB (set-up {setup_gb:.2f} GB); repeat prompt computed {comp_a} then "
          f"{comp_b} tokens, same tokens; continuation logits kernel vs "
          f"plain (worst slot's relative L2 / max abs, limit "
          f"{LOGIT_REL_L2}): {rel:.3e}/{err:.3e}")
    return out


QSCHED_REQUESTS = 8
#: quantized linears of one forward dispatch: 28 layers x 7
QLINEARS = E2E_LAYERS * 7


def _quantized_lm(quant: str, kv: str):
    """qwen2-1.5b at full width with ``quant`` weights (quantized from a
    seed's random bf16 weights, which are then freed) and ``kv`` pools."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.quant import quantize_tree
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("qwen2-1.5b").with_(num_layers=E2E_LAYERS, quant=quant,
                                         kv_cache_dtype=kv)
    lm = LM(cfg, device="cuda")
    params = quantize_tree(lm.init(SEED), quant=quant)
    return cfg, lm, params, _setup_peak_gb()


def _record_dispatch_rows(eng) -> list:
    """The padded rows (M of every linear) of each prefill dispatch the
    engine makes from now on, read off the token batch it hands its
    device programs."""
    rows = []
    for name in ("_admit_impl", "_chunk_impl"):
        fn = getattr(eng, name, None)
        if fn is None:
            continue

        def spy(tokens, *a, _fn=fn, **k):
            rows.append(int(tokens.shape[0] * tokens.shape[1]))
            return _fn(tokens, *a, **k)
        setattr(eng, name, spy)
    return rows


def _reset_launches() -> None:
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.wkv6 import ops as wops
    fops.launches = pops.launches = pops.extend_launches = 0
    fops.tc_launches = pops.extend_tc_launches = pops.tc_launches = 0
    qmm.launches = qmm.decode_launches = qmm.fp8_launches = 0
    qmm.tc_launches = qmm.decode_tc_launches = qmm.fp8_tc_launches = 0
    rops.launches = rops.warp_launches = wops.launches = 0


def _read_launches() -> dict:
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


def _tc_launches(tag: str) -> dict:
    """B1 / B2 / B3 / B4 / B5 / B6 launches of a drive that took the
    tensor-core step (B4: its wgmma step), and B7 launches that took its
    warp step; raises unless every launch since the last reset took it."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.rmsnorm import ops as rops
    launches = _read_launches()
    tc = {"flash_attention": fops.tc_launches,
          "paged_prefix_extend": pops.extend_tc_launches,
          "paged_attention": pops.tc_launches,
          "int8_matmul": qmm.tc_launches,
          "w8a8_decode_matmul": qmm.decode_tc_launches,
          "fp8_decode_matmul": qmm.fp8_tc_launches,
          "rmsnorm": rops.warp_launches}
    for name, n in tc.items():
        if n != launches[name]:
            raise AssertionError(f"{tag}: {name} took the tensor-core step "
                                 f"in {n} of {launches[name]} launches")
    return tc


#: RMSNorm launches of one qwen2-1.5b forward: two a layer and the final
NORMS_PER_FORWARD = 2 * 28 + 1


def phase_qsched(records: list) -> dict:
    """qwen2-1.5b at full width, int8 weights (W8A8) and int8 KV pools,
    through the port's SchedEngine with phase 7's settings: B4 on every
    linear of a dispatch with M > 128 rows, B5 on every other (decode
    steps included), B1 / B2 / B3 as in phase 7."""
    torch = _torch()
    import numpy as np
    from repro_torch.obs import Tracer
    from repro_torch.sched import SchedEngine
    from repro_torch.serve.paged import PageAllocator, set_block_table_rows
    cfg, lm, params, setup_gb = _quantized_lm("int8", "int8")
    tracer = Tracer(enabled=True)
    page = 256
    eng = SchedEngine(lm, params, policy="fcfs", prefix_cache=True,
                      n_slots=8, max_len=4096, page_size=page,
                      prefill_chunk=512, decode_block=8, seed=SEED,
                      tracer=tracer)
    rng = np.random.default_rng(SEED + 7)            # phase 7's generator
    vocab = cfg.vocab_size
    sys_prompt = rng.integers(0, vocab, SYS_PROMPT)
    eng.submit(np.concatenate([sys_prompt, rng.integers(0, vocab, 100)]),
               max_new_tokens=8)
    eng.run_to_completion()
    torch.cuda.synchronize()
    plens = rng.integers(600, 3001, QSCHED_REQUESTS)
    max_new = rng.integers(32, 65, QSCHED_REQUESTS)
    prompts = []
    for i, n in enumerate(plens):
        if i % 2 == 0:                       # half share the system prompt
            n = max(int(n), SYS_PROMPT + 1)
            prompts.append(np.concatenate(
                [sys_prompt, rng.integers(0, vocab, n - SYS_PROMPT)]))
        else:
            prompts.append(rng.integers(0, vocab, int(n)))
    base = _counts(eng, tracer, 0)
    n_ev, hit0 = len(tracer.events), eng.stats.prefix_hit_tokens
    rq0 = eng.metrics.snapshot()["counters"]["serve_kv_requant_events_total"]
    seen = _record_dispatch_rows(eng)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    tc = _tc_launches("qsched")
    rows = list(seen)
    now = _counts(eng, tracer, n_ev)
    d = {k: now[k] - base[k] for k in ("syncs", "steps", "blocks",
                                        "prefill_tokens")}
    d["cont"], d["fresh"] = now["cont"], now["fresh"]
    hit = eng.stats.prefix_hit_tokens - hit0
    requant = eng.metrics.snapshot()["counters"][
        "serve_kv_requant_events_total"] - rq0
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = done[i].out_tokens
        if len(got) != int(m) or not all(0 <= t < vocab for t in got):
            raise AssertionError(f"request {i}: {len(got)} tokens (want "
                                 f"{m}) or a token out of vocab")
        n_tok += len(got)
    big = sum(m > 128 for m in rows)
    want = {"paged_prefix_extend": cfg.num_layers * d["cont"],
            "flash_attention": cfg.num_layers * d["fresh"],
            "paged_attention": cfg.num_layers * d["steps"],
            "int8_matmul": QLINEARS * big,
            "w8a8_decode_matmul": QLINEARS * (len(rows) - big + d["steps"]),
            "fp8_decode_matmul": 0,
            "rmsnorm": NORMS_PER_FORWARD * (len(rows) + d["steps"]),
            "wkv6": 0}
    if launches != want or min(v for k, v in launches.items()
                               if k not in ("fp8_decode_matmul",
                                            "wkv6")) == 0:
        raise AssertionError(f"launches {launches} != {want} (dispatch "
                             f"rows {rows}, {d['steps']} decode steps), or a "
                             "kernel of the path never launched")
    if d["syncs"] != d["cont"] + d["fresh"] + d["blocks"]:
        raise AssertionError(f"{d['syncs']} host syncs != chunk dispatches "
                             "+ decode blocks")
    if hit <= 0 or requant <= 0:
        raise AssertionError(f"prefix hits {hit}, requant events {requant}: "
                             "both must be > 0")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in records:
        if r["name"] in ("int8_matmul", "w8a8_decode_matmul"):
            r["launches"] = launches[r["name"]]
        if r["name"] == "int8_matmul":
            r["wgmma_launches"] = tc["int8_matmul"]
        if r["name"] == "w8a8_decode_matmul":
            r["tc_launches"] = tc["w8a8_decode_matmul"]

    repeat = rng.integers(0, vocab, 1200)
    runs = []
    for _ in range(2):
        before = eng.stats.prefill_tokens
        rid = eng.submit(repeat, max_new_tokens=16)
        req = eng.run_to_completion()[rid]
        runs.append((req.out_tokens, eng.stats.prefill_tokens - before,
                     req.prefix_hit_tokens))
    (tok_a, comp_a, _), (tok_b, comp_b, hit_b) = runs
    if tok_a != tok_b or hit_b != 1024 or comp_b != len(repeat) - hit_b:
        raise AssertionError(f"repeat: tokens equal {tok_a == tok_b}, "
                             f"computed {comp_a} then {comp_b} with "
                             f"{hit_b} cached tokens")

    # one decode step and one continuation chunk, kernels vs plain
    # versions, on int8 pools written by a first chunk
    n_s, pps = 4, 16
    alloc = PageAllocator(n_s * pps + 1, pps, n_s)
    cache = lm.init_paged_cache(n_s, n_s * pps + 1, pps, page_size=page)
    for s in range(n_s):
        alloc.alloc(s, pps)
    set_block_table_rows(cache, np.arange(n_s), alloc.table)
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.arange(n_s, device=dev)
    starts = torch.tensor([512, 768, 1024, 256], **i32)
    first = torch.as_tensor(rng.integers(0, vocab, (n_s, 1024)), device=dev)
    lm.prefill_paged(eng.params, first, cache, slots,
                     torch.zeros(n_s, **i32), starts)
    chunk = torch.as_tensor(rng.integers(0, vocab, (n_s, 512)), device=dev)
    lens = torch.tensor([512, 300, 512, 100], **i32)

    def cont():
        return lm.prefill_paged(eng.params, chunk, cache, slots, starts,
                                lens, max_pages=4)[0]

    # the quantized matmuls alone swapped: B4 / B5 give their plain
    # versions' bits, so the logits must be equal.  Then B1 / B2 on the
    # int8 pools, call by call (int8 activations would turn their rounding
    # differences into whole steps downstream, so logits cannot hold them)
    ext_k = cont()
    ext_m = _swap_plain(cont, ("matmul",))
    _, ext_calls, ext_share = _attention_calls_vs_plain(cont)
    nxt = torch.argmax(ext_k, -1).to(torch.int32)
    pos = (starts + lens).to(torch.int32)

    def decode():
        return lm.decode_step(eng.params, nxt, cache, pos)[0]

    dec_k = decode()
    dec_m = _swap_plain(decode, ("matmul",))
    _, dec_calls, dec_share = _attention_calls_vs_plain(decode)
    torch.cuda.synchronize()
    for tag, a, b in (("continuation", ext_k, ext_m),
                      ("decode", dec_k, dec_m)):
        if not (torch.isfinite(a).all() and tuple(a.shape) == (n_s, vocab)):
            raise AssertionError(f"{tag} logits not finite / wrong shape")
        if not torch.equal(a, b):
            raise AssertionError(
                f"{tag} logits with B4 / B5 differ from the plain matmuls' "
                f"(max abs {(a - b).abs().max().item():.3e})")
    errs = {"matmul_logits_equal": True,
            "attention_calls": [ext_calls, dec_calls],
            "attention_worst_share": [ext_share, dec_share]}
    out = {"tokens_per_s": n_tok / wall, "ttft_p50_s": statistics.median(ttft),
           "wall_s": wall, "tokens": n_tok, "requests": QSCHED_REQUESTS,
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "prefix_hit_tokens": hit, "cont_dispatches": d["cont"],
           "fresh_dispatches": d["fresh"], "decode_blocks": d["blocks"],
           "decode_steps": d["steps"], "syncs": d["syncs"],
           "dispatch_rows": rows, "requant_events": requant,
           "peak_mem_gb": peak_gb, "setup_peak_gb": setup_gb,
           "launches": launches, "tc_launches": tc,
           "repeat_computed": [comp_a, comp_b], "logit_check": errs}
    print(f"[9 qsched] {cfg.name} {cfg.num_layers}L int8 weights + int8 KV "
          f"SchedEngine fcfs, prefix cache, chunk 512: {QSCHED_REQUESTS} req "
          f"({out['prompt_tokens']} prompt tokens, {hit} from the prefix "
          f"cache), {n_tok} tokens in {wall:.3f}s ({n_tok / wall:.1f} "
          f"tok/s), TTFT p50 {out['ttft_p50_s']:.4f}s, {d['fresh']} fresh + "
          f"{d['cont']} continuation dispatches (rows {rows}) + "
          f"{d['blocks']} blocks = {d['syncs']} syncs, {d['steps']} decode "
          f"steps, {requant:.0f} requant events, launches {launches}, "
          f"tensor-core launches {tc} (B4: {tc['int8_matmul']} of "
          f"{launches['int8_matmul']} on the wgmma step; B5: "
          f"{tc['w8a8_decode_matmul']} of {launches['w8a8_decode_matmul']} on "
          f"the tensor-core step), peak "
          f"mem {peak_gb:.2f} GB (set-up {setup_gb:.2f} GB); repeat prompt computed {comp_a} then "
          f"{comp_b} tokens, same tokens; continuation and decode logits "
          f"with B4 / B5 equal to the plain matmuls'; B2 / B1 on the int8 "
          f"pools vs plain, element by element: {ext_calls} / {dec_calls} "
          f"calls, worst element {ext_share:.2f} / {dec_share:.2f} of its "
          f"limit")
    return out


def phase_fp8(records: list) -> dict:
    """qwen2-1.5b at full width, fp8 weights and fp8 KV pools, through the
    port's PagedEngine on phase 5's traffic: B6 on every linear of a
    dispatch with M <= 128 rows (decode steps; plain torch above, as in
    the reference), B1 on decode, B3 on admission."""
    torch = _torch()
    import numpy as np
    from repro_torch.serve.engine import PagedEngine
    cfg, lm, params, setup_gb = _quantized_lm("fp8", "fp8")
    eng = PagedEngine(lm, params, n_slots=8, max_len=1024, page_size=256,
                      decode_block=8, seed=SEED)
    rng = np.random.default_rng(SEED)                  # phase 5's traffic
    eng.submit(rng.integers(0, cfg.vocab_size, (64,)), max_new_tokens=8)
    eng.run_to_completion()
    n_req = 12
    plens = rng.integers(64, 513, n_req)
    max_new = rng.integers(32, 65, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in plens]
    steps0, syncs0 = eng.steps_run, eng.sync_count
    cnt0 = eng.metrics.snapshot()["counters"]
    rq0 = cnt0["serve_kv_requant_events_total"]
    blocks0 = int(cnt0["serve_decode_dispatches_total"])
    rows = _record_dispatch_rows(eng)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    tc = _tc_launches("fp8")
    steps = eng.steps_run - steps0
    requant = eng.metrics.snapshot()["counters"][
        "serve_kv_requant_events_total"] - rq0
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = done[i].out_tokens
        if len(got) != int(m) or not all(0 <= t < cfg.vocab_size
                                         for t in got):
            raise AssertionError(f"request {i}: {len(got)} tokens (want "
                                 f"{m}) or a token out of vocab")
        n_tok += len(got)
    small = sum(m <= 128 for m in rows)
    want = {"paged_attention": cfg.num_layers * steps,
            "flash_attention": cfg.num_layers * len(rows),
            "paged_prefix_extend": 0, "int8_matmul": 0,
            "w8a8_decode_matmul": 0,
            "fp8_decode_matmul": QLINEARS * (steps + small),
            "rmsnorm": NORMS_PER_FORWARD * (len(rows) + steps), "wkv6": 0}
    if launches != want or launches["fp8_decode_matmul"] == 0:
        raise AssertionError(f"launches {launches} != {want} (admission "
                             f"rows {rows}, {steps} decode steps)")
    blocks = int(eng.metrics.snapshot()["counters"][
        "serve_decode_dispatches_total"]) - blocks0
    if eng.sync_count - syncs0 != len(rows) + blocks:
        raise AssertionError(f"{eng.sync_count - syncs0} host syncs != "
                             f"{len(rows)} admissions + {blocks} blocks")
    if requant <= 0:
        raise AssertionError("no fp8 page scale changed in the drive")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in records:
        if r["name"] == "fp8_decode_matmul":
            r["launches"] = launches[r["name"]]
            r["tc_launches"] = tc[r["name"]]
    out = {"tokens_per_s": n_tok / wall, "ttft_p50_s": statistics.median(ttft),
           "wall_s": wall, "tokens": n_tok, "requests": n_req,
           "admission_rows": rows, "decode_steps": steps,
           "requant_events": requant, "peak_mem_gb": peak_gb,
           "setup_peak_gb": setup_gb, "launches": launches,
           "tc_launches": tc}
    print(f"[10 fp8] {cfg.name} {cfg.num_layers}L fp8 weights + fp8 KV "
          f"PagedEngine: {n_req} req, {n_tok} tokens in {wall:.3f}s "
          f"({n_tok / wall:.1f} tok/s), TTFT p50 {out['ttft_p50_s']:.4f}s, "
          f"{len(rows)} admissions (rows {rows}) + {blocks} blocks = "
          f"{len(rows) + blocks} syncs, {steps} decode steps, "
          f"{requant:.0f} requant events, launches {launches}, tensor-core "
          f"launches {tc}, peak mem "
          f"{peak_gb:.2f} GB (set-up {setup_gb:.2f} GB)")
    return out


def phase_trap4() -> None:
    """Whether the torch-op parts of the quantized path give the CPU's
    bits on the card: the row quantization before B4, the weight
    quantization and the KV quantize writes divide by a tensor; the same
    divisions by a Python scalar are shown beside them (PyTorch's CUDA
    kernel multiplies by the reciprocal there).  Fails if a port op drifts."""
    torch = _torch()
    from repro_torch.kernels.int8_matmul.ref import quantize_rowwise
    from repro_torch.kvcache.quant import quantize
    from repro_torch.quant.qops import quantize_linear
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn((4096, 1536), generator=g, device="cuda").bfloat16()
    kv = torch.randn((4096, 2, 128), generator=g, device="cuda") * 3
    w = torch.randn((1536, 8960), generator=g, device="cuda") * 0.02
    bad = {}
    for tag, fn, arg in (
            ("rowwise", lambda t: quantize_rowwise(t), x),
            ("kv int8", lambda t: quantize(t, torch.int8), kv),
            ("kv fp8", lambda t: quantize(t, torch.float8_e4m3fn), kv),
            ("weights int8", lambda t: tuple(quantize_linear(
                {"w": t}, quant="int8").values()), w),
            ("weights fp8", lambda t: tuple(quantize_linear(
                {"w": t}, quant="fp8").values()), w)):
        bad[tag] = sum(int((a.cpu().view(torch.uint8)
                            != b.view(torch.uint8)).sum())
                       for a, b in zip(fn(arg), fn(arg.cpu())))
    naive = {}
    for tag, t, c in (("amax/127 rows", x.float().abs().amax(-1), 127.0),
                      ("amax/448 kv", kv.abs().amax(-1), 448.0)):
        naive[tag] = int((torch.clamp(t, min=1e-8) / c).cpu().ne(
            torch.clamp(t.cpu(), min=1e-8) / c).sum())
    print(f"[trap4] port ops, bytes that differ card vs CPU: {bad}; "
          f"division by a Python scalar on the card, scales that differ: "
          f"{naive}")
    if any(bad.values()):
        raise AssertionError(f"port quantization drifts on the card: {bad}")


#: WKV-6 chunk and head dim of rwkv6-1.6b (the kernel's only head dim)
WKV_CHUNK, WKV_D, WKV_H = 64, 64, 32
#: element-wise limit of B8, relative to the root mean square of the
#: plain version's output: the reference's chunked-vs-scan tolerance
WKV_ATOL = 1e-4


def _wkv6_inputs(g, device, b, s, dt, s0_scale, strong=False):
    """WKV-6 operands with the reference tests' distributions
    (``test_kernels.py``): r, v ~ N(0, 1), k ~ 0.3 N, logw = -0.1|N| - 0.01,
    u ~ 0.1 N; ``strong`` decays instead as -exp(N), down to about -50."""
    torch = _torch()
    shape = (b, s, WKV_H, WKV_D)
    r = torch.randn(shape, generator=g, device=device).to(dt)
    k = (torch.randn(shape, generator=g, device=device) * 0.3).to(dt)
    v = torch.randn(shape, generator=g, device=device).to(dt)
    n = torch.randn(shape, generator=g, device=device)
    lw = -torch.exp(n) if strong else -n.abs() * 0.1 - 0.01
    u = torch.randn((WKV_H, WKV_D), generator=g, device=device) * 0.1
    s0 = torch.randn((b, WKV_H, WKV_D, WKV_D), generator=g,
                     device=device) * s0_scale
    return r, k, v, lw, u, s0


def wkv6_bytes_ops(args) -> tuple:
    """Bytes the call must move (r/k/v in their type, logw and o in fp32,
    u, s0 and s_final once) and the operations of the chunked form for
    these inputs' real tokens: per chunk of n tokens and head, the
    n(n+1)/2 scored pairs x D channels at 4 operations (exponential, two
    products, a sum), their n(n+1)/2 x D products with v at 2, the state's
    n x D x D read and update at 2 each, and the per-channel decays."""
    r, _, _, lw, u, s0 = args
    b, s, h, d = r.shape
    nbytes = (3 * r.numel() * r.element_size() + 2 * lw.numel() * 4
              + u.numel() * 4 + 2 * s0.numel() * 4)
    ops = 0.0
    for c0 in range(0, s, WKV_CHUNK):
        n = min(WKV_CHUNK, s - c0)
        pairs = n * (n + 1) / 2
        ops += pairs * d * 6 + 4 * n * d * d + 2 * d * d + 6 * n * d
    return nbytes, ops * b * h


def _check_rms(tag: str, out, ref, atol_rel: float) -> float:
    """Hold ``out`` to ``ref`` element by element within ``atol_rel`` x
    the root mean square of ``ref``; returns the worst element's share."""
    torch = _torch()
    o, r = out.float().cpu(), ref.float().cpu()
    if out.shape != ref.shape or not torch.isfinite(o).all():
        raise AssertionError(f"{tag}: output {tuple(out.shape)} not finite "
                             f"or not of shape {tuple(ref.shape)}")
    lim = atol_rel * max(r.pow(2).mean().sqrt().item(), 1e-30)
    worst = (o - r).abs().max().item() / lim
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: an element is {worst:.2f} x its limit "
                             f"{lim:.2e}")
    return worst


def phase_wkv6(records: list) -> None:
    """B8 vs its plain version on CPU copies of the operands, element by
    element (o and s_final within 1e-4 x their rms): B 1, H 32, D 64, S in
    {1, 16, 17, 64, 100, 3,000}, and B 4, S 512; zero and non-zero s0,
    bf16 and fp32 r/k/v, one case with strong decays.  Then its time at
    one admission of phase 13 (B 1, S 2,048, bf16)."""
    torch = _torch()
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 11)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(1, s, dt, s0, False) for s in (1, 16, 17, 64, 100, 3000)
             for dt in (bf16, f32) for s0 in (0.0, 0.2)]
    cases += [(4, 512, dt, s0, False) for dt in (bf16, f32)
              for s0 in (0.0, 0.2)]
    cases.append((1, 100, f32, 0.2, True))
    worst, err = 0.0, 0.0
    for b, s, dt, s0_scale, strong in cases:
        args = _wkv6_inputs(g, device, b, s, dt, s0_scale, strong)
        o, s_fin = ops.wkv6(*args)
        torch.cuda.synchronize()
        r, k, v, lw, u, s0 = (x.float().cpu() for x in args)
        o_ref, s_ref = wkv6_chunked_ref(r, k, v, lw, u, s0)
        tag = (f"B{b} S{s} {str(dt)[6:]} s0 {s0_scale}"
               + (" strong decay" if strong else ""))
        worst = max(worst, _check_rms(f"wkv6 o {tag}", o, o_ref, WKV_ATOL),
                    _check_rms(f"wkv6 s_final {tag}", s_fin, s_ref,
                               WKV_ATOL))
        err = max(err, (o.cpu() - o_ref).abs().max().item())
    n_cases = len(cases)

    def timed():
        return _wkv6_inputs(g, device, 1, 2048, bf16, 0.0)

    copies = [timed() for _ in range(4)]
    ms = time_ms(ops.wkv6, copies, reps=10)
    plain_ms = time_ms(lambda r, k, v, lw, u, s0: wkv6_chunked_ref(
        r.float(), k.float(), v.float(), lw, u, s0), copies[:2], reps=3,
        rounds=3)
    nbytes, n_ops = wkv6_bytes_ops(copies[0])
    # the kernel runs its products on the TF32 tensor cores, so that is
    # the rate of its bound; the fp32 FMA figure is the row's earlier bound
    b_ms, b_by = bound(nbytes, n_ops, "tfloat32")
    b_fp32_ms, b_fp32_by = bound(nbytes, n_ops, "float32")
    records.append({"name": "wkv6", "route": "cuda",
                    "source": "src/repro_torch/csrc/wkv6.cu",
                    "replaces": "src/repro/kernels/wkv6/wkv6.py:70",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "bound_fp32_ms": b_fp32_ms, "bound_fp32_by": b_fp32_by,
                    "shape": [1, 2048, WKV_H, WKV_D], "launches": 0})
    print(f"[11 wkv6] {n_cases} cases vs the plain version on CPU copies: "
          f"worst element {worst:.3f} of its limit ({WKV_ATOL} x rms), max "
          f"abs err of o {err:.3e}; B1 S2048 H32 D64 bf16: ms {ms:.4f} "
          f"plain {plain_ms:.4f} bound {b_ms:.4f} ({b_by}, TF32 tensor-core "
          f"rate; at the fp32 FMA rate {b_fp32_ms:.4f}, {b_fp32_by}); no "
          "PyTorch call computes WKV-6")


#: (shape, x dtype, scale dtype) of phase 12: the reference's test_rmsnorm
#: sweep; qwen2-1.5b's rows of a 4,096-row chunk and of an 8-slot decode
#: step, llama3.2-1b's 2,048 (the warp step's longest); row counts that
#: are not a multiple of a block's 8 warps, an fp32 scale under bf16 x;
#: then the long-row step: d 8,192 and a d of no whole 16-byte vectors
#: (1,001).  d 1,000 fills 16-byte vectors in both types (2,000 / 4,000
#: bytes a row), so it takes the warp step.
RMSNORM_CASES = [(shape, dt, dt) for shape in ((4, 64, 256), (2, 128, 512),
                                               (1, 8, 128))
                 for dt in ("float32", "bfloat16")]
RMSNORM_CASES += [((4096, 1536), "bfloat16", "bfloat16"),
                  ((8, 1536), "bfloat16", "bfloat16"),
                  ((8, 2048), "bfloat16", "bfloat16"),
                  ((8, 2048), "float32", "float32"),
                  ((4099, 2048), "float32", "float32"),
                  ((13, 1536), "bfloat16", "bfloat16"),
                  ((13, 1536), "bfloat16", "float32"),
                  ((5, 1000), "bfloat16", "bfloat16"),
                  ((5, 1000), "float32", "float32"),
                  ((3, 8192), "bfloat16", "bfloat16"),
                  ((3, 8192), "float32", "float32"),
                  ((7, 1001), "bfloat16", "bfloat16"),
                  ((7, 1001), "float32", "float32")]


def _rmsnorm_warp_step(d: int, dt_name: str) -> bool:
    """Whether B7 takes its warp step on contiguous, fresh tensors: rows
    of at most 2,048 elements that are a whole number of 16-byte vectors."""
    return d <= 2048 and d % (8 if dt_name == "bfloat16" else 4) == 0
#: rounds of B7 against F.rms_norm in turns (phase 12)
RMSNORM_ROUNDS = 8


def _within_one_ulp(tag: str, out, ref) -> float:
    """bf16: every element within one unit in the last place of the plain
    version's value; fp32: within 1e-6 of it, relative.  Returns the worst
    element's share of its limit."""
    torch = _torch()
    o, r = out.cpu().float(), ref.float()
    if out.shape != ref.shape or not torch.isfinite(o).all():
        raise AssertionError(f"{tag}: not finite or wrong shape")
    if ref.dtype == torch.bfloat16:
        _, e = torch.frexp(r)                    # |r| = m 2^e, m in [.5, 1)
        lim = torch.ldexp(torch.ones_like(r), e - 8)
    else:
        lim = 1e-6 * r.abs()
    worst = ((o - r).abs() / lim.clamp(min=1e-30)).max().item()
    if not worst <= 1.0:
        raise AssertionError(f"{tag}: an element is {worst:.2f} x its limit")
    return worst


def phase_rmsnorm(records: list, drive_launches: dict,
                  drive_warp_launches: dict) -> None:
    """B7 vs its plain version on CPU copies at RMSNORM_CASES, within one
    bf16 ulp (fp32: 1e-6 relative); each case names its step (warp or
    long-row) and fails on the wrong one, and the same call twice gives
    the same bits.  Times at the 4,096-row chunk and the 8-row decode
    step, beside ``F.rms_norm``, then the two in turns over RMSNORM_ROUNDS
    rounds at the chunk (the ratio's median and spread).
    ``drive_launches`` / ``drive_warp_launches``: B7's launches, and those
    on its warp step, in each drive that ran it (phases 5, 7, 9, 10)."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 12)
    worst, err = 0.0, 0.0
    steps = {"warp": 0, "long-row": 0}
    for shape, dt_name, w_name in RMSNORM_CASES:
        dt = getattr(torch, dt_name)
        x = torch.randn(shape, generator=g, device=device).to(dt)
        w = torch.randn(shape[-1:], generator=g, device=device).to(
            getattr(torch, w_name))
        tag = f"rmsnorm {shape} {dt_name} (scale {w_name})"
        warp0 = ops.warp_launches
        out = ops.rmsnorm(x, w)
        warp = ops.warp_launches - warp0
        want = _rmsnorm_warp_step(shape[-1], dt_name)
        if warp != int(want):
            raise AssertionError(f"{tag}: {warp} warp-step launches, want "
                                 f"{int(want)}")
        steps["warp" if warp else "long-row"] += 1
        again = ops.rmsnorm(x, w)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"{tag}: two calls on the same rows differ")
        ref = rmsnorm_ref(x.cpu(), w.cpu())
        worst = max(worst, _within_one_ulp(tag, out, ref))
        err = max(err, (out.cpu().float() - ref.float()).abs().max().item())

    def timed(rows):
        x = torch.randn((rows, 1536), generator=g, device=device).bfloat16()
        return x, torch.ones((1536,), device=device, dtype=torch.bfloat16)

    times = {}
    for rows in (4096, 8):
        copies = [timed(rows) for _ in range(n_copies(rows * 1536 * 4))]
        times[rows] = (
            time_ms(ops.rmsnorm, copies),
            time_ms(rmsnorm_ref, copies, reps=5, rounds=3),
            time_ms(lambda x, w: F.rms_norm(x, (1536,), w, 1e-5), copies),
            bound(rows * 1536 * 4 + 1536 * 2, 4.0 * rows * 1536,
                  "float32"))
    ms, plain_ms, lib_ms, (b_ms, b_by) = times[4096]
    # B7 and F.rms_norm at (4,096, 1,536) bf16 in turns, each round
    # starting with the other one, on the same cycled copies
    copies = [timed(4096) for _ in range(n_copies(4096 * 1536 * 4))]
    lib = lambda x, w: F.rms_norm(x, (1536,), w, 1e-5)  # noqa: E731
    ratios = []
    for rnd in range(RMSNORM_ROUNDS):
        pair = (ops.rmsnorm, lib) if rnd % 2 == 0 else (lib, ops.rmsnorm)
        t = [time_ms(fn, copies, rounds=3) for fn in pair]
        ratios.append(t[0] / t[1] if rnd % 2 == 0 else t[1] / t[0])
    retime = {"rounds": RMSNORM_ROUNDS,
              "median_ratio": statistics.median(ratios),
              "min_ratio": min(ratios), "max_ratio": max(ratios)}
    records.append({"name": "rmsnorm", "route": "cuda",
                    "source": "src/repro_torch/csrc/rmsnorm.cu",
                    "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "shape": [4096, 1536],
                    "launches": sum(drive_launches.values()),
                    "launches_by_drive": drive_launches,
                    "warp_launches": sum(drive_warp_launches.values()),
                    "step_cases": steps,
                    "vs_library_in_turns": retime,
                    "decode_rows_ms": {"ms": times[8][0],
                                       "plain_ms": times[8][1],
                                       "library_ms": times[8][2],
                                       "bound_ms": times[8][3][0]}})
    print(f"[12 rmsnorm] {len(RMSNORM_CASES)} cases ({steps['warp']} on the "
          f"warp step, {steps['long-row']} on the long-row step, each as "
          f"expected) vs the plain version on CPU copies: worst element "
          f"{worst:.3f} of one bf16 ulp (fp32: 1e-6 relative), max abs err "
          f"{err:.3e}, repeat calls bit-equal; "
          + "; ".join(f"({rows}, 1536) bf16: ms {t[0]:.4f} plain {t[1]:.4f} "
                      f"F.rms_norm {t[2]:.4f} bound {t[3][0]:.6f} "
                      f"({t[3][1]})" for rows, t in times.items())
          + f"; B7 / F.rms_norm at (4096, 1536) bf16 in {RMSNORM_ROUNDS} "
          f"rounds in turns: median {retime['median_ratio']:.4f}, spread "
          f"{retime['min_ratio']:.4f}-{retime['max_ratio']:.4f}"
          + f"; launches in the drives {drive_launches}, on the warp step "
          f"{drive_warp_launches}")


def _wkv6_calls_vs_plain(fn) -> tuple:
    """Run ``fn()`` with every B8 launch also computed by its plain
    version on the same inputs and held to it element by element, o and
    the final state within WKV_ATOL x their rms (phase 11's rule); the
    forward goes on with the kernel's output.  Returns (fn's result,
    calls checked, the worst element's share of its limit)."""
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
    shares = []
    b8 = wops.wkv6

    def checked(r, k, v, lw, u, s0):
        o, s_fin = b8(r, k, v, lw, u, s0)
        o_ref, s_ref = wkv6_chunked_ref(r.float(), k.float(), v.float(), lw,
                                        u, s0)
        tag = f"wkv6 call {len(shares)}"
        shares.append(max(_check_rms(f"{tag} o", o, o_ref, WKV_ATOL),
                          _check_rms(f"{tag} s_final", s_fin, s_ref,
                                     WKV_ATOL)))
        return o, s_fin

    wops.wkv6 = checked
    try:
        return fn(), len(shares), max(shares)
    finally:
        wops.wkv6 = b8


RWKV_LAYERS = 24           # rwkv6-1.6b's full depth
RWKV_REQUESTS = 16


def phase_rwkv(records: list) -> dict:
    """rwkv6-1.6b at full width through the port's eager ``Engine``: 8
    slots, ``max_len`` 4096, greedy; 16 requests of 200-3,000 prompt
    tokens and 32-64 new tokens.  B8 in every layer of every admission."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.obs.trace import PID_ENGINE
    from repro_torch.serve.engine import Engine
    cfg = get_config("rwkv6-1.6b").with_(num_layers=RWKV_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    setup_gb = _setup_peak_gb()
    tracer = Tracer(enabled=True)
    eng = Engine(lm, params, n_slots=8, max_len=4096, seed=SEED,
                 tracer=tracer)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 13)
    vocab = cfg.vocab_size
    # warm-up and the fresh-slot arm of the reuse check: one prompt served
    # alone in a slot no request has used
    repeat = rng.integers(0, vocab, 777)
    rid = eng.submit(repeat, max_new_tokens=16)
    fresh = eng.run_to_completion()[rid].out_tokens
    torch.cuda.synchronize()
    plens = rng.integers(200, 3001, RWKV_REQUESTS)
    max_new = rng.integers(32, 65, RWKV_REQUESTS)
    prompts = [rng.integers(0, vocab, (int(n),)) for n in plens]

    def engine_spans(since: int) -> tuple:
        ev = tracer.events[since:]
        return (sum(e["name"] == "prefill" and e["ph"] == "X" for e in ev),
                sum(e["name"] == "decode_step" and e["ph"] == "X"
                    and e["pid"] == PID_ENGINE for e in ev))

    n_ev, syncs0 = len(tracer.events), eng.sync_count
    phase0 = (eng.t_prefill_s, eng.t_decode_s)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    admits, steps = engine_spans(n_ev)
    syncs = eng.sync_count - syncs0
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = done[i].out_tokens
        if len(got) != int(m) or not all(0 <= t < vocab for t in got):
            raise AssertionError(f"request {i}: {len(got)} tokens (want "
                                 f"{m}) or a token out of vocab")
        n_tok += len(got)
    if admits != RWKV_REQUESTS or syncs != admits + steps:
        raise AssertionError(f"{syncs} host syncs != {admits} admissions + "
                             f"{steps} decode steps (want {RWKV_REQUESTS} "
                             "admissions)")
    want = {k: 0 for k in launches}
    want["wkv6"] = cfg.num_layers * admits
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} (24 x "
                             "admissions of B8, no other kernel)")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t_pre, t_dec = (eng.t_prefill_s - phase0[0], eng.t_decode_s - phase0[1])
    for r in records:
        if r["name"] == "wkv6":
            r["launches"] = launches["wkv6"]

    # the warm-up prompt again, now in a slot other requests have used:
    # the same tokens (the state is zeroed at admission)
    rid = eng.submit(repeat, max_new_tokens=16)
    reused = eng.run_to_completion()[rid].out_tokens
    if reused != fresh:
        raise AssertionError(f"a reused slot changed the stream: {fresh} "
                             f"then {reused}")

    # one admission, the drive's longest prompt: every B8 call held to its
    # plain version element by element (phase 11's rule).  Its logits are
    # read against the plain version's, beside what a 1e-6 relative nudge
    # of logw moves them: a random-weight RWKV-6 at full width turns
    # rounding-level differences into several percent of its logits, so
    # logits cannot hold B8 to anything tighter than the nudge does
    longest = prompts[int(np.argmax(plens))]
    lk, calls, share = _wkv6_calls_vs_plain(
        lambda: eng._prefill_slot(longest, 0))
    if calls != cfg.num_layers or not (torch.isfinite(lk).all()
                                       and tuple(lk.shape) == (vocab,)):
        raise AssertionError(f"rwkv admission: {calls} B8 calls checked, "
                             f"logits finite {bool(torch.isfinite(lk).all())}"
                             f" of shape {tuple(lk.shape)}")
    lp = _swap_plain(lambda: eng._prefill_slot(longest, 0), ("wkv",))
    ln = _swap_plain(lambda: eng._prefill_slot(longest, 0), ("wkv_nudged",))
    torch.cuda.synchronize()

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()

    spread = {"kernel_vs_plain": rel_l2(lk, lp),
              "plain_vs_nudged_plain": rel_l2(ln, lp)}
    out = {"tokens_per_s": n_tok / wall, "ttft_p50_s": statistics.median(ttft),
           "wall_s": wall, "tokens": n_tok, "requests": RWKV_REQUESTS,
           "prompt_tokens": int(plens.sum()), "admissions": admits,
           "decode_steps": steps, "syncs": syncs, "peak_mem_gb": peak_gb,
           "setup_peak_gb": setup_gb, "setup_s": t_setup,
           "prefill_wall_s": t_pre, "decode_wall_s": t_dec,
           "launches": launches, "wkv6_calls_checked": calls,
           "wkv6_worst_share": share, "logit_rel_l2": spread,
           "logit_prompt_tokens": len(longest)}
    print(f"[13 rwkv] {cfg.name} {cfg.num_layers}L d{cfg.d_model} bf16 "
          f"Engine, 8 slots: {RWKV_REQUESTS} req ({out['prompt_tokens']} "
          f"prompt tokens, {int((plens % 64 != 0).sum())} not a multiple of "
          f"64), {n_tok} tokens in {wall:.3f}s ({n_tok / wall:.1f} tok/s), "
          f"TTFT p50 {out['ttft_p50_s']:.4f}s, {admits} admissions + {steps} "
          f"decode steps = {syncs} syncs, wall in admissions {t_pre:.3f}s / "
          f"decode steps {t_dec:.3f}s, launches {launches['wkv6']} B8, "
          f"peak mem {peak_gb:.2f} GB (set-up {setup_gb:.2f} GB); a prompt "
          f"in a reused slot gave the fresh slot's {len(fresh)} tokens; a "
          f"{len(longest)}-token admission: {calls} B8 calls vs plain, "
          f"worst element {share:.3f} of its limit; its logits' relative "
          f"L2, B8 vs plain {spread['kernel_vs_plain']:.3e}, plain vs plain "
          f"with logw x (1 + 1e-6) {spread['plain_vs_nudged_plain']:.3e}; "
          f"setup {t_setup:.1f}s")
    return out


SPEC_REQUESTS = 8           # phase 14 (a): n-gram arm
SPEC_DRAFT_REQUESTS = 4     # phase 14 (b): draft-LM arm
SPEC_F32_LAYERS = 4         # phase 14 (c): float32 identity depth
#: RMSNorm launches of one forward of phase 14's draft LM (1 layer)
DRAFT_NORMS = 2 * 1 + 1


def _spec_counts(eng, tracer, since_events: int) -> dict:
    """Dispatch counts of a speculative drive: phase 7's chunk and decode
    counts, the verify rounds and drafts, and the drafter's own syncs and
    steps (the draft-LM arm)."""
    c = _counts(eng, tracer, since_events)
    st = eng.spec_stats
    c.update(verify=st.verify_steps, proposed=st.drafts_proposed,
             accepted=st.drafts_accepted, slot_steps=st.slot_steps,
             spec_tokens=st.spec_tokens, fallback=st.fallback_steps,
             draft_syncs=getattr(eng.drafter, "syncs", 0),
             draft_steps=getattr(eng.drafter, "steps", 0))
    return c


def _spec_drive(eng, tracer, prompts, max_new, tag: str,
                draft_norms: int = 0) -> dict:
    """Serve ``prompts`` through a speculative engine with the launch
    counts zeroed just before and read just after; check token counts,
    host syncs and every kernel's launches against the dispatches run,
    and that verify rounds ran and drafts were proposed."""
    torch = _torch()
    cfg = eng.lm.cfg
    base = _spec_counts(eng, tracer, 0)
    n_ev = len(tracer.events)
    syncs0 = eng.sync_count
    phase0 = (eng.t_prefill_s, eng.t_decode_s)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_launches().items()
                if k in ("paged_attention", "flash_attention",
                         "paged_prefix_extend", "rmsnorm")}
    tc = _tc_launches(tag)
    now = _spec_counts(eng, tracer, n_ev)
    d = {k: now[k] - base[k] for k in now if k not in ("cont", "fresh")}
    d["cont"], d["fresh"] = now["cont"], now["fresh"]
    d["syncs"] = eng.sync_count - syncs0
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = done[i].out_tokens
        if len(got) != int(m):
            raise AssertionError(f"{tag} request {i}: {len(got)} tokens, "
                                 f"want {m}")
        if not all(0 <= t < cfg.vocab_size for t in got):
            raise AssertionError(f"{tag} request {i}: token out of vocab")
        n_tok += len(got)
    if d["syncs"] != d["cont"] + d["fresh"] + d["verify"] + d["blocks"]:
        raise AssertionError(
            f"{tag}: {d['syncs']} host syncs != {d['cont']} + {d['fresh']} "
            f"chunk dispatches + {d['verify']} verify rounds + "
            f"{d['blocks']} fallback decode blocks")
    layers = cfg.num_layers
    want = {"paged_prefix_extend": layers * (d["cont"] + d["verify"]),
            "flash_attention": layers * d["fresh"],
            "paged_attention": layers * d["steps"],
            "rmsnorm": NORMS_PER_FORWARD * (d["cont"] + d["fresh"]
                                            + d["verify"] + d["steps"])
            + draft_norms * d["draft_steps"]}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want} (28 x "
                             "(continuations + verify rounds) / fresh "
                             "chunks / fallback decode steps, 57 x target "
                             f"forwards + {draft_norms} x draft steps)")
    if d["verify"] <= 0 or d["proposed"] <= 0 \
            or launches["paged_prefix_extend"] <= 0:
        raise AssertionError(f"{tag}: {d['verify']} verify rounds, "
                             f"{d['proposed']} drafts proposed")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    return {"tokens_per_s": n_tok / wall,
            "ttft_p50_s": statistics.median(ttft), "wall_s": wall,
            "tokens": n_tok, "requests": len(ids),
            "prompt_tokens": int(sum(len(p) for p in prompts)),
            "acceptance_rate": d["accepted"] / max(d["proposed"], 1),
            "tokens_per_slot_step": d["spec_tokens"] / max(d["slot_steps"],
                                                          1),
            "verify_rounds": d["verify"], "drafts_proposed": d["proposed"],
            "drafts_accepted": d["accepted"],
            "fallback_blocks": d["blocks"], "fallback_steps": d["steps"],
            "fresh_dispatches": d["fresh"], "cont_dispatches": d["cont"],
            "syncs": d["syncs"], "draft_syncs": d["draft_syncs"],
            "draft_steps": d["draft_steps"],
            "prefill_wall_s": eng.t_prefill_s - phase0[0],
            "decode_wall_s": eng.t_decode_s - phase0[1],
            "launches": launches, "tc_launches": tc,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _verify_round_vs_plain(lm, params, prefixes, rng, page=256):
    """One verify round of 8 slots at W 5 over ``prefixes`` (written by
    512-token chunks of ``prefill_paged``): every B2 call held to its plain
    version element by element, and the logits of every live query row
    with kernels vs plain versions within LOGIT_REL_L2."""
    torch = _torch()
    import numpy as np
    from repro_torch.serve.engine import _pow2_bucket
    from repro_torch.serve.paged import PageAllocator, set_block_table_rows
    n_s, w = len(prefixes), 5
    pps = -(-max(prefixes) // page)
    alloc = PageAllocator(n_s * pps + 1, pps, n_s)
    cache = lm.init_paged_cache(n_s, n_s * pps + 1, pps, page_size=page)
    for s in range(n_s):
        alloc.alloc(s, pps)
    set_block_table_rows(cache, np.arange(n_s), alloc.table)
    dev = torch.device("cuda")
    i32 = dict(dtype=torch.int32, device=dev)
    pre = np.asarray(prefixes, np.int32)
    vocab = lm.cfg.vocab_size
    slots = torch.arange(n_s, device=dev)
    for c0 in range(0, int(pre.max()), 512):
        toks = torch.as_tensor(rng.integers(0, vocab, (n_s, 512)),
                               device=dev)
        lens = torch.as_tensor(np.clip(pre - c0, 0, 512), **i32)
        lm.prefill_paged(params, toks, cache, slots,
                         torch.full((n_s,), c0, **i32), lens)
    fed = torch.as_tensor(rng.integers(0, vocab, (n_s, w)), device=dev)
    widths = np.asarray([5, 5, 5, 4, 3, 2, 1, 5][:n_s], np.int32)
    lens_t = torch.as_tensor(pre, **i32)
    wid_t = torch.as_tensor(widths, **i32)
    mp = min(_pow2_bucket(pps, lo=1), pps)

    def verify():
        stage = lm.init_cache(n_s, w, kv_dtype="bfloat16")
        return lm.verify_paged(params, fed, cache, stage, lens_t, wid_t,
                               max_pages=mp)[0]

    ver_k, calls, share = _attention_calls_vs_plain(verify)
    ver_p = _swap_plain(verify)
    torch.cuda.synchronize()
    live = torch.arange(w, device=dev)[None, :] < wid_t[:, None]
    rel, err = _worst_slot_rel_l2("verify round", ver_k[live], ver_p[live],
                                  (int(widths.sum()), vocab))
    return {"b2_calls": calls, "b2_worst_share": share,
            "logit_rel_l2": rel, "logit_max_abs": err}


def _verify_shape_times(prefixes, g) -> dict:
    """B2 at the verify shape (8 slots x W 5 over ``prefixes``, 12 heads
    over 2, D 128, bf16 pools) timed beside its plain version, its bound,
    SDPA with an explicit mask, and 5 x B1 over the same prefixes (five
    decode steps' attention)."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_prefix_extend_ref
    dev = torch.device("cuda")
    pps = -(-max(prefixes) // 256)
    w = 5

    def ext():
        return _extend_inputs("bfloat16", g, dev, list(prefixes),
                              [w] * len(prefixes), w, pps=pps)

    copies = [ext() for _ in range(4)]
    tc0 = ops.extend_tc_launches
    out = ops.paged_prefix_extend_attention(*copies[0])
    ref = paged_prefix_extend_ref(*copies[0])
    torch.cuda.synchronize()
    line = check_close("verify shape bfloat16 W5 x 8 slots"
                       + _step_tag(ops.extend_tc_launches - tc0, True),
                       out, ref, 1.0)
    nbytes, flops = extend_bytes_flops(copies[0])
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    ms = time_ms(ops.paged_prefix_extend_attention, copies, reps=20)
    plain_ms = time_ms(paged_prefix_extend_ref, copies[:2], reps=3, rounds=3)
    lib_in = [_extend_sdpa_inputs(a) for a in copies[:2]]
    lib_ms = time_ms(lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mm, enable_gqa=True), lib_in, reps=20)
    dec = [_paged_inputs("bfloat16", g, dev, list(prefixes), pps=pps)
           for _ in range(4)]
    b1_ms = time_ms(ops.paged_attention, dec, reps=20)
    return {"shape": [len(prefixes), w, 12, 128], "prefixes": list(prefixes),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "b1_ms": b1_ms,
            "b1_x5_ms": 5 * b1_ms, "check": line}


def _identity_arm(lm, params, prompts, max_new, **spec_kw) -> dict:
    """The float32 identity check of one arm: the speculative engine's
    greedy streams against the plain scheduler's on the same settings."""
    from repro_torch.sched import SchedEngine
    from repro_torch.spec import SpecEngine
    kw = dict(policy="fcfs", prefix_cache=True, n_slots=8, max_len=2048,
              page_size=256, prefill_chunk=512, decode_block=8, seed=SEED)
    streams = []
    for cls, extra in ((SchedEngine, {}), (SpecEngine, spec_kw)):
        eng = cls(lm, params, **kw, **extra)
        ids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        done = eng.run_to_completion()
        streams.append([done[i].out_tokens for i in ids])
    same = sum(a == b for a, b in zip(*streams))
    tele = eng.telemetry()["spec"]
    return {"equal_streams": same, "streams": len(prompts),
            "acceptance_rate": tele["acceptance_rate"],
            "verify_rounds": tele["verify_steps"]}


def phase_spec(records: list) -> dict:
    """Speculative decoding through the port's SpecEngine: (a) qwen2-1.5b
    at full width, bf16, n-gram drafts over phase 7's scheduler settings;
    (b) the draft-LM arm (``draft_config_of``: 1 layer, d 384, contiguous
    bf16 cache); (c) float32 at 4 layers, full width: the n-gram arm on
    bf16 and int8 pools, self-speculation, a random shrunk draft, and the
    n-gram and shrunk-draft arms on int8 weights give the plain
    scheduler's greedy streams token for token."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import passage_prompt
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.quant import quantize_tree
    from repro_torch.spec import SpecEngine, draft_config_of
    cfg = get_config("qwen2-1.5b").with_(num_layers=E2E_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    setup_gb = _setup_peak_gb()
    vocab = cfg.vocab_size
    rng = np.random.default_rng(SEED + 14)
    kw = dict(policy="fcfs", prefix_cache=True, n_slots=8, max_len=4096,
              page_size=256, prefill_chunk=512, decode_block=8, seed=SEED)

    # (a) n-gram arm, adaptive k up to 4
    tracer = Tracer(enabled=True)
    eng = SpecEngine(lm, params, spec="ngram", draft_k=4, adaptive=True,
                     tracer=tracer, **kw)
    eng.submit(passage_prompt(rng, vocab, 700), max_new_tokens=16)
    eng.run_to_completion()                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plens = rng.integers(600, 3001, SPEC_REQUESTS)
    prompts = [passage_prompt(rng, vocab, int(n)) for n in plens]
    ngram = _spec_drive(eng, tracer, prompts, [64] * SPEC_REQUESTS,
                        "spec ngram")
    ngram["setup_peak_gb"] = setup_gb
    for r in records:
        if r["name"] in ngram["launches"]:
            r.setdefault("launches_by_drive", {})["spec_ngram"] = \
                ngram["launches"][r["name"]]
    # a repeated prompt: the same tokens, the second time from the
    # prefix cache (both runs' last chunk starts at 1,024)
    repeat = passage_prompt(rng, vocab, 1200)
    runs = []
    for _ in range(2):
        rid = eng.submit(repeat, max_new_tokens=32)
        runs.append(eng.run_to_completion()[rid].out_tokens)
    if runs[0] != runs[1]:
        raise AssertionError("spec: a repeated prompt gave other tokens")
    check = _verify_round_vs_plain(lm, eng.params, sorted(int(p)
                                                          for p in plens),
                                   rng)
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    vshape = _verify_shape_times(sorted(int(p) for p in plens), g)
    for r in records:
        if r["name"] == "paged_prefix_extend":
            r["verify_shape"] = {k: v for k, v in vshape.items()
                                 if k != "check"}
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # (b) draft-LM arm: a shrunk random-weight draft drafting every round
    dcfg = draft_config_of(cfg)
    draft_lm = LM(dcfg, device="cuda")
    draft_params = draft_lm.init(SEED + 1)
    tracer = Tracer(enabled=True)
    eng = SpecEngine(lm, params, spec="draft", draft_lm=draft_lm,
                     draft_params=draft_params, draft_k=4, adaptive=False,
                     tracer=tracer, **kw)
    torch.cuda.reset_peak_memory_stats()
    dlens = rng.integers(200, 601, SPEC_DRAFT_REQUESTS)
    dprompts = [passage_prompt(rng, vocab, int(n)) for n in dlens]
    draft = _spec_drive(eng, tracer, dprompts, [32] * SPEC_DRAFT_REQUESTS,
                        "spec draft", draft_norms=DRAFT_NORMS)
    if draft["draft_syncs"] <= 0 \
            or draft["draft_syncs"] > draft["verify_rounds"] \
            + draft["fallback_blocks"]:
        raise AssertionError(f"spec draft: {draft['draft_syncs']} draft "
                             "syncs for "
                             f"{draft['verify_rounds']} verify rounds")
    del eng, lm, params, draft_lm, draft_params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) float32 identity at 4 layers, full width
    cfg32 = get_config("qwen2-1.5b").with_(num_layers=SPEC_F32_LAYERS,
                                           dtype="float32")
    lm32 = LM(cfg32, device="cuda")
    params32 = lm32.init(SEED)
    dlm32 = LM(draft_config_of(cfg32), device="cuda")
    lm_q = LM(cfg32.with_(quant="int8"), device="cuda")
    params_q = quantize_tree(params32, quant="int8")
    dlm_q = LM(draft_config_of(lm_q.cfg), device="cuda")
    iprompts = [passage_prompt(rng, vocab, int(n))
                for n in rng.integers(150, 401, 4)]
    ident = {
        "ngram_bf16": _identity_arm(lm32, params32, iprompts, 24,
                                    spec="ngram", draft_k=4),
        "ngram_int8": _identity_arm(
            LM(cfg32.with_(kv_cache_dtype="int8"), device="cuda"),
            params32, iprompts, 24, spec="ngram", draft_k=4),
        "draft_self": _identity_arm(lm32, params32, iprompts, 24,
                                    spec="draft", draft_lm=lm32,
                                    draft_params=params32, draft_k=4,
                                    adaptive=False),
        # a random shrunk draft: nearly every draft is rejected, so the
        # streams hold the rollback (commit of accepted tokens only)
        "draft_shrunk": _identity_arm(lm32, params32, iprompts, 24,
                                      spec="draft", draft_lm=dlm32,
                                      draft_params=dlm32.init(SEED + 1),
                                      draft_k=4, adaptive=False),
        # int8 weights (W8A8): the verify's M = 8 slots x 5 rows on B5,
        # and a random shrunk draft quantized like the target, as
        # launch/serve.py builds it (adaptive n-gram k waits for A5)
        "ngram_w8a8": _identity_arm(lm_q, params_q, iprompts, 24,
                                    spec="ngram", draft_k=4, adaptive=False),
        "draft_w8a8": _identity_arm(lm_q, params_q, iprompts, 24,
                                    spec="draft", draft_lm=dlm_q,
                                    draft_params=quantize_tree(
                                        dlm_q.init(SEED + 1), quant="int8"),
                                    draft_k=4, adaptive=False)}
    for name, arm in ident.items():
        if arm["equal_streams"] != arm["streams"] \
                or arm["verify_rounds"] <= 0:
            raise AssertionError(f"spec float32 {name}: {arm}")
    if ident["draft_self"]["acceptance_rate"] != 1.0:
        raise AssertionError(f"spec self-speculation acceptance "
                             f"{ident['draft_self']['acceptance_rate']}")
    out = {"ngram": ngram, "draft": draft, "verify_check": check,
           "verify_shape": vshape, "float32": ident}
    print(f"[14 spec] (a) {cfg.name} {cfg.num_layers}L bf16 SpecEngine "
          f"ngram k<=4 adaptive, fcfs, prefix cache, chunk 512: "
          f"{ngram['requests']} req ({ngram['prompt_tokens']} prompt "
          f"tokens, repeated passages), {ngram['tokens']} tokens in "
          f"{ngram['wall_s']:.3f}s ({ngram['tokens_per_s']:.1f} tok/s), "
          f"TTFT p50 {ngram['ttft_p50_s']:.4f}s, acceptance "
          f"{ngram['acceptance_rate']:.4f} ({ngram['drafts_accepted']} of "
          f"{ngram['drafts_proposed']}), {ngram['tokens_per_slot_step']:.3f} "
          f"tokens a slot-step, {ngram['fresh_dispatches']} fresh + "
          f"{ngram['cont_dispatches']} continuation dispatches + "
          f"{ngram['verify_rounds']} verify rounds + "
          f"{ngram['fallback_blocks']} fallback blocks = {ngram['syncs']} "
          f"syncs, wall in chunks {ngram['prefill_wall_s']:.3f}s / decode "
          f"{ngram['decode_wall_s']:.3f}s, launches {ngram['launches']}, "
          f"tensor-core launches {ngram['tc_launches']}, peak mem "
          f"{ngram['peak_mem_gb']:.2f} GB (set-up {setup_gb:.2f} GB); "
          f"repeat prompt same tokens; one verify round (8 slots x W 5): "
          f"{check['b2_calls']} B2 calls vs plain, worst element "
          f"{check['b2_worst_share']:.3f} of its limit, logits kernel vs "
          f"plain (worst row's relative L2 / max abs, limit "
          f"{LOGIT_REL_L2}) {check['logit_rel_l2']:.3e}/"
          f"{check['logit_max_abs']:.3e}; B2 at the verify shape: "
          f"{vshape['check']}; ms {vshape['ms']:.4f} plain "
          f"{vshape['plain_ms']:.4f} sdpa {vshape['library_ms']:.4f} bound "
          f"{vshape['bound_ms']:.4f} ({vshape['bound_by']}), 5 x B1 "
          f"{vshape['b1_x5_ms']:.4f} | (b) draft LM {dcfg.name} "
          f"{dcfg.num_layers}L d{dcfg.d_model} k 4: {draft['requests']} req, "
          f"{draft['tokens']} tokens in {draft['wall_s']:.3f}s "
          f"({draft['tokens_per_s']:.1f} tok/s), TTFT p50 "
          f"{draft['ttft_p50_s']:.4f}s, acceptance "
          f"{draft['acceptance_rate']:.4f}, {draft['syncs']} engine syncs + "
          f"{draft['draft_syncs']} draft syncs, {draft['draft_steps']} "
          f"draft steps, launches {draft['launches']}, peak mem "
          f"{draft['peak_mem_gb']:.2f} GB | (c) float32 {SPEC_F32_LAYERS}L "
          f"identity with the plain scheduler: "
          + ", ".join(f"{k} {v['equal_streams']}/{v['streams']} streams "
                      f"equal, acceptance {v['acceptance_rate']}"
                      for k, v in ident.items()))
    return out


EAGER_REQUESTS = 16         # phase 15 (a)
EAGER_Q_REQUESTS = 8        # phase 15 (b), each arm
EAGER_F32_LAYERS = 4        # phase 15 (c) and phase 16


def _eager_spans(tracer, since: int) -> tuple:
    """(admissions, decode steps) of an eager ``Engine`` drive, from its
    own trace spans."""
    from repro_torch.obs.trace import PID_ENGINE
    ev = tracer.events[since:]
    return (sum(e["name"] == "prefill" and e["ph"] == "X" for e in ev),
            sum(e["name"] == "decode_step" and e["ph"] == "X"
                and e["pid"] == PID_ENGINE for e in ev))


def _chunked_plain():
    """The flash op's replacement on the plain side of phase 15's logit
    check: the port's ``chunked_attention`` (online softmax over blocks
    of 1,024), as the reference computes a long prefill off the TPU."""
    torch = _torch()
    from repro_torch.models.attention import chunked_attention

    def flash(q, k, v, causal=True, window=None):
        b, s, h, d = q.shape
        kh = k.shape[2]
        scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32,
                                              device=q.device))
        o = chunked_attention(q.reshape(b, s, kh, h // kh, d), k, v,
                              causal=causal, window=window, scale=scale)
        return o.reshape(b, s, h, d)
    return flash


def _eager_drive(eng, tracer, prompts, max_new, tag: str,
                 qlinears: int = 0) -> dict:
    """Serve ``prompts`` through an eager ``Engine`` with the launch
    counts zeroed just before and read just after; check token counts,
    host syncs = admissions + decode steps, and every kernel's launches:
    B3 28 x admissions, B7 57 x forwards, and with quantized weights B4
    ``qlinears`` x admissions past 128 tokens (int8) and B5 / B6
    ``qlinears`` x decode steps; every launch on its tensor-core / warp
    step."""
    torch = _torch()
    cfg = eng.lm.cfg
    n_ev, syncs0 = len(tracer.events), eng.sync_count
    phase0 = (eng.t_prefill_s, eng.t_decode_s)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    tc = _tc_launches(tag)
    admits, steps = _eager_spans(tracer, n_ev)
    syncs = eng.sync_count - syncs0
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = done[i].out_tokens
        if len(got) != int(m) or not all(0 <= t < cfg.vocab_size
                                         for t in got):
            raise AssertionError(f"{tag} request {i}: {len(got)} tokens "
                                 f"(want {m}) or a token out of vocab")
        n_tok += len(got)
    if admits != len(prompts) or syncs != admits + steps:
        raise AssertionError(f"{tag}: {syncs} host syncs != {admits} "
                             f"admissions + {steps} decode steps (want "
                             f"{len(prompts)} admissions)")
    long_admits = sum(len(p) > 128 for p in prompts)
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.num_layers * admits
    want["rmsnorm"] = (2 * cfg.num_layers + 1) * (admits + steps)
    if cfg.quant == "int8":
        want["int8_matmul"] = qlinears * long_admits
        want["w8a8_decode_matmul"] = qlinears * steps
    elif cfg.quant == "fp8":
        want["fp8_decode_matmul"] = qlinears * steps
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    return {"streams": [done[i].out_tokens for i in ids],
            "tokens_per_s": n_tok / wall,
            "ttft_p50_s": statistics.median(ttft), "wall_s": wall,
            "tokens": n_tok, "requests": len(ids),
            "prompt_tokens": int(sum(len(p) for p in prompts)),
            "long_prompts": int(sum(len(p) >= 2048 for p in prompts)),
            "admissions": admits, "decode_steps": steps, "syncs": syncs,
            "prefill_wall_s": eng.t_prefill_s - phase0[0],
            "decode_wall_s": eng.t_decode_s - phase0[1],
            "launches": {k: v for k, v in launches.items() if v},
            "tc_launches": {k: v for k, v in tc.items() if v},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _eager_prompts(rng, vocab: int, n: int) -> list:
    """``n`` prompts of 200-3,000 tokens, a quarter of them (at least 4
    of 16) past ``attn_chunk_min`` (2,048), the first exactly 2,048."""
    import numpy as np
    plens = rng.integers(200, 3001, n)
    plens[: max(n // 4, 2)] = rng.integers(2048, 3001, max(n // 4, 2))
    plens[0] = 2048
    return [rng.integers(0, vocab, (int(k),)) for k in plens]


def phase_eager(records: list) -> dict:
    """The port's eager ``Engine`` over contiguous caches: (a) qwen2-1.5b
    at full width, bf16, 8 slots, max_len 4,096; (b) int8 weights with an
    int8 cache and fp8 weights with an fp8 cache; (c) float32 at 4 layers,
    full width: the Engine's greedy streams equal the PagedEngine's, and a
    windowed copy's (window 512) equal the plain versions'."""
    torch = _torch()
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.serve.engine import Engine, PagedEngine
    cfg = get_config("qwen2-1.5b").with_(num_layers=E2E_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    setup_gb = _setup_peak_gb()
    tracer = Tracer(enabled=True)
    eng = Engine(lm, params, n_slots=8, max_len=4096, seed=SEED,
                 tracer=tracer)
    rng = np.random.default_rng(SEED + 15)
    vocab = cfg.vocab_size
    eng.submit(rng.integers(0, vocab, 300), max_new_tokens=8)
    eng.run_to_completion()                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts = _eager_prompts(rng, vocab, EAGER_REQUESTS)
    max_new = rng.integers(32, 65, EAGER_REQUESTS)
    bf16 = _eager_drive(eng, tracer, prompts, max_new, "eager bf16")
    bf16["setup_peak_gb"] = setup_gb
    if bf16["long_prompts"] < 4:
        raise AssertionError(f"eager: {bf16['long_prompts']} prompts past "
                             "attn_chunk_min")
    for r in records:
        if r["name"] in bf16["launches"]:
            r.setdefault("launches_by_drive", {})["eager_bf16"] = \
                bf16["launches"][r["name"]]
    # the 2,048-token prompt again, in a slot other requests have used
    rid = eng.submit(prompts[0], max_new_tokens=int(max_new[0]))
    again = eng.run_to_completion()[rid].out_tokens
    if again != bf16.pop("streams")[0]:
        raise AssertionError("eager: a repeated prompt gave other tokens")
    # its admission's logits: B3 and B7 vs chunked attention and the
    # plain RMSNorm
    lk = eng._prefill_slot(prompts[0], 0)
    lp = _swap_plain(lambda: eng._prefill_slot(prompts[0], 0),
                     ("chunked", "norm"))
    torch.cuda.synchronize()
    rel, err = _worst_slot_rel_l2("eager admission", lk[None], lp[None],
                                  (1, vocab))
    bf16["logit_rel_l2"], bf16["logit_max_abs"] = rel, err
    del eng, lm, params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) quantized weights over quantized contiguous caches
    quant = {}
    for qname in ("int8", "fp8"):
        qcfg, qlm, qparams, qsetup = _quantized_lm(qname, qname)
        tracer = Tracer(enabled=True)
        qeng = Engine(qlm, qparams, n_slots=8, max_len=4096, seed=SEED,
                      tracer=tracer)
        qeng.submit(rng.integers(0, vocab, 300), max_new_tokens=8)
        qeng.run_to_completion()                         # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        qp = _eager_prompts(rng, vocab, EAGER_Q_REQUESTS)
        arm = _eager_drive(qeng, tracer, qp,
                           rng.integers(32, 65, EAGER_Q_REQUESTS),
                           f"eager {qname}", qlinears=QLINEARS)
        arm["setup_peak_gb"] = qsetup
        arm.pop("streams")
        quant[qname] = arm
        for r in records:
            if r["name"] in arm["launches"]:
                r.setdefault("launches_by_drive", {})[f"eager_{qname}"] = \
                    arm["launches"][r["name"]]
        del qeng, qlm, qparams
        gc.collect()
        torch.cuda.empty_cache()

    # (c) float32 at 4 layers: Engine == PagedEngine, and a windowed copy
    # through the Engine == its plain versions
    cfg32 = get_config("qwen2-1.5b").with_(num_layers=EAGER_F32_LAYERS,
                                           dtype="float32")
    lm32 = LM(cfg32, device="cuda")
    params32 = lm32.init(SEED)
    iprompts = [rng.integers(0, vocab, (int(n),))
                for n in rng.integers(150, 401, 6)]

    def streams(eng, ps, max_new=24):
        ids = [eng.submit(p, max_new_tokens=max_new) for p in ps]
        done = eng.run_to_completion()
        return [done[i].out_tokens for i in ids]

    eager32 = streams(Engine(lm32, params32, n_slots=4, max_len=1024,
                             seed=SEED), iprompts)
    paged32 = streams(PagedEngine(lm32, params32, n_slots=4, max_len=1024,
                                  page_size=256, decode_block=8, seed=SEED),
                      iprompts)
    same_paged = sum(a == b for a, b in zip(eager32, paged32))
    wlm = LM(cfg32.with_(attention=dataclasses.replace(cfg32.attention,
                                                       window=512)),
             device="cuda")
    wprompts = [rng.integers(0, vocab, (int(n),))
                for n in rng.integers(600, 1501, 4)]
    _reset_launches()
    wk = streams(Engine(wlm, params32, n_slots=4, max_len=2048, seed=SEED),
                 wprompts)
    wlaunch = _read_launches()["flash_attention"]
    wp = _swap_plain(lambda: streams(Engine(wlm, params32, n_slots=4,
                                            max_len=2048, seed=SEED),
                                     wprompts), ("attention", "norm"))
    same_window = sum(a == b for a, b in zip(wk, wp))
    if same_paged != len(iprompts) or same_window != len(wprompts) \
            or wlaunch != EAGER_F32_LAYERS * len(wprompts):
        raise AssertionError(f"eager float32: {same_paged}/{len(iprompts)} "
                             f"streams equal the PagedEngine's, "
                             f"{same_window}/{len(wprompts)} windowed "
                             f"streams equal the plain versions', "
                             f"{wlaunch} windowed B3 launches")
    try:
        PagedEngine(wlm, params32, n_slots=1, max_len=64)
        raise AssertionError("PagedEngine accepted a windowed config")
    except ValueError:
        pass
    out = {"bf16": bf16, "quant": quant,
           "float32": {"paged_equal": same_paged, "requests": len(iprompts),
                       "window_equal": same_window,
                       "window_requests": len(wprompts),
                       "window_b3_launches": wlaunch}}
    print(f"[15 eager] (a) {cfg.name} {cfg.num_layers}L bf16 Engine, 8 "
          f"slots, max_len 4096: {bf16['requests']} req "
          f"({bf16['prompt_tokens']} prompt tokens, {bf16['long_prompts']} "
          f">= 2048), {bf16['tokens']} tokens in {bf16['wall_s']:.3f}s "
          f"({bf16['tokens_per_s']:.1f} tok/s), TTFT p50 "
          f"{bf16['ttft_p50_s']:.4f}s, {bf16['admissions']} admissions + "
          f"{bf16['decode_steps']} decode steps = {bf16['syncs']} syncs, "
          f"wall in admissions {bf16['prefill_wall_s']:.3f}s / decode steps "
          f"{bf16['decode_wall_s']:.3f}s, launches {bf16['launches']}, "
          f"tensor-core / warp launches {bf16['tc_launches']}, peak mem "
          f"{bf16['peak_mem_gb']:.2f} GB (set-up {setup_gb:.2f} GB); repeat "
          f"prompt same tokens; the 2048-token admission's logits, kernels "
          f"vs chunked attention + plain RMSNorm (relative L2 / max abs, "
          f"limit {LOGIT_REL_L2}) {rel:.3e}/{err:.3e} | (b) "
          + "; ".join(f"{q} weights + {q} cache: {a['requests']} req, "
                      f"{a['tokens']} tokens in {a['wall_s']:.3f}s "
                      f"({a['tokens_per_s']:.1f} tok/s), TTFT p50 "
                      f"{a['ttft_p50_s']:.4f}s, {a['syncs']} syncs, "
                      f"launches {a['launches']}, peak mem "
                      f"{a['peak_mem_gb']:.2f} GB (set-up "
                      f"{a['setup_peak_gb']:.2f} GB)"
                      for q, a in quant.items())
          + f" | (c) float32 {EAGER_F32_LAYERS}L: Engine vs PagedEngine "
          f"{same_paged}/{len(iprompts)} streams equal; window 512 Engine "
          f"({wlaunch} windowed B3 launches) vs plain versions "
          f"{same_window}/{len(wprompts)} streams equal; PagedEngine refuses "
          "the window")
    return out


def _resil_counts(eng, tracer, since: int) -> dict:
    c = _counts(eng, tracer, since)
    snap = eng.metrics.snapshot()["counters"]
    c["recovered"] = int(snap.get("resil_recovered_total", 0))
    return c


def _resil_drive(eng, tracer, prompts, max_new, tag: str) -> dict:
    """Serve ``prompts`` through a resilient scheduler with the launch
    counts zeroed just before and read just after.  Every request retires
    with exactly one outcome; B3 / B2 / B1 / B7 ran as many times as the
    dispatches that got past the fault hook (a faulted dispatch launches
    nothing)."""
    torch = _torch()
    from repro_torch.resil import OUTCOMES
    cfg = eng.lm.cfg
    base = _resil_counts(eng, tracer, 0)
    n_ev = len(tracer.events)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_launches().items()
                if k in ("paged_attention", "flash_attention",
                         "paged_prefix_extend", "rmsnorm")}
    now = _resil_counts(eng, tracer, n_ev)
    d = {k: now[k] - base[k] for k in now if k not in ("cont", "fresh")}
    d["cont"], d["fresh"] = now["cont"], now["fresh"]
    outcomes = {o: sum(done[i].outcome == o for i in ids) for o in OUTCOMES}
    if sum(outcomes.values()) != len(ids):
        raise AssertionError(f"{tag}: outcomes {outcomes} do not sum to "
                             f"{len(ids)} requests")
    verify = getattr(getattr(eng, "spec_stats", None), "verify_steps", 0)
    layers = cfg.num_layers
    want = {"flash_attention": layers * d["fresh"],
            "paged_prefix_extend": layers * (d["cont"] + verify),
            "paged_attention": layers * d["steps"],
            "rmsnorm": (2 * layers + 1) * (d["fresh"] + d["cont"]
                                           + d["steps"] + verify)}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want}")
    free = len(eng.alloc.free)
    if free != eng.alloc.n_pages - 1:
        raise AssertionError(f"{tag}: {free} pages free at the end, want "
                             f"{eng.alloc.n_pages - 1}")
    return {"streams": [done[i].out_tokens for i in ids],
            "outcomes": outcomes, "wall_s": wall, "launches": launches,
            "dispatches": {k: d[k] for k in ("fresh", "cont", "steps")},
            "recovered": d["recovered"], "verify_rounds": verify,
            "free_pages": free,
            "retry_after_s": [done[i].retry_after_s for i in ids
                              if done[i].outcome == "shed"]}


def phase_resil(records: list) -> dict:
    """Resilient serving through the port's SchedEngine, float32 at 4
    layers and full width: (a) page faults, dispatch faults and a shrunk
    pool, every request recovered to the fault-free stream; (b) latency
    spikes against a per-request deadline; (c) 32 requests on 8 slots
    with the degradation ladder, down to its shed rung; (d) SpecEngine
    n-gram drafts under mangled proposals and dispatch faults."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import passage_prompt
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.resil import FaultInjector
    from repro_torch.sched import SchedEngine
    from repro_torch.spec import SpecEngine
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("qwen2-1.5b").with_(num_layers=EAGER_F32_LAYERS,
                                         dtype="float32")
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    vocab = cfg.vocab_size
    rng = np.random.default_rng(SEED + 16)
    # pages and chunks of 128: prompts of 150-400 tokens take 2-4 chunks
    # (continuations on B2), and the drive makes enough dispatches that
    # seed 0's schedule faults some of them; no backoff, so that the
    # schedule (the order of the injector's draws) is the same on any
    # machine
    kw = dict(policy="fcfs", prefix_cache=False, n_slots=8, max_len=1024,
              page_size=128, prefill_chunk=128, decode_block=8, seed=SEED,
              max_retries=100, backoff_s=0.0, backoff_max_s=0.0)
    prompts = [rng.integers(0, vocab, (int(n),))
               for n in rng.integers(150, 401, 8)]
    clean = SchedEngine(lm, params, **{k: v for k, v in kw.items()
                                       if not k.startswith(("max_ret",
                                                            "backoff"))})
    ids = [clean.submit(p, max_new_tokens=24) for p in prompts]
    done = clean.run_to_completion()
    want = [done[i].out_tokens for i in ids]
    del clean

    def armed(chaos, cls=SchedEngine, **extra):
        tracer = Tracer(enabled=True)
        inj = FaultInjector.from_spec(chaos)
        return cls(lm, params, injector=inj, tracer=tracer,
                   **{**kw, **extra}), tracer, inj

    # (a) page faults, dispatch faults, 4 pages hidden
    eng, tracer, inj = armed("seed=0,oom=0.05,fault=0.1,shrink=4")
    a = _resil_drive(eng, tracer, prompts, [24] * 8, "resil chaos")
    a["injected"] = dict(inj.counts)
    if a["outcomes"]["ok"] != 8 or a["streams"] != want \
            or inj.counts["page_oom"] <= 0 or inj.counts["dispatch"] <= 0 \
            or a["recovered"] <= 0:
        raise AssertionError(f"resil chaos: outcomes {a['outcomes']}, "
                             f"{sum(x == y for x, y in zip(a['streams'], want))}"
                             f"/8 fault-free streams, injected {inj.counts}, "
                             f"recovered {a['recovered']}")
    for r in records:
        if r["name"] in a["launches"]:
            r.setdefault("launches_by_drive", {})["resil_chaos"] = \
                a["launches"][r["name"]]

    # (b) every dispatch sleeps 0.3 s against a 0.75 s deadline: the
    # requests still prefilling or decoding when it passes time out
    eng, tracer, inj = armed("seed=0,spike=1.0,spike_s=0.3",
                             max_request_s=0.75)
    b = _resil_drive(eng, tracer, prompts, [8, 24] * 4, "resil deadline")
    b["injected"] = dict(inj.counts)
    if b["outcomes"]["timed_out"] <= 0:
        raise AssertionError(f"resil deadline: outcomes {b['outcomes']}")

    # (c) 32 requests on 8 slots with the ladder on
    eng, tracer, _ = armed(None, ladder=True)
    rungs = []
    update = eng.ladder.update

    def spy():
        rungs.append(update())
        return rungs[-1]
    eng.ladder.update = spy
    many = [rng.integers(0, vocab, (int(n),))
            for n in rng.integers(150, 401, 32)]
    c = _resil_drive(eng, tracer, many, [24] * 32, "resil shed")
    if max(rungs) != 4 or not c["outcomes"]["shed"] \
            or not all(x > 0 for x in c["retry_after_s"]):
        raise AssertionError(f"resil shed: rungs up to {max(rungs)}, "
                             f"outcomes {c['outcomes']}, retry-after "
                             f"{c['retry_after_s']}")
    c["max_rung"] = max(rungs)

    # (d) n-gram speculation, 30% of the drafts mangled, dispatch faults
    pprompts = [passage_prompt(rng, vocab, int(n))
                for n in rng.integers(150, 401, 8)]
    clean = SchedEngine(lm, params, **{k: v for k, v in kw.items()
                                       if not k.startswith(("max_ret",
                                                            "backoff"))})
    ids = [clean.submit(p, max_new_tokens=24) for p in pprompts]
    done = clean.run_to_completion()
    want_d = [done[i].out_tokens for i in ids]
    del clean
    eng, tracer, inj = armed("seed=0,draft=0.3,fault=0.1", cls=SpecEngine,
                             spec="ngram", draft_k=4, adaptive=False)
    dd = _resil_drive(eng, tracer, pprompts, [24] * 8, "resil spec")
    dd["injected"] = dict(inj.counts)
    if dd["streams"] != want_d or inj.counts["draft"] <= 0 \
            or dd["verify_rounds"] <= 0:
        raise AssertionError(f"resil spec: "
                             f"{sum(x == y for x, y in zip(dd['streams'], want_d))}"
                             f"/8 streams equal the plain scheduler's, "
                             f"injected {inj.counts}, {dd['verify_rounds']} "
                             "verify rounds")
    out = {}
    for name, arm in (("chaos", a), ("deadline", b), ("shed", c),
                      ("spec", dd)):
        arm.pop("streams")
        out[name] = arm
    print(f"[16 resil] {cfg.name} {cfg.num_layers}L float32 SchedEngine, 8 "
          f"slots, pages and chunks of 128: (a) chaos seed=0,oom=0.05,fault=0.1,shrink=4: "
          f"outcomes {a['outcomes']}, 8/8 fault-free streams, injected "
          f"{a['injected']}, {a['recovered']} recoveries, dispatches "
          f"{a['dispatches']}, launches {a['launches']}, {a['free_pages']} "
          f"pages free at the end, {a['wall_s']:.3f}s | (b) spikes of 0.3 s "
          f"on every dispatch, deadline 0.75 s: outcomes {b['outcomes']}, "
          f"{b['free_pages']} pages free | (c) 32 req with the ladder: rung "
          f"up to {c['max_rung']} (shed), outcomes {c['outcomes']}, "
          f"retry-after {min(c['retry_after_s']):.2f}-"
          f"{max(c['retry_after_s']):.2f}s | (d) SpecEngine ngram, "
          f"draft=0.3,fault=0.1: 8/8 streams equal the plain scheduler's, "
          f"injected {dd['injected']}, {dd['verify_rounds']} verify rounds, "
          f"{dd['recovered']} recoveries")
    return out


def main() -> int:
    dev = phase_device()
    phase_build()
    records: list = []
    phase_paged(records)
    phase_flash(records)
    e2e = phase_e2e(records)
    phase_extend(records)
    sched = phase_sched(records)
    phase_qmm(records)
    phase_trap4()
    qsched = phase_qsched(records)
    fp8 = phase_fp8(records)
    phase_wkv6(records)
    drives = (("e2e", e2e), ("sched", sched), ("qsched", qsched),
              ("fp8", fp8))
    phase_rmsnorm(records,
                  {name: d["launches"]["rmsnorm"] for name, d in drives},
                  {name: d["tc_launches"]["rmsnorm"] for name, d in drives})
    rwkv = phase_rwkv(records)
    spec = phase_spec(records)
    eager = phase_eager(records)
    resil = phase_resil(records)
    out_dir = ROOT / "chiprun_out"
    if out_dir.is_dir():
        (out_dir / "chip_smoke_e2e.json").write_text(json.dumps(
            {"e2e": e2e, "sched": sched, "qsched": qsched, "fp8": fp8,
             "rwkv": rwkv, "spec": spec, "eager": eager, "resil": resil,
             "kernels": records}, indent=1))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
