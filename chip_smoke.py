"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device    — require CUDA, print the card's name and power limit,
                 turn TF32 off for fp32 products
  2. build     — compile the hand-written CUDA kernels from csrc/
  3. paged     — paged decode kernel vs its plain version, element by
                 element, at the serving shapes (8 slots, 12 heads over
                 2 kv heads, D 128, page 256), bf16 / fp32 / int8 / fp8
                 pools, with times; then bf16 / fp32 at the other head
                 shapes of the port's configs (EXTRA_SHAPES)
  4. flash     — flash prefill kernel vs its plain version (B 8,
                 S in {8, 100, 512}, causal, bf16 / fp32, one windowed),
                 then the other head shapes
  5. e2e       — qwen2-1.5b at full width (28 layers, random weights from
                 a seed) served by the port's PagedEngine; checks token
                 counts, host syncs and both kernels' launch counts, and
                 one decode step's logits with kernels vs plain versions
Then one JSON line of kernel numbers, and last the result line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
              "int8": 1979e12, "float32": 67e12}

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
    out_dir = ROOT / "chiprun_out"
    if built and out_dir.is_dir():
        (out_dir / "ptxas.txt").write_text(
            "\n\n".join(f"== {n}\n{i['log']}" for n, i in built.items()))
    print(f"[2 build] {sorted(build.SOURCES)} in {dt:.1f}s "
          f"(compiled now: {sorted(built)}; "
          f"max registers: {_max_regs(regs)})")
    return {"seconds": dt}


def _max_regs(regs: dict) -> dict:
    out = {}
    for name, lines in regs.items():
        vals = [int(ln.split("Used ")[1].split(" registers")[0])
                for ln in lines if "Used " in ln]
        out[name] = max(vals) if vals else None
    return out


def _paged_inputs(dtype_name: str, g, device, lengths, h=12, kh=2, d=128):
    torch = _torch()
    s_n, page, pps = len(lengths), 256, 4
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
    return line


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
#: the largest group the paged kernel takes (8), and the smoke configs
EXTRA_SHAPES = [(32, 8, 64), (32, 32, 64), (16, 2, 128), (4, 2, 16),
                (4, 1, 16), (4, 4, 16)]


def phase_paged(records: list) -> None:
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED)
    # a free slot (0), one token, a partial last page, the full horizon
    lengths = [0, 1, 300, 1024, 517, 256, 77, 900]
    cases = [(dt, 12, 2, 128) for dt in ("bfloat16", "float32", "int8",
                                         "float8_e4m3fn")]
    cases += [(dt, h, kh, d) for h, kh, d in EXTRA_SHAPES
              for dt in ("bfloat16", "float32")]
    line = []
    for dt_name, h, kh, d in cases:
        args = _paged_inputs(dt_name, g, device, lengths, h, kh, d)
        out = ops.paged_attention(*args)
        ref = paged_attention_ref(*args)
        torch.cuda.synchronize()
        q, kp, vp, bt, lens, ks, vs = args
        v = vp.float() if vs is None else vp.float() * vs[:, None, :, None]
        v_rms = v.pow(2).mean().sqrt().item()
        line.append(check_close(f"{dt_name} H{h}/{kh} D{d}", out, ref, v_rms))
        if not (out[0].float() == 0).all():
            raise AssertionError("paged: a length-0 slot must give zeros")
        if (dt_name, h) != ("bfloat16", 12):
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
    print("[3 paged] " + "; ".join(line))


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
        out = ops.flash_attention(q, k, v, causal=True, window=window)
        ref = attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        tag = (f"S{s} {str(dt)[6:]} H{h}/{kh} D{d}"
               + (f" w{window}" if window else ""))
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


E2E_LAYERS = 28            # qwen2-1.5b's full depth
#: per-slot relative L2 error allowed between the logits with the kernels
#: and with their plain versions
LOGIT_REL_L2 = 2e-2


def _swap_plain(fn):
    """Run ``fn()`` with the attention ops bound to their plain versions
    (the comparison arm of phase 5; the port itself never does this)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    saved = fops.flash_attention, pops.paged_attention
    fops.flash_attention = lambda q, k, v, causal=True, window=None: \
        attention_ref(q, k, v, causal=causal, window=window)
    pops.paged_attention = paged_attention_ref
    try:
        return fn()
    finally:
        fops.flash_attention, pops.paged_attention = saved


def phase_e2e(records: list) -> dict:
    """qwen2-1.5b at full width through the port's PagedEngine."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
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
    fops.launches = pops.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": pops.launches,
                "flash_attention": fops.launches}
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
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in records:
        r["launches"] = launches[r["name"]]

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
    errs = {}
    for tag, a, b in (("prefill", pre_k, pre_p), ("decode", dec_k, dec_p)):
        if not (torch.isfinite(a).all() and a.shape == (n_s, cfg.vocab_size)):
            raise AssertionError(f"{tag} logits not finite / wrong shape")
        # each slot's logits, as a vector: bf16 activations round the two
        # arms' attention outputs apart by up to an ulp (2^-8 relative) in
        # each of 28 layers; a kernel that drops or misweights keys moves
        # a slot's attention output by far more than that
        rel = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
        err = (a - b).abs().max().item()
        if not rel <= LOGIT_REL_L2:
            raise AssertionError(f"{tag} logits kernel vs plain: a slot's "
                                 f"relative L2 error {rel:.3e} > "
                                 f"{LOGIT_REL_L2} (max abs err {err:.3e})")
        errs[tag] = (rel, err)
    out = {"tokens_per_s": n_tok / wall, "ttft_p50_s": statistics.median(ttft),
           "wall_s": wall, "tokens": n_tok, "requests": n_req,
           "admissions": admits, "decode_blocks": blocks,
           "decode_steps": steps, "syncs": syncs, "peak_mem_gb": peak_gb,
           "setup_s": t_setup, "launches": launches,
           "logit_err": errs}
    print(f"[5 e2e] {cfg.name} {cfg.num_layers}L d{cfg.d_model} bf16 "
          f"kernels: {n_req} req, {n_tok} tokens in {wall:.3f}s "
          f"({n_tok / wall:.1f} tok/s), TTFT p50 {out['ttft_p50_s']:.4f}s, "
          f"{admits} admissions + {blocks} blocks = {syncs} syncs, "
          f"{steps} decode steps, launches {launches}, peak mem "
          f"{peak_gb:.2f} GB, logits kernel vs plain (worst slot's relative "
          f"L2 / max abs, limit {LOGIT_REL_L2}): prefill "
          f"{errs['prefill'][0]:.3e}/{errs['prefill'][1]:.3e} decode "
          f"{errs['decode'][0]:.3e}/{errs['decode'][1]:.3e}, setup "
          f"{t_setup:.1f}s")
    out_dir = ROOT / "chiprun_out"
    if out_dir.is_dir():
        (out_dir / "chip_smoke_e2e.json").write_text(json.dumps(
            {"e2e": out, "kernels": records}, indent=1))
    return out


def main() -> int:
    dev = phase_device()
    phase_build()
    records: list = []
    phase_paged(records)
    phase_flash(records)
    phase_e2e(records)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
