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
 17. cost      — the cost model's H100 tier on qwen2-1.5b at full width,
                 bf16, SchedEngine with 8 slots, max_len 4,096, page 256,
                 chunk 512: (a) SJF over 8 of phase 7's requests with the
                 DispatchProfiler on, then off: equal streams, syncs and
                 launches (B3 / B2 / B1 / B7 at 28 / 28 / 28 / 57 a
                 dispatch), every sample of a known kind, the samples'
                 prefill tokens the engine's; each kind's count, median
                 wall, analytic estimate and drift ratio; (b) EDF with
                 admission control, the TTFT target between the short and
                 the long prompts' prefill estimates: exactly the long
                 ones rejected, the rest served, every page freed; (c)
                 `python -m repro_torch.launch.serve` twice (SJF open loop
                 with --profile, --calibration-out, --metrics, --trace-out;
                 then --spec ngram --quant int8 --calibration-in): exit 0,
                 the files, the metric names, the calibration carried
 18. search    — search -> serve: the port's AutoTuner at h100-1 on
                 qwen2-1.5b at full width (MMLU at 512 tokens, the budget
                 of the reference's _small_tuner, the whole space: c*
                 may take MLA or upcycle to MoE), c* by
                 recommend_efficient, recalibrated from phase 17's drift;
                 then Default and c* served through SchedEngine /
                 SpecEngine (an MLA c* through the eager Engine, its spec
                 arm reported unserved; one slot, page 256, chunk 512,
                 2 requests of 512 + 128 tokens one after another):
                 request latency, TTFT and peak memory beside predict()'s,
                 every stream full, every page freed, launches = the
                 dispatches' (B4 / B5 / B6 at 196 a dispatch for quantized
                 weights, 4 a layer for an upcycled MoE)
 19. moe       — MoE serving and deepseek-coder-33b at full depth: (a)
                 granite-moe-3b-a800m at full width and depth (32 layers,
                 40 experts top-8), bf16: (a1) SchedEngine, FCFS, prefix
                 cache, phase 7's settings, 4 of its requests; (a2)
                 PagedEngine with int8 weights (attention linears; experts stay bf16)
                 and int8 pools, 4 requests; (a3) the n-gram SpecEngine on
                 (a1)'s settings over repeated passages; (b)
                 llama4-scout-17b-a16e at full width and 8 layers through
                 the eager Engine, 2 slots, prompts past its 8,192 window
                 (B3 windowed, held first at its head shape); (c)
                 deepseek-coder-33b at full width and all 62 layers, int8
                 weights built a group at a time, bf16 pools, PagedEngine,
                 4 requests, after B1 / B2 / B3 / B4 / B5 / B6 / B7 are
                 held at its shapes and B1 / B3 / B4 / B5 timed there; (d)
                 moe_apply (both dispatches) of one granite and one llama4
                 layer, 1,024 tokens, bf16, on the card vs the CPU, twice
                 bit-equal.  Every arm: full streams, no leaked page,
                 launches derived from the config and the dispatches, no
                 non-finite logit; tokens/s, TTFT p50, decode-step wall,
                 peak memory after the weights, launches
 20. train     — training: the CLI for llama3.2-1b at full width with
                 checkpoints, gradients card vs CPU, LoRA / QLoRA / DoRA,
                 the resume, the LoRA model served, granite-moe and rwkv6
                 training, the proxy evaluator; no kernel launches
 21. encdec    — (a) B3 without a causal mask, element by element against
                 its plain version at whisper's and the vision model's
                 shapes (S = T = 1,500; S 64 / 512 / 1 over T 1,500 /
                 1,600), timed beside SDPA; (b) whisper-base at full width
                 and depth (6 + 6 layers) and (c) llama-3.2-vision-11b (40
                 layers, 8 with cross-attention) through
                 LM.prefill(modality_input=) and 32 greedy decode_steps
                 (8 x 64 tokens over 1,500 frames; 4 x 512 over 1,600
                 patches): full streams, finite logits, B3 / B7 launches
                 from the config, prefill and first decode step's logits
                 vs the plain versions, wall and busy ms of a prefill and
                 a decode step, peak memory; (d) qwen2-1.5b under the
                 search's mla arm through the eager Engine, bf16 and int8
                 weights, the latent bytes a token; (e) calibration:
                 collect_linear_inputs on the card, SmoothQuant and AWQ
                 scales, the calibrated int8 model served, GPTQ on the
                 host, timed
 22. jamba     — Mamba and the jamba hybrid: (e) B3 at jamba's attention
                 layer (1 x 2,048, 64 heads over 8) element by element,
                 B4 (M 256) / B5 (M 4) bit for bit at the Mamba in_proj
                 and out_proj, B7 at d 8,192 within one ulp, each timed at
                 the main path's shapes beside its plain version, library
                 call and bound; (a) one Mamba layer at full width: the
                 chunked log-step scan against the sequential recurrence
                 (fp32, 1e-4), a 2,048-token forward, the scan alone and
                 32 decode steps timed; (d) the smoke jamba's loss and
                 gradients card vs CPU; (b) jamba-1.5-large-398b at full
                 width over its first five layers (block_pattern[:5]: 4
                 Mamba blocks and the attention block, 33.1 B parameters,
                 bf16) through the eager Engine, 4 slots, 4 requests of
                 512-2,048 tokens, 32 new tokens each: token counts, syncs
                 = admissions + decode steps, B3 once an admission, B7 11
                 a forward, a second run on the reused slots gives the
                 same streams, admission and decode-step logits with B3 /
                 B7 swapped for their plain versions, wall and busy time
                 by kernel family, peak memory; (c) the same with int8
                 weights: B4 / B5 18 a forward, every call of one
                 admission and one decode step bit-equal to its plain
                 version
 23. tp        — tensor-parallel serving, two ranks (spawned, gloo: NCCL
                 refuses two ranks on one card) sharing the card, each
                 loading the kernels phase 2 built: (f) B1 / B2 / B3 at a
                 rank's heads (6 over 1, D 128) element by element and
                 timed beside SDPA and their bounds; a probe of each
                 collective on CUDA tensors; (a) qwen2-1.5b at full width
                 through PagedEngine on phase 5's drive: streams equal on
                 both ranks, admissions / decode steps / syncs and B1 / B3
                 / B7 launches a rank equal to one rank's (run in this
                 process), one admission's and one decode step's logits
                 within LOGIT_REL_L2 of one rank's, the collectives of a
                 decode step; (b) float32 at 4 layers: the streams equal
                 one rank's; (c) SchedEngine (two waves behind a shared
                 prefix) and the n-gram SpecEngine, B2 counted; (d) int8
                 weights and int8 pools, every B4 / B5 call of one
                 admission and one decode step bit-equal; (e) the gather
                 arm for two decode steps, its all-gather bytes a step at
                 least 4x (a)'s
 24. train_tp  — sharded training of llama3.2-1b (16 layers, d 2,048,
                 bf16) by two ranks sharing the card over gloo, against
                 one rank in this process, phase 20's 8 x 512 batch and
                 seed: (a) `python -m repro_torch.launch.train
                 --model-parallel 2` (its main), 2 steps: each loss within
                 2e-2 relative of one rank's, each rank's step wall p50,
                 tokens/s, peak memory and collectives a step by kind, no
                 kernel launch; (b) a data axis of 2 with
                 make_param_specs(fsdp=True) at the default minimum size,
                 each rank 4 of the 8 rows, the same checks and figures;
                 (c) float32 at 2 layers of full width on both meshes:
                 every leaf's first-step gradient, gathered whole, within
                 1e-4 relative L2 of one rank's and 2 steps' losses within
                 1e-5
 25. tp_moe_quant — MoE, fp8 / int4 weights and LoRA adapters under a
                 model axis of 2 (two ranks sharing the card over gloo,
                 against one rank in this process): (f) B1 and B3 at
                 granite's rank heads (12 over 4, D 64) and B6 at qwen2's
                 rank linears (column K 1,536 x N 4,480 bf16 out, row
                 K 4,480 x N 1,536 fp32 out, no bias), element by
                 element, timed beside the plain version, the library
                 call and the bound; (a) granite-moe-3b-a800m at full
                 width and depth (32 layers, 40 experts top-8, EP at 20 a
                 rank, einsum dispatch) through PagedEngine with phase
                 19's engine settings: streams equal on both ranks,
                 admissions / decode steps / syncs and B1 / B3 / B7
                 launches a rank equal one rank's, one admission's and
                 one decode step's logits row by row (float32 within
                 1e-3; bf16, on seeds 0 and 1, within 2x a one-rank
                 witness of summation order), the collectives of a
                 decode step; (b) the gather dispatch for two decode
                 steps; (c) float32 granite at 2 layers: streams equal one
                 rank's; (d) qwen2-1.5b with fp8, then int4 weights:
                 every B6 call of one decode step against its plain
                 version (phase 8's limits), logits within 2e-2, streams
                 equal across ranks; (e) rank-16 LoRA adapters, unmerged:
                 logits within 2e-2 of one rank's
 26. train_tp_peft — sharded fine-tuning by two ranks sharing the card:
                 (a) llama3.2-1b at full width and depth with LoRA and
                 QLoRA (int4 base), phase 20's 8 x 512 batch, 2 steps
                 each: losses within 2e-2 of one rank's, step wall p50,
                 peak, collectives a step by kind, no kernel launch; (b)
                 granite-moe-3b-a800m's first 4 of 32 layers at full
                 width, full fine-tune, the same; (c) float32 at 2
                 layers: every trainable leaf's first-step gradient (the
                 router's, LoRA's and QLoRA's adapters) gathered whole
                 within 1e-4 relative L2 of one rank's
 27. cells     — the dry-run's cells on the card: (a) llama3.2-1b at full
                 width and depth on one rank, B3 at 1 x 32,768 causal and
                 B1 at 16 slots x 32,768 (32 heads over 8, D 64) held and
                 timed beside the plain version, SDPA and the bound; then
                 launch.steps' train_4k (4 rows), prefill_32k (1 x 32,768)
                 and decode_32k (16 x 32,768 over a contiguous and a paged
                 cache) cells, 3 timed runs each: step wall, peak, B1 / B3
                 / B7 launches = the layer count x the runs, logits equal
                 to LM.prefill / LM.decode_step (and prefill's within
                 2e-2 of the plain versions), the train loss equal to
                 LM.loss, each cell's meta trace (run meanwhile in two host
                 processes) beside it, the train and contiguous decode
                 steps' FLOPs equal to FlopCounterMode's to the FLOP; (b)
                 qwen2-1.5b at full width and depth, the decode cell with
                 decode_attn_impl="cp" on four ranks sharing the card
                 over gloo (8 x 32,768, 8,192 positions a rank), 2 steps:
                 the collectives a step equal CP_PREDICTED, bf16 logits
                 within 2x a one-rank witness of rounding, float32 at 2
                 layers within 1e-5 of one rank's; (c) a GPipe pipeline of
                 llama3.2-1b's 16 layers as 2 stages on two ranks, 4
                 microbatches of 2 x 512: outputs within 2e-2 of one rank
                 running the 16 layers, S + M - 1 permutes of a
                 microbatch and one sum
 28. whole_heads — on 27 (b)'s four ranks and weights, qwen2-1.5b's 12
                 query heads over 2 kv heads, which 4 does not divide:
                 every rank computes every head from projections
                 gathered whole. (a) launch.steps' prefill cell, 4 x
                 512, bf16 at full depth: logits within 2e-2 a row of
                 one rank's, float32 at 2 layers within 1e-5, B3 28 and
                 B7 57 launches a rank with every call held against its
                 plain version, the collectives a prefill equal
                 WH_PREDICTED; (b) the train cell, 2 steps: losses
                 within 2e-2 of one rank's, step wall, peak and the
                 collectives a step (the gathers' reduce-scatters apart),
                 float32 at 2 layers: every gradient leaf gathered whole
                 within 1e-4 of one rank's, the loss within 1e-5; then
                 B3 at a rank's shape timed beside the plain version,
                 SDPA and the bound
 29. ssm_tp    — on the same four ranks after 28, rwkv6-1.6b at full
                 width and depth over 8 WKV heads a rank and jamba's
                 Mamba mixer over 4,096 channels a rank.  (a)
                 launch.steps' prefill cell, 4 x 512, then 8 decode
                 steps, bf16: logits within 2e-2 a row of one rank's (or
                 2x its witness of rounding), B8 24 launches a prefill a
                 rank with every call held, the collectives equal
                 SSM_PREDICTED; float32 at 2 layers: logits within 1e-2
                 (trap 6), states within 4x the TF32 witness; (b) the
                 train cell, 2 steps: losses within 2e-2 of one rank's,
                 the float32 gradient gathered whole within 1e-4 or 3x a
                 one-rank summation-order floor; (c) the mixer, a 4 x 512
                 prefill and 8 decode steps against one rank's, float32
                 within 1e-5, 1 all-gather and 2 all-reduces a call; then
                 B8 at a rank's shape timed beside the plain version
 30. clock     — inside phase 23's two ranks (after its (c), and (c)
                 after its (b)), rank 1's own host clock an hour ahead
                 and 1.5x as fast: every decision reads rank 0's.  (a)
                 qwen2-1.5b at full width through SchedEngine, EDF with
                 admission control, TTFT / TPOT targets, the ladder,
                 deadlines and the prefix cache, 8 requests open loop:
                 every rank's streams, outcomes, first admissions, rung
                 trace and drops equal, an EDF reorder, an admission
                 drop, a rung above 0 and a preemption shown, B1 / B2 /
                 B3 / B7 launches as the dispatches give them, syncs =
                 dispatches + blocks, the clock's readings by the function
                 that took them as predicted; (b) the n-gram SpecEngine
                 under EDF with spec_slack_s and chaos (faults, mangled
                 drafts): streams, outcomes, faults and verify rounds
                 equal, B2 = L x (continuations + verify rounds); (c) (a)
                 in float32 at 4 layers with chaos (page faults, dispatch
                 faults), replayed on one rank in this process on rank
                 0's recorded readings: the same streams, outcomes,
                 syncs, rungs and faults
B7 takes every RMSNorm of the qwen2-1.5b drives: 57 launches a forward
(phases 5, 7, 9, 10), every one on its warp step.  Every B1 / B2 / B3
launch of those drives (bf16 activations), every B4 and B5 launch of
phase 9 and every B6 launch of phase 10 must take the tensor-core step:
their tensor-core launch counts are printed beside the launch counts and
must equal them.  Launch counts are
zeroed just before each drive (phases 5, 7, 9, 10, 13-30) and read just
after it; peak memory is read for the set-up and, restarted, for the
drive.  Then one JSON
line of kernel numbers, and last the result line ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import os
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


def check_close(tag: str, out, ref, v_rms: float, kind=None) -> str:
    """Hold ``out`` to ``ref`` element by element; raise on any element
    past its limit (``kind``'s, by default ``ref``'s dtype's).  Returns
    the case's line: the max error, the limit used and the worst
    element's share of its limit."""
    return check_close_share(tag, out, ref, v_rms, kind)[0]


def check_close_share(tag: str, out, ref, v_rms: float,
                      kind=None) -> tuple:
    """``check_close``'s line and the worst element's share of its
    limit."""
    torch = _torch()
    if kind is None:
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


def _qmm_times(kind: str, m: int, k: int, n: int, g, device,
               out_dtype=None, bias: bool = True) -> dict:
    """One call's device time of a quantized-matmul kernel, its plain
    version, its library call and a bf16 product over the dequantized
    weight, on cycled copies of the operands; and its bound.  B6 may take
    another output type (``out_dtype``) and no bias."""
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
        copies.append((x, qw, ws, b if bias else None))
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
              (lambda x, qw, ws, b: ops.fp8_matmul_decode(
                  x, qw, ws, bias=b, out_dtype=out_dtype)))
        plain = w8a8_decode_ref if kind == "B5" else (
            lambda x, qw, ws, b: fp8_decode_ref(x, qw, ws, b, out_dtype))
        # cuBLASLt's int8 product wants more than 16 rows: M padded to 32
        lib_in = [(F.pad(quantize_rowwise(x)[0], (0, 0, 0, 32 - m)), qw)
                  for x, qw, _, _ in copies]
        out_size = 4 if out_dtype == torch.float32 else 2
        nbytes = m * k * 2 + k * n + 4 * n + (2 * n if bias else 0) \
            + out_size * m * n
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


def _qlinears(cfg, decode: bool = False) -> int:
    """Quantized linears of one forward of ``cfg``: the four attention
    linears of every attention block (MLA: ``kv_down``, ``q_up``,
    ``kv_up_k``, ``kv_up_v`` and ``wo``, of which a decode step calls
    three: it absorbs the up-projections; ``k_rope`` is not a target), a
    Mamba block's ``in_proj`` and ``out_proj`` (``x_proj`` and ``dt_proj``
    are not targets), and three more for a block's dense MLP or its MoE
    layer's shared expert (expert stacks and router are not quantized, as
    in the reference's QUANT_TARGETS)."""
    from repro_torch.models.transformer import block_kinds
    attn = 4
    if cfg.attention is not None and cfg.attention.kind == "mla":
        attn = 3 if decode else 5
    mixer = {"attn": attn, "mamba": 2}
    per_group = sum(mixer[bk["kind"]] + (3 if not bk["moe"]
                                         or cfg.moe.num_shared_experts
                                         else 0)
                    for bk in block_kinds(cfg))
    return per_group * cfg.num_groups



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
    from repro_torch.kernels import launch_counts
    return launch_counts()


def _tc_launches(tag: str, exempt=()) -> dict:
    """B1 / B2 / B3 / B4 / B5 / B6 launches of a drive that took the
    tensor-core step (B4: its wgmma step), and B7 launches that took its
    warp step; raises unless every launch since the last reset took it,
    but for the kernels in ``exempt`` (shapes that rule the step out: B7
    past d 2,048, B5 past K 16,384)."""
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
        if n != launches[name] and name not in exempt:
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
            "rmsnorm": (2 * layers + 1) * (d["cont"] + d["fresh"]
                                           + d["verify"] + d["steps"])
            + draft_norms * d["draft_steps"]}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want} (L x "
                             "(continuations + verify rounds) / fresh "
                             "chunks / fallback decode steps, 2L + 1 x "
                             f"target forwards + {draft_norms} x draft "
                             "steps)")
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
                 qlinears: int = 0, exempt=(),
                 decode_qlinears=None) -> dict:
    """Serve ``prompts`` through an eager ``Engine`` with the launch
    counts zeroed just before and read just after; check token counts,
    host syncs = admissions + decode steps, and every kernel's launches:
    B3 once an attention block x admissions (none for MLA, plain torch;
    none for a Mamba block), B7 2L + 1 x forwards,
    and with quantized weights B4 ``qlinears`` x admissions past 128
    tokens (int8) and B5 / B6 ``decode_qlinears`` (default ``qlinears``)
    x decode steps; every launch on its tensor-core / warp step but for
    the kernels in ``exempt``."""
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
    tc = _tc_launches(tag, exempt)
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
    dq = qlinears if decode_qlinears is None else decode_qlinears
    want = {k: 0 for k in launches}
    if cfg.attention.kind != "mla":
        want["flash_attention"] = (cfg.block_pattern.count("attn")
                                   * cfg.num_groups * admits)
    want["rmsnorm"] = (2 * cfg.num_layers + 1) * (admits + steps)
    if cfg.quant == "int8":
        want["int8_matmul"] = qlinears * long_admits
        want["w8a8_decode_matmul"] = dq * steps
    elif cfg.quant == "fp8":
        want["fp8_decode_matmul"] = dq * steps
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


COST_REQUESTS = 8           # phase 17 (a), (b)


def _cost_prompts(rng, vocab: int, sys_prompt, plens) -> list:
    """Phase 7's prompt mix: every other prompt behind the system
    prompt."""
    import numpy as np
    out = []
    for i, n in enumerate(plens):
        if i % 2 == 0:
            n = max(int(n), SYS_PROMPT + 1)
            out.append(np.concatenate(
                [sys_prompt, rng.integers(0, vocab, n - SYS_PROMPT)]))
        else:
            out.append(rng.integers(0, vocab, int(n)))
    return out


def _cost_drive(eng, tracer, prompts, max_new, tag: str) -> dict:
    """One drive with the launch counts zeroed just before and read just
    after: token counts, syncs = chunk dispatches + decode blocks, and B3
    / B2 / B1 / B7 at 28 / 28 / 28 / 57 a dispatch, every launch on the
    tensor-core / warp step."""
    torch = _torch()
    cfg = eng.lm.cfg
    base = _counts(eng, tracer, 0)
    n_ev = len(tracer.events)
    rejected0 = eng.stats.slo_rejected
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
    now = _counts(eng, tracer, n_ev)
    d = {k: now[k] - base[k] for k in ("syncs", "steps", "blocks",
                                        "prefill_tokens")}
    d["cont"], d["fresh"] = now["cont"], now["fresh"]
    if d["syncs"] != d["cont"] + d["fresh"] + d["blocks"]:
        raise AssertionError(f"{tag}: {d['syncs']} host syncs != "
                             f"{d['cont']} + {d['fresh']} chunk dispatches "
                             f"+ {d['blocks']} decode blocks")
    layers = cfg.num_layers
    want = {"paged_prefix_extend": layers * d["cont"],
            "flash_attention": layers * d["fresh"],
            "paged_attention": layers * d["steps"],
            "rmsnorm": (2 * layers + 1) * (d["cont"] + d["fresh"]
                                           + d["steps"])}
    if launches != want or min(launches.values()) == 0:
        raise AssertionError(f"{tag}: launches {launches} != {want}, or a "
                             "kernel never launched")
    for i, m in zip(ids, max_new):
        r = done[i]
        if r.rejected:
            if r.out_tokens:
                raise AssertionError(f"{tag}: rejected request {i} has "
                                     "tokens")
        elif len(r.out_tokens) != int(m) or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{tag}: request {i}: "
                                 f"{len(r.out_tokens)} tokens, want {m}")
    return {"streams": [done[i].out_tokens for i in ids],
            "rejected": [bool(done[i].rejected) for i in ids],
            "slo_rejected": eng.stats.slo_rejected - rejected0,
            "wall_s": wall, "launches": launches, "tc_launches": tc,
            "dispatches": {k: d[k] for k in ("fresh", "cont", "blocks",
                                             "steps")},
            "syncs": d["syncs"], "prefill_tokens": d["prefill_tokens"],
            "tokens": sum(len(done[i].out_tokens) for i in ids)}


def _cli_cost_runs(out_dir: Path) -> dict:
    """``python -m repro_torch.launch.serve`` twice as a user runs it: SJF
    open loop with the profiler, the calibration written and the metrics
    as JSON; then n-gram speculation over int8 weights seeded with that
    calibration, the metrics as Prometheus text."""
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen2-1.5b", "--requests", "8", "--prompt-len", "512",
            "--max-new", "32", "--slots", "8", "--max-len", "1024",
            "--page-size", "256", "--policy", "sjf"]
    files = {k: out_dir / f"cost_{k}" for k in
             ("c1.json", "m1.json", "t1.json", "c2.json", "m2.prom")}
    runs = (["--arrival-rate", "40", "--profile", "--calibration-out",
             str(files["c1.json"]), "--metrics", str(files["m1.json"]),
             "--trace-out", str(files["t1.json"])],
            ["--spec", "ngram", "--quant", "int8", "--calibration-in",
             str(files["c1.json"]), "--calibration-out",
             str(files["c2.json"]), "--metrics", str(files["m2.prom"])])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    walls = []
    for extra in runs:
        t0 = time.perf_counter()
        proc = subprocess.run(base + extra, cwd=str(ROOT), env=env,
                              capture_output=True, text=True, timeout=300)
        walls.append(time.perf_counter() - t0)
        if proc.returncode != 0:
            raise AssertionError(f"serve {' '.join(extra)}: exit "
                                 f"{proc.returncode}\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-4000:]}")
    for k, f in files.items():
        if not f.is_file() or f.stat().st_size == 0:
            raise AssertionError(f"serve wrote no {k}")
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import service_estimate
    m1 = json.loads(files["m1.json"].read_text())
    m2 = files["m2.prom"].read_text()
    names1 = {k.split("{")[0] for part in ("counters", "gauges")
              for k in m1[part]}
    names2 = {line.split("{")[0].split(" ")[0] for line in m2.splitlines()
              if line and not line.startswith("#")}
    est_keys = {f"costmodel_{k}" for k in service_estimate(
        get_config("qwen2-1.5b"), prompt=512, gen=32)}
    for names, tag in ((names1, "m1.json"), (names2, "m2.prom")):
        missing = ({"profile_dispatch_seconds_total",
                    "costmodel_drift_ratio"} | est_keys) - names
        if missing:
            raise AssertionError(f"serve {tag} lacks {sorted(missing)}")
    c1 = {(f["kind"], f["arm"]): f for f in
          json.loads(files["c1.json"].read_text())["factors"]}
    c2 = {(f["kind"], f["arm"]): f for f in
          json.loads(files["c2.json"].read_text())["factors"]}
    if not c1 or any(c2.get(k) != v for k, v in c1.items()) \
            or not set(c2) - set(c1):
        raise AssertionError("the second run's calibration does not start "
                             "from the first's factors")
    return {"walls_s": walls, "series_first": len(c1),
            "series_second": len(c2),
            "spec_kinds": sorted({k for k, _ in c2} - {k for k, _ in c1})}


def phase_cost(records: list) -> dict:
    """The cost model's H100 tier driving the port's SchedEngine,
    qwen2-1.5b at full width, bf16: (a) SJF over 8 of phase 7's requests
    with the DispatchProfiler on, then the same drive with it off (equal
    streams, syncs and launches; the samples' drift against the analytic
    dispatch estimates); (b) EDF with admission control and a TTFT target
    between the estimates of the short and the long prompts; (c) the
    serving CLI twice with the profiler, the calibration and the metrics
    files."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import (TIERS, CalibratedCostModel,
                                            dispatch_estimate,
                                            service_estimate)
    from repro_torch.models.model import LM
    from repro_torch.obs import DISPATCH_KINDS, DispatchProfiler, Tracer
    from repro_torch.sched import SchedEngine
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-1.5b").with_(num_layers=E2E_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    tier = TIERS["h100-1"]
    vocab = cfg.vocab_size
    rng = np.random.default_rng(SEED + 7)            # phase 7's generator
    sys_prompt = rng.integers(0, vocab, SYS_PROMPT)
    warm = np.concatenate([sys_prompt, rng.integers(0, vocab, 100)])
    prompts = _cost_prompts(rng, vocab, sys_prompt,
                            rng.integers(600, 3001, COST_REQUESTS))
    max_new = rng.integers(32, 65, COST_REQUESTS)
    kw = dict(n_slots=8, max_len=4096, page_size=256, prefill_chunk=512,
              decode_block=8, seed=SEED)

    # (a) SJF, profiled then not: each engine warmed alike (the system
    # prompt served once, so that half the drive hits the prefix cache)
    arms = {}
    for name, on in (("profiled", True), ("plain", False)):
        tracer = Tracer(enabled=True)
        prof = DispatchProfiler(enabled=on)
        eng = SchedEngine(lm, params, policy="sjf", prefix_cache=True,
                          tracer=tracer, profiler=prof, **kw)
        eng.submit(warm, max_new_tokens=8)
        eng.run_to_completion()
        torch.cuda.synchronize()
        prof.samples.clear()
        arms[name] = _cost_drive(eng, tracer, prompts, max_new,
                                 f"cost sjf {name}")
        arms[name]["samples"] = list(prof.samples)
        del eng
    a, b0 = arms["profiled"], arms["plain"]
    for key in ("streams", "syncs", "launches", "dispatches"):
        if a[key] != b0[key]:
            raise AssertionError(f"cost sjf: {key} differ with the profiler "
                                 f"on ({a[key] if key != 'streams' else ''})"
                                 f" and off")
    samples = a["samples"]
    bad = {s.kind for s in samples} - set(DISPATCH_KINDS)
    if bad or len(samples) != a["syncs"]:
        raise AssertionError(f"cost sjf: {len(samples)} samples for "
                             f"{a['syncs']} syncs, kinds {bad} unknown")
    pre = sum(s.tokens for s in samples
              if s.kind in ("admit", "prefill_chunk"))
    if pre != a["prefill_tokens"]:
        raise AssertionError(f"cost sjf: samples carry {pre} prefill "
                             f"tokens, the engine computed "
                             f"{a['prefill_tokens']}")
    prof = DispatchProfiler(enabled=True).bind(cfg, layout="paged")
    prof.samples = samples
    calib = CalibratedCostModel()
    calib.fit_profile(prof, cfg, tier, layout="paged")
    attain = {}
    for agg in prof.summary(tier).values():
        attain.setdefault(agg["kind"], []).append(agg["attainment"])
    kinds = {}
    for kind in sorted({s.kind for s in samples}):
        ks = [s for s in samples if s.kind == kind]
        est = [dispatch_estimate(cfg, tier, kind=kind, tokens=s.tokens,
                                 rows=s.rows, steps=s.steps,
                                 bucket=s.bucket, ctx=s.ctx, layout="paged")
               for s in ks]
        kinds[kind] = {"n": len(ks),
                       "median_ms": statistics.median(s.dur_s for s in ks)
                       * 1e3,
                       "median_estimate_ms": statistics.median(est) * 1e3,
                       "drift": calib.correction(kind),
                       "attainment": attain.get(kind)}
    for r in records:
        if r["name"] in a["launches"]:
            r.setdefault("launches_by_drive", {})["cost_sjf"] = \
                a["launches"][r["name"]]

    # (b) EDF + admission control: 4 prompts of 600-1,000 tokens and 4 of
    # 2,400-3,000, the TTFT target midway between the largest short and
    # the smallest long prefill estimate
    plens = np.concatenate([rng.integers(600, 1001, 4),
                            rng.integers(2400, 3001, 4)])
    eprompts = [rng.integers(0, vocab, int(n)) for n in plens]
    enew = rng.integers(32, 65, COST_REQUESTS)
    est = [service_estimate(cfg, tier, prompt=int(n), gen=0, chunk=512,
                            layout="paged")["t_prefill_s"] for n in plens]
    short, long_ = max(est[:4]), min(est[4:])
    slo = (short + long_) / 2
    if long_ - short < 2e-3:
        raise AssertionError(f"cost edf: estimates {short:.4f} / "
                             f"{long_:.4f} s too close for a TTFT target")
    tracer = Tracer(enabled=True)
    eng = SchedEngine(lm, params, policy="edf", prefix_cache=False,
                      admission_control=True, slo_ttft=slo, tracer=tracer,
                      **kw)
    e = _cost_drive(eng, tracer, eprompts, enew, "cost edf")
    want = [x > slo for x in est]
    served = sum(not r for r in e["rejected"])
    if e["rejected"] != want or e["slo_rejected"] != sum(want) \
            or e["slo_rejected"] + served != COST_REQUESTS:
        raise AssertionError(f"cost edf: rejected {e['rejected']}, want "
                             f"{want} (estimates {est}, target {slo})")
    free = len(eng.alloc.free)
    if free != eng.alloc.n_pages - 1:
        raise AssertionError(f"cost edf: {free} pages free at the end, want "
                             f"{eng.alloc.n_pages - 1}")
    e["slo_ttft_s"], e["estimates_s"] = slo, est
    del eng, lm, params
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the serving CLI, as a user runs it
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    c = _cli_cost_runs(out_dir)
    wall = time.perf_counter() - t_phase
    for arm in (a, b0, e):
        arm.pop("streams")
    a.pop("samples")
    b0.pop("samples")
    out = {"sjf_profiled": a, "sjf_plain": b0, "kinds": kinds, "edf": e,
           "cli": c, "phase_wall_s": wall, "calibration": calib.to_json()}
    drift = ", ".join(f"{k} {v['n']} x {v['median_ms']:.3f} ms measured / "
                      f"{v['median_estimate_ms']:.3f} ms h100-1, drift "
                      f"{v['drift']:.2f}" for k, v in kinds.items())
    print(f"[17 cost] {cfg.name} {cfg.num_layers}L bf16 SchedEngine, 8 "
          f"slots, chunk 512: (a) SJF {COST_REQUESTS} req, profiled "
          f"{a['wall_s']:.3f}s / plain {b0['wall_s']:.3f}s, same streams, "
          f"{a['syncs']} syncs and launches {a['launches']} (tensor-core "
          f"{a['tc_launches']}); samples: {drift} | (b) EDF + admission "
          f"control at {slo * 1e3:.3f} ms: {e['slo_rejected']} rejected, "
          f"{COST_REQUESTS - e['slo_rejected']} served, every page free "
          f"| (c) serve --profile --calibration-out, then --spec ngram "
          f"--quant int8 --calibration-in: {c['walls_s'][0]:.1f}s + "
          f"{c['walls_s'][1]:.1f}s, {c['series_first']} then "
          f"{c['series_second']} calibration series | phase "
          f"{wall:.1f}s")
    return out


SEARCH_REQUESTS = 1         # phase 18 (b), each arm (of more, the first
                            # warms up)
SEARCH_PROMPT, SEARCH_GEN = 512, 128    # the cost model's protocol
#: the budget of the reference's tests/test_core_aellm.py::_small_tuner
SEARCH_BUDGET = dict(n0=48, refine_iters=1, k_per_iter=8, pop_size=24,
                     generations=10, seed=SEED)


def _search_counts(eng, tracer, since_events: int) -> dict:
    """Phase 7's dispatch counts plus a speculative engine's verify rounds
    and draft-LM steps (0 on the plain scheduler)."""
    c = _counts(eng, tracer, since_events)
    st = getattr(eng, "spec_stats", None)
    c["verify"] = st.verify_steps if st is not None else 0
    c["draft_steps"] = getattr(getattr(eng, "drafter", None), "steps", 0)
    return c


def _search_drive(eng, tracer, prompts, tag: str, draft_norms: int) -> dict:
    """Serve ``prompts`` one after another (each request alone on the
    card, as the cost model prices it), with the launch counts zeroed
    just before and read just after: every request gets its 128 tokens,
    every page is freed, syncs = chunk dispatches + verify rounds + decode
    blocks, and each kernel launched exactly as the dispatches ask (B3 /
    B2 / B1 at L a fresh chunk / continuation or verify round / decode
    step, B7 at 2L + 1 a forward; B4 / B5 / B6 at ``_qlinears`` a
    dispatch past / within 128 rows for int8 / fp8 weights: 28, 57 and
    196 for qwen2-1.5b, 4 attention linears a layer for an upcycled MoE
    c*)."""
    torch = _torch()
    cfg = eng.lm.cfg
    base = _search_counts(eng, tracer, 0)
    n_ev = len(tracer.events)
    rows = _record_dispatch_rows(eng)
    _reset_launches()
    lat, ttft = [], []
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        rid = eng.submit(p, max_new_tokens=SEARCH_GEN)
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        r = done[rid]
        ttft.append(r.t_first - r.t_submit)
        if r.rejected or len(r.out_tokens) != SEARCH_GEN or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            raise AssertionError(f"{tag} request {i}: {len(r.out_tokens)} "
                                 f"tokens, want {SEARCH_GEN}")
    launches = _read_launches()
    tc = _tc_launches(tag)
    now = _search_counts(eng, tracer, n_ev)
    d = {k: now[k] - base[k] for k in now if k not in ("cont", "fresh")}
    d["cont"], d["fresh"] = now["cont"], now["fresh"]
    if d["syncs"] != d["cont"] + d["fresh"] + d["verify"] + d["blocks"]:
        raise AssertionError(f"{tag}: {d['syncs']} host syncs != "
                             f"{d['cont']} + {d['fresh']} chunk dispatches "
                             f"+ {d['verify']} verify rounds + "
                             f"{d['blocks']} decode blocks")
    free = len(eng.alloc.free)
    if free != eng.alloc.n_pages - 1:
        raise AssertionError(f"{tag}: {free} pages free at the end, want "
                             f"{eng.alloc.n_pages - 1}")
    layers, q = cfg.num_layers, _qlinears(cfg)
    big = sum(m > 128 for m in rows)
    small = len(rows) - big + d["verify"] + d["steps"]
    want = {"paged_prefix_extend": layers * (d["cont"] + d["verify"]),
            "flash_attention": layers * d["fresh"],
            "paged_attention": layers * d["steps"],
            "int8_matmul": q * big if cfg.quant == "int8" else 0,
            "w8a8_decode_matmul": q * small if cfg.quant == "int8" else 0,
            "fp8_decode_matmul": q * small if cfg.quant == "fp8" else 0,
            "rmsnorm": (2 * layers + 1) * (len(rows) + d["verify"]
                                           + d["steps"])
            + draft_norms * d["draft_steps"],
            "wkv6": 0}
    if launches != want or len(rows) != d["cont"] + d["fresh"]:
        raise AssertionError(f"{tag}: launches {launches} != {want} "
                             f"(dispatch rows {rows}, {d['verify']} verify "
                             f"rounds, {d['steps']} decode steps)")
    tail = slice(1 if len(lat) > 1 else 0, None)    # the first warms up
    return {"latency_ms": statistics.median(lat[tail]) * 1e3,
            "ttft_ms": statistics.median(ttft[tail]) * 1e3,
            "latency_all_ms": [x * 1e3 for x in lat],
            "ttft_all_ms": [x * 1e3 for x in ttft],
            "launches": launches, "tc_launches": tc,
            "dispatches": {k: d[k] for k in ("fresh", "cont", "verify",
                                             "blocks", "steps")},
            "syncs": d["syncs"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def _search_eager_drive(eng, tracer, prompts, tag: str) -> dict:
    """``_search_drive`` for the eager ``Engine`` (an MLA arm): each prompt
    served alone by ``_eager_drive``, with its checks and launch rule (B4
    at ``_qlinears`` an admission, B5 / B6 at ``_qlinears(decode=True)`` a
    decode step), reshaped to ``_search_drive``'s result."""
    import collections
    torch = _torch()
    cfg = eng.lm.cfg
    runs = [_eager_drive(eng, tracer, [p], [SEARCH_GEN], f"{tag} request {i}",
                         qlinears=_qlinears(cfg),
                         decode_qlinears=_qlinears(cfg, decode=True))
            for i, p in enumerate(prompts)]

    def total(key):
        return dict(sum((collections.Counter(r[key]) for r in runs),
                        collections.Counter()))
    lat = [r["wall_s"] for r in runs]
    ttft = [r["ttft_p50_s"] for r in runs]
    admits = sum(r["admissions"] for r in runs)
    steps = sum(r["decode_steps"] for r in runs)
    tail = slice(1 if len(lat) > 1 else 0, None)    # the first warms up
    return {"latency_ms": statistics.median(lat[tail]) * 1e3,
            "ttft_ms": statistics.median(ttft[tail]) * 1e3,
            "latency_all_ms": [x * 1e3 for x in lat],
            "ttft_all_ms": [x * 1e3 for x in ttft],
            "launches": total("launches"), "tc_launches": total("tc_launches"),
            "dispatches": {"fresh": admits, "cont": 0, "verify": 0,
                           "blocks": steps, "steps": steps},
            "syncs": sum(r["syncs"] for r in runs),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def _serve_search_arm(cfg, eff, tag: str) -> dict:
    """Serve ``eff`` on ``cfg`` at full width through the SchedEngine (the
    SpecEngine where its spec arm asks for it), one slot, page 256, chunk
    512, greedy, random weights from the seed, quantized by
    ``apply_to_params`` without the fine-tuning arm.  An MLA arm goes
    through the eager ``Engine`` (one slot, max_len 768): the paged
    engines refuse MLA in both packages, so its spec arm, if any, has no
    engine and is reported as unserved."""
    import dataclasses
    torch = _torch()
    import numpy as np
    from repro_torch.core.apply import apply_efficiency_config, \
        apply_to_params
    from repro_torch.core.space import FtChoice
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.sched import SchedEngine
    from repro_torch.spec import SpecEngine, draft_config_of
    acfg = apply_efficiency_config(cfg, eff)
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(acfg, device="cuda")
    params = apply_to_params(lm.init(SEED), dataclasses.replace(
        eff, ft=FtChoice("full", 0, 1)), None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()          # the weights are made
    tracer = Tracer(enabled=True)
    rng = np.random.default_rng(SEED + 18)
    prompts = [rng.integers(0, cfg.vocab_size, SEARCH_PROMPT)
               for _ in range(SEARCH_REQUESTS)]
    if acfg.attention.kind == "mla":
        from repro_torch.serve.engine import Engine
        eng = Engine(lm, params, n_slots=1, max_len=3 * 256, seed=SEED,
                     tracer=tracer)
        out = _search_eager_drive(eng, tracer, prompts, tag)
        out["engine"] = "Engine"
        out["spec_unserved"] = acfg.spec_decode
        del eng, lm, params
        gc.collect()
        torch.cuda.empty_cache()
        return out
    kw = dict(policy="fcfs", prefix_cache=False, n_slots=1,
              max_len=3 * 256, page_size=256, prefill_chunk=512,
              decode_block=8, seed=SEED, tracer=tracer)
    draft_norms = 0
    if acfg.spec_decode == "none":
        eng = SchedEngine(lm, params, **kw)
    else:
        draft_lm = draft_params = None
        if acfg.spec_decode == "draft":       # phase 14 (b)'s bf16 draft
            draft_lm = LM(draft_config_of(cfg), device="cuda")
            draft_params = draft_lm.init(SEED + 1)
            draft_norms = DRAFT_NORMS
        eng = SpecEngine(lm, params, spec=acfg.spec_decode,
                         draft_k=acfg.spec_draft_k, draft_lm=draft_lm,
                         draft_params=draft_params, **kw)
    out = _search_drive(eng, tracer, prompts, tag, draft_norms)
    out["engine"] = type(eng).__name__
    del eng, lm, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_search(records: list, calibration: dict) -> dict:
    """Search → serve, the source paper's question for one deployment:
    (a) the port's AutoTuner at ``h100-1`` on qwen2-1.5b at full width
    (28 layers, d 1536, 12 heads over 2, d_ff 8960, bf16, tied) for MMLU
    at 512 tokens, the budget of the reference's ``_small_tuner`` and its
    whole ``SpaceMask()`` (the attention arms too: an MLA c* is served
    through the eager Engine; the MoE arms, c* may upcycle the MLP to
    experts; the KV arms: B1 takes any group); it prints c*
    (``recommend_efficient``), c*'s and Default's objectives and the
    Efficiency Score, then recalibrates the fitted tuner with phase 17's
    ``CalibratedCostModel`` and prints the shifts.  (b) Default and c*
    served at full width, 2 requests of 512 prompt tokens and 128 new
    tokens one after another (the first warms up): measured request
    latency and TTFT, the peak device memory after the weights are made,
    and ``predict(..., layout="paged")``'s latency and memory, uncalibrated
    and calibrated.  Each arm is ``LM.init`` of
    ``apply_efficiency_config(cfg, arm)`` (MoE layers when the arm
    upcycles), its weights quantized by ``apply_to_params``; the
    fine-tuning arm is left out, since LoRA's B starts at zero and an
    untrained adapter does not change the logits.  Energy stays analytic.
    The phase fails on a refused c*, a short stream, a leaked page or a
    launch count that does not match the dispatches; the measured and
    predicted ratios are a finding, not a check."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import TIERS, CalibratedCostModel, \
        predict
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.features import TaskSpec
    from repro_torch.core.pareto import efficiency_score
    from repro_torch.core.space import EfficiencyConfig, SpaceMask
    from repro_torch.core.tuner import AutoTuner, recommend_efficient
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-1.5b").with_(num_layers=E2E_LAYERS)
    tier = TIERS["h100-1"]
    ev = Evaluator(cfg, TaskSpec("mmlu", "understanding", 0.7, 512), tier)
    tuner = AutoTuner(ev, mask=SpaceMask(), **SEARCH_BUDGET)
    report = tuner.run()
    t_search = time.perf_counter() - t_phase
    default = EfficiencyConfig.default()
    base = ev.evaluate(default)
    cstar, obj = recommend_efficient(report.archive, base)
    if cstar is None:
        raise AssertionError("search: an empty Pareto front")
    score = efficiency_score(obj, base)
    calib = CalibratedCostModel.from_json(calibration)
    shifts = tuner.recalibrate(calib)

    arms, pred = {}, {}
    for name, eff in (("default", default), ("cstar", cstar)):
        arms[name] = _serve_search_arm(cfg, eff, f"search {name}")
        pred[name] = {
            lab: {k: predict(cfg, eff, tier, layout="paged",
                             calibration=c)[k]
                  for k in ("latency_ms", "memory_gb", "energy_j")}
            for lab, c in (("analytic", None), ("calibrated", calib))}
    for r in records:
        for name, a in arms.items():
            if a["launches"].get(r["name"]):
                r.setdefault("launches_by_drive", {})[f"search_{name}"] = \
                    a["launches"][r["name"]]
    ratio = {"latency_measured": arms["default"]["latency_ms"]
             / arms["cstar"]["latency_ms"],
             "memory_measured": arms["default"]["peak_mem_gib"]
             / arms["cstar"]["peak_mem_gib"]}
    for lab in ("analytic", "calibrated"):
        for key, m in (("latency", "latency_ms"), ("memory", "memory_gb")):
            ratio[f"{key}_{lab}"] = pred["default"][lab][m] \
                / pred["cstar"][lab][m]
    wall = time.perf_counter() - t_phase
    out = {"cstar": str(cstar), "cstar_objs": [float(x) for x in obj],
           "default_objs": [float(x) for x in base],
           "efficiency_score": score, "n_real_evals": report.n_real_evals,
           "surrogate_r2": report.surrogate_r2, "search_wall_s": t_search,
           "shifts": shifts, "arms": arms, "predicted": pred,
           "ratio_default_over_cstar": ratio, "phase_wall_s": wall}

    def arm(name):
        a, p = arms[name], pred[name]
        return (f"{name} ({a['engine']}): {a['latency_ms']:.2f} ms a request"
                f", TTFT {a['ttft_ms']:.2f} ms, peak "
                f"{a['peak_mem_gib']:.3f} GiB, predicted "
                f"{p['analytic']['latency_ms']:.2f} / calibrated "
                f"{p['calibrated']['latency_ms']:.2f} ms and "
                f"{p['analytic']['memory_gb']:.3f} GiB, energy "
                f"{p['analytic']['energy_j']:.3f} J (analytic), "
                f"launches {a['launches']}"
                + (f", spec arm {a['spec_unserved']!r} unserved: no engine "
                   "of either package speculates over MLA"
                   if a.get("spec_unserved", "none") != "none" else ""))
    print(f"[18 search] {cfg.name} {cfg.num_layers}L at h100-1, mmlu/512, "
          f"{report.n_real_evals} real evals in {t_search:.1f}s: c* = "
          f"{cstar} | c* [acc, lat_ms, mem_gb, energy_j] = "
          f"{[round(float(x), 4) for x in obj]}, Default "
          f"{[round(float(x), 4) for x in base]}, Efficiency Score "
          f"{score:.3f} | recalibrated from phase 17: lat shift "
          f"{shifts['lat']:+.4f}, energy shift {shifts['energy']:+.4f} "
          f"(log) | served {SEARCH_REQUESTS} x {SEARCH_PROMPT} + "
          f"{SEARCH_GEN}, "
          + (f"median of the last {SEARCH_REQUESTS - 1}: "
             if SEARCH_REQUESTS > 1 else "no warm-up request: ") +
          f"{arm('default')}; "
          f"{arm('cstar')} | Default / c* latency: measured "
          f"{ratio['latency_measured']:.3f}, predicted "
          f"{ratio['latency_analytic']:.3f}, calibrated "
          f"{ratio['latency_calibrated']:.3f}; memory: measured "
          f"{ratio['memory_measured']:.3f}, predicted "
          f"{ratio['memory_analytic']:.3f} | phase {wall:.1f}s")
    return out


GRANITE = "granite-moe-3b-a800m"
SCOUT = "llama4-scout-17b-a16e"
DEEPSEEK = "deepseek-coder-33b"
SCOUT_LAYERS = 8            # phase 19 (b): 8 of llama4-scout's 48 layers
SCOUT_REQUESTS = 4          # two waves on its 2 slots
MOE_Q_REQUESTS = 4          # phase 19 (a1), (a2), (a3) and (c)
MOE_NEW = (8, 17)           # (a1), (a2): new tokens a request, [lo, hi)
MOE_SPEC_NEW = 32           # (a3)
MOE_APPLY_TOKENS = 1024     # phase 19 (d): two routing groups of 512
#: deepseek-coder-33b's linears (K, N): wq / wo, wk / wv, gate / up, down
DEEPSEEK_QMM = [(7168, 7168), (7168, 1024), (7168, 19200), (19200, 7168)]
#: moe_apply on the card vs the CPU: relative L2 of the outputs, and the
#: dropped fractions' difference
MOE_REL_L2, MOE_DROP_TOL = 2e-2, 1e-3


def _watch_logits(lm):
    """Make every logits tensor ``lm`` computes fold into one device flag
    (no host read during a drive); returns the flag's reader."""
    torch = _torch()
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    inner = lm._logits

    def logits(params, x):
        out = inner(params, x)
        ok.logical_and_(torch.isfinite(out).all())
        return out
    lm._logits = logits
    return lambda: bool(ok.item())


def _moe_paged_drive(eng, tracer, prompts, max_new, tag: str,
                     exempt=()) -> dict:
    """Serve ``prompts`` through a paged engine (PagedEngine, SchedEngine
    or SpecEngine) with the launch counts zeroed just before and read
    just after.  Fails on a short stream or a token out of vocab, a page
    still owned by a slot (or, with a prefix cache, one neither free nor
    cached), host syncs != dispatches, a non-finite logit, or launches
    other than the config asks: B3 L a fresh chunk or admission, B2 L a
    continuation or verify round, B1 L a decode step, B7 2L + 1 a
    forward, and with int8 weights B4 ``_qlinears`` a dispatch past 128
    rows and B5 ``_qlinears`` a dispatch within them, a verify round or
    a decode step."""
    torch = _torch()
    cfg = eng.lm.cfg
    finite = _watch_logits(eng.lm)
    sched = hasattr(eng, "_chunk_impl")
    st = getattr(eng, "spec_stats", None)

    def counts():
        snap = eng.metrics.snapshot()["counters"]
        return {"syncs": eng.sync_count, "steps": eng.steps_run,
                "blocks": int(snap["serve_decode_dispatches_total"]),
                "prefill": int(snap["serve_prefill_dispatches_total"]),
                "verify": st.verify_steps if st is not None else 0}
    base, n_ev = counts(), len(tracer.events)
    phase0 = (eng.t_prefill_s, eng.t_decode_s)
    rows = _record_dispatch_rows(eng)
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    tc = _tc_launches(tag, exempt)
    now = counts()
    d = {k: now[k] - base[k] for k in now}
    if sched:
        c = _counts(eng, tracer, n_ev)
        d["cont"], d["fresh"] = c["cont"], c["fresh"]
    else:
        d["cont"], d["fresh"] = 0, d["prefill"]
    n_tok = 0
    for i, m in zip(ids, max_new):
        got = done[i].out_tokens
        if len(got) != int(m) or not all(0 <= t < cfg.vocab_size
                                         for t in got):
            raise AssertionError(f"{tag} request {i}: {len(got)} tokens "
                                 f"(want {m}) or a token out of vocab")
        n_tok += len(got)
    if d["syncs"] != d["cont"] + d["fresh"] + d["verify"] + d["blocks"] \
            or len(rows) != d["cont"] + d["fresh"]:
        raise AssertionError(f"{tag}: {d['syncs']} host syncs != "
                             f"{d['cont']} + {d['fresh']} prefill "
                             f"dispatches + {d['verify']} verify rounds + "
                             f"{d['blocks']} decode blocks ({len(rows)} "
                             "dispatch rows recorded)")
    alloc = eng.alloc
    cached = len(eng.prefix.nodes) if getattr(eng, "prefix", None) else 0
    if any(alloc.owned(s) for s in range(eng.n_slots)) \
            or len(alloc.free) + cached != alloc.n_pages - 1:
        raise AssertionError(f"{tag}: a leaked page ({len(alloc.free)} "
                             f"free + {cached} cached of "
                             f"{alloc.n_pages - 1})")
    if not finite():
        raise AssertionError(f"{tag}: a non-finite logit")
    layers, q = cfg.num_layers, _qlinears(cfg)
    big = sum(m > 128 for m in rows)
    small = len(rows) - big + d["verify"] + d["steps"]
    want = {"paged_prefix_extend": layers * (d["cont"] + d["verify"]),
            "flash_attention": layers * d["fresh"],
            "paged_attention": layers * d["steps"],
            "int8_matmul": q * big if cfg.quant == "int8" else 0,
            "w8a8_decode_matmul": q * small if cfg.quant == "int8" else 0,
            "fp8_decode_matmul": 0,
            "rmsnorm": (2 * layers + 1) * (len(rows) + d["verify"]
                                           + d["steps"]),
            "wkv6": 0}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != {want} "
                             f"(dispatch rows {rows}, {d['verify']} verify "
                             f"rounds, {d['steps']} decode steps)")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    # decode blocks and verify rounds: the wall of one decode step or
    # verify round, each ending in its share of the dispatch's one sync
    t_dec = eng.t_decode_s - phase0[1]
    out = {"tokens_per_s": n_tok / wall,
           "ttft_p50_s": statistics.median(ttft), "wall_s": wall,
           "tokens": n_tok, "requests": len(ids),
           "prompt_tokens": int(sum(len(p) for p in prompts)),
           "fresh_dispatches": d["fresh"], "cont_dispatches": d["cont"],
           "verify_rounds": d["verify"], "decode_blocks": d["blocks"],
           "decode_steps": d["steps"], "syncs": d["syncs"],
           "prefill_wall_s": eng.t_prefill_s - phase0[0],
           "decode_wall_s": t_dec,
           "decode_step_wall_ms": 1e3 * t_dec / max(d["steps"]
                                                    + d["verify"], 1),
           "launches": {k: v for k, v in launches.items() if v},
           "tc_launches": {k: v for k, v in tc.items() if v},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if st is not None:
        out["acceptance_rate"] = st.drafts_accepted / max(
            st.drafts_proposed, 1)
    return out


def _moe_line(tag: str, r: dict) -> str:
    return (f"{tag}: {r['requests']} req ({r['prompt_tokens']} prompt "
            f"tokens), {r['tokens']} tokens in {r['wall_s']:.3f}s "
            f"({r['tokens_per_s']:.1f} tok/s), TTFT p50 "
            f"{r['ttft_p50_s']:.4f}s, decode step (or verify round) "
            f"{r['decode_step_wall_ms']:.2f} ms, peak "
            f"{r['peak_mem_gb']:.2f} GB (weights {r['weights_gb']:.2f} GB), "
            f"launches {r['launches']}, tensor-core launches "
            f"{r['tc_launches']}")


def _moe_granite() -> dict:
    """(a) granite-moe-3b-a800m at full width and depth, bf16, through the
    scheduler (a1), the paged engine on int8 weights and pools (a2) and
    the n-gram SpecEngine (a3)."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_serve import passage_prompt
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.quant import quantize_tree
    from repro_torch.sched import SchedEngine
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.spec import SpecEngine
    cfg = get_config(GRANITE)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    weights_gb = _setup_peak_gb()
    rng = np.random.default_rng(SEED + 19)
    vocab = cfg.vocab_size
    kw = dict(policy="fcfs", prefix_cache=True, n_slots=8, max_len=4096,
              page_size=256, prefill_chunk=512, decode_block=8, seed=SEED)
    out = {}

    # (a1) phase 7's drive at half its requests: half the prompts behind
    # one system prompt
    tracer = Tracer(enabled=True)
    eng = SchedEngine(lm, params, tracer=tracer, **kw)
    sys_prompt = rng.integers(0, vocab, SYS_PROMPT)
    eng.submit(np.concatenate([sys_prompt, rng.integers(0, vocab, 100)]),
               max_new_tokens=8)
    eng.run_to_completion()                  # warms the prefix cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plens = rng.integers(600, 3001, MOE_Q_REQUESTS)
    prompts = [np.concatenate([sys_prompt, rng.integers(
        0, vocab, max(int(n), SYS_PROMPT + 1) - SYS_PROMPT)])
        if i % 2 == 0 else rng.integers(0, vocab, int(n))
        for i, n in enumerate(plens)]
    hit0 = eng.stats.prefix_hit_tokens
    out["a1_sched"] = _moe_paged_drive(
        eng, tracer, prompts, rng.integers(*MOE_NEW, MOE_Q_REQUESTS),
        "moe granite sched")
    out["a1_sched"]["prefix_hit_tokens"] = eng.stats.prefix_hit_tokens - hit0
    if out["a1_sched"]["prefix_hit_tokens"] <= 0:
        raise AssertionError("moe granite sched: no prefix-cache hit")
    del eng

    # (a3) the n-gram SpecEngine on the same settings, repeated passages
    tracer = Tracer(enabled=True)
    eng = SpecEngine(lm, params, spec="ngram", draft_k=4, adaptive=True,
                     tracer=tracer, **kw)
    eng.submit(passage_prompt(rng, vocab, 700), max_new_tokens=16)
    eng.run_to_completion()                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts = [passage_prompt(rng, vocab, int(n))
               for n in rng.integers(600, 3001, MOE_Q_REQUESTS)]
    out["a3_spec"] = _moe_paged_drive(eng, tracer, prompts,
                                      [MOE_SPEC_NEW] * MOE_Q_REQUESTS,
                                      "moe granite spec")
    if out["a3_spec"]["verify_rounds"] <= 0:
        raise AssertionError("moe granite spec: no verify round")
    del eng

    # (a2) int8 weights (attention linears; expert stacks stay bf16, the
    # router fp32) and int8 pools through the paged engine
    qcfg = cfg.with_(quant="int8", kv_cache_dtype="int8")
    qlm = LM(qcfg, device="cuda")
    qparams = quantize_tree(params, quant="int8")
    del params, lm
    q_gb = _setup_peak_gb()
    tracer = Tracer(enabled=True)
    eng = PagedEngine(qlm, qparams, n_slots=8, max_len=4096, page_size=256,
                      decode_block=8, seed=SEED, tracer=tracer)
    eng.submit(rng.integers(0, vocab, 300), max_new_tokens=8)
    eng.run_to_completion()                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts = [rng.integers(0, vocab, int(n))
               for n in rng.integers(600, 3001, MOE_Q_REQUESTS)]
    out["a2_paged_int8"] = _moe_paged_drive(
        eng, tracer, prompts, rng.integers(*MOE_NEW, MOE_Q_REQUESTS),
        "moe granite paged int8")
    del eng, qparams, qlm
    for k, gb in (("a1_sched", weights_gb), ("a3_spec", weights_gb),
                  ("a2_paged_int8", q_gb)):
        out[k]["weights_gb"] = gb
    return out


def _moe_scout() -> dict:
    """(b) llama4-scout-17b-a16e at full width and 8 layers, bf16, through
    the eager Engine: 2 slots, prompts past its 8,192 window; B3 held
    windowed at its head shape first."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.serve.engine import Engine
    cfg = get_config(SCOUT).with_(num_layers=SCOUT_LAYERS)
    a = cfg.attention
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 191)
    q, k, v = _flash_inputs(2, 1024, torch.bfloat16, g, device,
                            a.num_heads, a.num_kv_heads, a.head_dim)
    tc0 = fops.tc_launches
    o = fops.flash_attention(q, k, v, causal=True, window=512)
    held = check_close(f"B3 S1024 H{a.num_heads}/{a.num_kv_heads} "
                       f"D{a.head_dim} w512"
                       + _step_tag(fops.tc_launches - tc0, True), o,
                       attention_ref(q, k, v, causal=True, window=512), 1.0)
    del q, k, v, o
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    weights_gb = _setup_peak_gb()
    rng = np.random.default_rng(SEED + 192)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(9000, 12001, SCOUT_REQUESTS)]
    tracer = Tracer(enabled=True)
    eng = Engine(lm, params, n_slots=2, max_len=12_288 + 64, seed=SEED,
                 tracer=tracer)
    finite = _watch_logits(lm)
    eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new_tokens=4)
    eng.run_to_completion()                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = _eager_drive(eng, tracer, prompts, [32] * SCOUT_REQUESTS,
                     "moe scout eager", exempt=("rmsnorm",))
    if not finite():
        raise AssertionError("moe scout eager: a non-finite logit")
    r.pop("streams")
    r["decode_step_wall_ms"] = 1e3 * r["decode_wall_s"] / max(
        r["decode_steps"], 1)
    r["weights_gb"] = weights_gb
    r["held"] = held
    del eng, lm, params
    return r


def _flash_times(b: int, s: int, h: int, kh: int, d: int, g,
                 device) -> dict:
    """B3 (causal, bf16) at B x S, H over KH heads of D: one call's device
    time beside its plain version's and SDPA's, and its bound."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    copies = [_flash_inputs(b, s, torch.bfloat16, g, device, h, kh, d)
              for _ in range(4)]
    q, k = copies[0][:2]
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * b * h * d * flash_pairs(s, s, True, None)
    return {
        "ms": time_ms(lambda a, b_, c: fops.flash_attention(a, b_, c),
                      copies),
        "plain_ms": time_ms(lambda a, b_, c: attention_ref(a, b_, c),
                            copies, reps=5, rounds=3),
        "library_ms": time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
            is_causal=True, enable_gqa=True), copies),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops,
                                                   "bfloat16"))),
        "shape": f"{b} x {s}, H{h}/{kh} D{d}, causal"}


def _hold_deepseek_kernels(records: list) -> dict:
    """B1 / B2 / B3 at deepseek-coder-33b's 56 heads over 8 (D 128), bf16,
    element by element; B4 / B5 bit for bit against their plain versions
    on CPU copies and B6 element by element, at its linears; B7 at d 7,168
    within one bf16 ulp; then B1 (8 slots), B3 (8 x 512), B4 (M 4,096) and
    B5 (M 8) timed at these shapes beside their plain versions and library
    calls, with their bounds."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.int8_matmul.ref import (fp8_decode_ref,
                                                     int8_matmul_ref,
                                                     quantize_rowwise,
                                                     w8a8_decode_ref)
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefix_extend_ref)
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 193)
    bf16 = torch.bfloat16
    h, kh, d = 56, 8, 128
    line, times = [], {}
    lengths = [0, 1, 300, 1024, 517, 256, 77, 900]
    for dt in ("bfloat16", "int8"):
        args = _paged_inputs(dt, g, device, lengths, h, kh, d)
        tc0 = pops.tc_launches
        out = pops.paged_attention(*args)
        tag = f"B1 {dt} H{h}/{kh}" + _step_tag(pops.tc_launches - tc0, True)
        if not torch.equal(out, pops.paged_attention(*args)):
            raise AssertionError(f"{tag}: a repeated call differs")
        _, _, vp, _, _, _, vs = args
        v = vp.float() if vs is None else vp.float() * vs[:, None, :, None]
        line.append(check_close(tag, out, paged_attention_ref(*args),
                                v.pow(2).mean().sqrt().item()))
    ext = _extend_inputs("bfloat16", g, device, [0, 256, 300, 1024, 0],
                         [512, 256, 512, 0, 0], 512, h, kh, d)
    tc0 = pops.extend_tc_launches
    out = pops.paged_prefix_extend_attention(*ext)
    line.append(check_close(
        f"B2 bfloat16 W512 H{h}/{kh}"
        + _step_tag(pops.extend_tc_launches - tc0, True), out,
        paged_prefix_extend_ref(*ext), 1.0))
    q, k, v = _flash_inputs(8, 512, bf16, g, device, h, kh, d)
    tc0 = fops.tc_launches
    out = fops.flash_attention(q, k, v, causal=True)
    line.append(check_close(
        f"B3 S512 H{h}/{kh}" + _step_tag(fops.tc_launches - tc0, True),
        out, attention_ref(q, k, v, causal=True), 1.0))
    for kk, n in DEEPSEEK_QMM:
        qw, ws, bias = _qlinear(g, device, kk, n, "int8")
        x = torch.randn((8, kk), generator=g, device=device).to(bf16)
        tc0 = qmm.decode_tc_launches
        out = qmm.w8a8_matmul_decode(x, qw, ws, bias=bias)
        step = "tensor cores" if qmm.decode_tc_launches > tc0 else "ragged"
        if not torch.equal(out.cpu(), w8a8_decode_ref(
                _cpu(x), _cpu(qw), _cpu(ws), _cpu(bias))):
            raise AssertionError(f"B5 K{kk} N{n}: differs from the plain "
                                 "version on the CPU copy")
        xq, xs = quantize_rowwise(torch.randn((256, kk), generator=g,
                                              device=device).to(bf16))
        tc0 = qmm.tc_launches
        out = qmm.int8_matmul(xq, qw, xs, ws, out_dtype=bf16)
        b4_step = "wgmma" if qmm.tc_launches > tc0 else "ragged"
        if not torch.equal(out.cpu(), int8_matmul_ref(
                _cpu(xq), _cpu(qw), _cpu(xs), _cpu(ws), bf16)):
            raise AssertionError(f"B4 M256 K{kk} N{n}: differs from the "
                                 "plain version on the CPU copy")
        fw, fs, _ = _qlinear(g, device, kk, n, "fp8")
        tc0 = qmm.fp8_tc_launches
        out = qmm.fp8_matmul_decode(x, fw, fs, bias=bias).cpu()
        ref = fp8_decode_ref(_cpu(x), _cpu(fw), _cpu(fs), _cpu(bias))
        line.append(f"K{kk} N{n}: B5 M8 [{step}] and B4 M256 [{b4_step}] "
                    "bit-equal to the plain versions; " + check_close(
                        "B6 M8" + _step_tag(qmm.fp8_tc_launches - tc0, True),
                        out, ref, ref.float().pow(2).mean().sqrt().item()))
    for rows in (8, 4096):
        x = torch.randn((rows, 7168), generator=g, device=device).to(bf16)
        w = torch.randn((7168,), generator=g, device=device).to(bf16)
        worst = _within_one_ulp(f"B7 ({rows}, 7168)", rops.rmsnorm(x, w),
                                rmsnorm_ref(x.cpu(), w.cpu()))
        line.append(f"B7 ({rows}, 7168) worst {worst:.2f} ulp")
    del q, k, v, ext, out

    # times at these shapes: B1 and B3 as phases 3 and 4 time them, with
    # SDPA as the library call (B1's over the gathered context)
    def paged_copy():
        return _paged_inputs("bfloat16", g, device, lengths, h, kh, d)
    copies = [paged_copy() for _ in range(4)]
    nbytes, flops = paged_bytes_flops(*[copies[0][i]
                                        for i in (0, 1, 3, 4, 5)])
    lib_in = []
    for q_, kp_, vp_, bt_, ln_, _, _ in copies:
        t = bt_.shape[1] * kp_.shape[1]
        mask = (torch.arange(t, device=device)[None, :]
                < ln_[:, None])[:, None, None, :]
        lib_in.append((q_[:, :, None, :], *(
            p_[bt_.long()].reshape(8, t, kh, d).transpose(1, 2).contiguous()
            for p_ in (kp_, vp_)), mask))
    times["paged_attention"] = {
        "ms": time_ms(pops.paged_attention, copies),
        "plain_ms": time_ms(paged_attention_ref, copies, reps=5, rounds=3),
        "library_ms": time_ms(lambda qq, kk, vv, mm: F.
                              scaled_dot_product_attention(
                                  qq, kk, vv, attn_mask=mm, enable_gqa=True),
                              lib_in),
        **dict(zip(("bound_ms", "bound_by"), bound(nbytes, flops,
                                                   "bfloat16"))),
        "shape": f"8 slots, H{h}/{kh} D{d}, lengths {lengths}"}
    del lib_in
    times["flash_attention"] = _flash_times(8, 512, h, kh, d, g, device)
    for kind, m in (("B5", 8), ("B4", 4096)):
        name = QMM_KERNELS[kind][0]
        per = {f"K{kk}xN{n}": _qmm_times(kind, m, kk, n, g, device)
               for kk, n in DEEPSEEK_QMM}
        times[name] = {"M": m, "per_shape": per}
    for r in records:
        if r["name"] in times:
            r.setdefault("deepseek_shapes", times[r["name"]])
    print("[19 moe] (c) deepseek-coder-33b kernel shapes: " + "; ".join(line))
    return {"held": line, "times": times}


def _moe_deepseek(records: list) -> dict:
    """(c) deepseek-coder-33b at full width and all 62 layers, int8
    weights built one group at a time (its bf16 tree never exists whole),
    bf16 pools, through the PagedEngine: 8 slots, 4 requests of
    512-2,048 tokens, 32 new tokens each."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.layers import (init_embedding, init_linear,
                                           init_norm)
    from repro_torch.models.model import LM
    from repro_torch.models.transformer import init_group
    from repro_torch.obs import Tracer
    from repro_torch.quant import quantize_tree
    from repro_torch.serve.engine import PagedEngine
    kernels = _hold_deepseek_kernels(records)
    cfg = get_config(DEEPSEEK).with_(quant="int8")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    dev, bf16 = lm.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = {"embed": init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                      bf16, dev), "layers": []}
    for _ in range(cfg.num_groups):
        params["layers"].append(quantize_tree(
            init_group(gen, cfg, bf16, dev), quant="int8"))
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, bf16, dev)
    params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_size,
                                    dtype=bf16, device=dev)
    build_s = time.perf_counter() - t0
    weights_gb = _setup_peak_gb()
    rng = np.random.default_rng(SEED + 194)
    tracer = Tracer(enabled=True)
    eng = PagedEngine(lm, params, n_slots=8, max_len=2304, page_size=256,
                      decode_block=8, seed=SEED, tracer=tracer)
    eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new_tokens=4)
    eng.run_to_completion()                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(512, 2049, MOE_Q_REQUESTS)]
    # B7 takes its long-row step past d 2,048, and B5 its ragged step on
    # the down projection (K 19,200 > 16,384)
    r = _moe_paged_drive(eng, tracer, prompts, [32] * MOE_Q_REQUESTS,
                         "deepseek paged int8",
                         exempt=("rmsnorm", "w8a8_decode_matmul"))
    r.update(weights_gb=weights_gb, build_s=build_s, kernels=kernels)
    del eng, params, lm
    return r


def _moe_apply_card_vs_cpu() -> dict:
    """(d) ``moe_apply`` of one granite and one llama4 layer (random
    weights from the seed), 1,024 tokens, bf16, both dispatches: the card
    against the same call on the CPU (relative L2, dropped fraction), and
    two card calls bit-equal."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe, moe_apply

    def cpu(tree):
        return {k: cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}
    out = {}
    device = torch.device("cuda")
    for arch in (GRANITE, SCOUT):
        cfg = get_config(arch)
        gen = torch.Generator(device=device).manual_seed(SEED + 195)
        p = init_moe(gen, cfg.d_model, cfg.moe, torch.bfloat16, device)
        x = torch.randn((1, MOE_APPLY_TOKENS, cfg.d_model), generator=gen,
                        device=device).bfloat16()
        p_cpu, x_cpu = cpu(p), x.cpu()
        for impl in ("einsum", "gather"):
            kw = dict(train=False, group_size=cfg.moe_group_size, impl=impl)
            y, aux = moe_apply(p, x, cfg.moe, **kw)
            again, _ = moe_apply(p, x, cfg.moe, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, raux = moe_apply(p_cpu, x_cpu, cfg.moe, **kw)
            cpu_s = time.perf_counter() - t0
            yf, rf = y.cpu().float(), ref.float()
            rel = ((yf - rf).norm() / rf.norm()).item()
            drop = float(aux["moe_dropped_frac"])
            rdrop = float(raux["moe_dropped_frac"])
            tag = f"{arch} {impl}"
            if not torch.equal(y, again):
                raise AssertionError(f"moe_apply {tag}: two card calls "
                                     "differ")
            if not (torch.isfinite(yf).all() and rel <= MOE_REL_L2
                    and abs(drop - rdrop) <= MOE_DROP_TOL):
                raise AssertionError(
                    f"moe_apply {tag}: relative L2 {rel:.3e} (limit "
                    f"{MOE_REL_L2}), dropped {drop:.5f} vs {rdrop:.5f} on "
                    f"the CPU (limit {MOE_DROP_TOL})")
            out[tag] = {"rel_l2": rel, "dropped": drop, "dropped_cpu": rdrop,
                        "cpu_s": cpu_s}
        del p, x, p_cpu, x_cpu
    return out


def phase_moe(records: list) -> dict:
    """MoE serving and deepseek-coder-33b at full depth (see the module
    docstring, phase 19): (a) granite-moe-3b-a800m, (b)
    llama4-scout-17b-a16e at 8 layers, (c) deepseek-coder-33b, (d)
    moe_apply on the card against the CPU."""
    torch = _torch()
    t_phase = time.perf_counter()
    out = {"granite": _moe_granite()}
    out["scout"] = _moe_scout()
    out["deepseek"] = _moe_deepseek(records)
    gc.collect()
    torch.cuda.empty_cache()
    out["moe_apply"] = _moe_apply_card_vs_cpu()
    out["phase_wall_s"] = time.perf_counter() - t_phase
    drives = {f"moe_{k}": v for k, v in out["granite"].items()}
    drives.update(moe_scout=out["scout"], moe_deepseek=out["deepseek"])
    for r in records:
        for name, drv in drives.items():
            if drv["launches"].get(r["name"]):
                r.setdefault("launches_by_drive", {})[name] = \
                    drv["launches"][r["name"]]
    g = out["granite"]
    print("[19 moe] (a) granite-moe-3b-a800m 32L bf16: "
          + "; ".join(_moe_line(k, v) for k, v in g.items())
          + f" | prefix hits {g['a1_sched']['prefix_hit_tokens']} tokens, "
          f"spec acceptance {g['a3_spec']['acceptance_rate']:.3f}")
    print(f"[19 moe] (b) llama4-scout-17b-a16e {SCOUT_LAYERS}L bf16 eager, "
          f"2 slots, window 8192 ({out['scout']['held']}): "
          + _moe_line("eager", out["scout"]))
    dd = out["deepseek"]
    print(f"[19 moe] (c) deepseek-coder-33b 62L int8 weights (built in "
          f"{dd['build_s']:.1f}s), bf16 pools: "
          + _moe_line("paged", dd) + " | kernel times at its shapes: "
          + json.dumps(dd["kernels"]["times"]))
    print(f"[19 moe] (d) moe_apply card vs CPU, {MOE_APPLY_TOKENS:,} "
          "tokens bf16: "
          + "; ".join(f"{k}: rel L2 {v['rel_l2']:.3e}, dropped "
                      f"{v['dropped']:.5f} / CPU {v['dropped_cpu']:.5f}, "
                      f"two card calls bit-equal (CPU {v['cpu_s']:.1f}s)"
                      for k, v in out["moe_apply"].items())
          + f" | phase {out['phase_wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 20: training

TRAIN_ARCH = "llama3.2-1b"     # the reference's default --arch for training
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 512
TRAIN_CKPT_EVERY = 6           # one checkpoint, the one (d) resumes from
RESUME_STEPS = 2               # (d): steps after the resume
PEFT_STEPS, PEFT_RANK = 3, 16
PEFT_METHODS = ("lora", "qlora", "dora")
TRAIN_GRAD_REL_L2 = 1e-4       # (b): smoke configs, card vs CPU, float32
TRAIN_GRAD_B, TRAIN_GRAD_S = 2, 128
MOE_RWKV_LAYERS, MOE_RWKV_STEPS = 4, 3
PROXY_METHODS = ("full", "lora", "qlora")
TRAIN_SERVE_REQUESTS = 4


def _train_quiet(_msg) -> None:
    pass


def _no_launches(tag: str) -> dict:
    """The eight kernels' counters must still read 0: the training path
    launches none of them (the reference's launches none of its Pallas
    kernels)."""
    got = _read_launches()
    if any(got.values()):
        raise AssertionError(f"{tag}: kernel launches in a training run: "
                             f"{got}")
    return got


def _train_cli(tmp: Path) -> dict:
    """(a) ``repro_torch.launch.train.main`` for llama3.2-1b at full width
    and depth, bf16, TRAIN_STEPS steps of 8 x 512 tokens, a checkpoint
    every TRAIN_CKPT_EVERY."""
    torch = _torch()
    from repro_torch.launch import train as train_cli
    hist = tmp / "a_history.json"
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
            "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
            "--ckpt-dir", str(tmp / "ckpt"),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1",
            "--seed", str(SEED), "--history-out", str(hist)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    rc = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _no_launches("(a) launch.train")
    h = json.loads(hist.read_text())
    losses = [r["loss"] for r in h]
    dts = [r["dt"] for r in h]
    if rc != 0 or len(h) != TRAIN_STEPS:
        raise AssertionError(f"(a) rc {rc}, {len(h)} history rows")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"(a) non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a) loss did not fall: {losses}")
    p50 = statistics.median(dts)
    return {"losses": losses, "dt_s": dts, "step_p50_s": p50,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / p50,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "wall_s": wall, "grad_norm_last": h[-1]["grad_norm"],
            "launches": launches, "ckpt_dir": str(tmp / "ckpt")}


def _smoke_grads_card_vs_cpu(arch: str, rng, tag: str,
                             nonzero: bool = False) -> dict:
    """One loss + backward of ``arch``'s float32 smoke config on the card
    against the same parameters and batch on the CPU: the losses, and
    every float leaf's gradient present on both and within
    TRAIN_GRAD_REL_L2 relative L2 (and, with ``nonzero``, not all zero:
    ``loss_and_grads`` gives zeros where the loss reads no leaf)."""
    torch = _torch()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import LM
    from repro_torch.train.loop import loss_and_grads
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = get_smoke_config(arch).with_(dtype="float32")
    cpu = LM(cfg, device="cpu")
    card = LM(cfg, device="cuda")
    p_cpu = cpu.init(SEED)
    p_card = tree_map(lambda t: t.cuda(), p_cpu)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_GRAD_B, TRAIN_GRAD_S + 1))
    b = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
         "labels": torch.from_numpy(toks[:, 1:]).long()}
    l_cpu, _, g_cpu = loss_and_grads(cpu, p_cpu, b)
    l_card, _, g_card = loss_and_grads(
        card, p_card, {k: v.cuda() for k, v in b.items()})
    worst, n = 0.0, 0
    for (path, p), (_, gh), (_, gd) in zip(leaves_with_path(p_cpu),
                                           leaves_with_path(g_cpu),
                                           leaves_with_path(g_card)):
        if not p.is_floating_point():
            continue
        if gh is None or gd is None or (nonzero and not bool(
                (gd != 0).any())):
            raise AssertionError(f"{tag} {arch} {path}: no gradient")
        rel = ((gd.cpu() - gh).norm() / gh.norm().clamp(min=1e-30)).item()
        if not rel <= TRAIN_GRAD_REL_L2:
            raise AssertionError(f"{tag} {arch} {path}: relative L2 "
                                 f"{rel:.3e} card vs CPU")
        worst, n = max(worst, rel), n + 1
    return {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
            "worst_rel_l2": worst, "leaves": n}


def _grads_card_vs_cpu() -> dict:
    """(b) One loss + backward of the float32 smoke configs of
    llama3.2-1b and granite-moe on the card against the same parameters
    and batch on the CPU (every leaf within TRAIN_GRAD_REL_L2 relative
    L2); then one backward of llama3.2-1b at full width, bf16: every float
    leaf's gradient exists (a kernel on the path would cut the graph:
    its output carries no grad_fn) and is finite."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.tree import tree_map
    out = {}
    rng = np.random.default_rng(SEED)
    _reset_launches()
    for arch in (TRAIN_ARCH, GRANITE):
        out[arch] = _smoke_grads_card_vs_cpu(arch, rng, "(b)")
    # full width: the raw autograd result, None kept
    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    leaves = []

    def track(t):
        if not t.is_floating_point():
            return t
        t = t.detach().requires_grad_()
        leaves.append(t)
        return t
    live = tree_map(track, params)
    toks = rng.integers(0, cfg.vocab_size, (TRAIN_GRAD_B, TRAIN_SEQ + 1))
    b = {"tokens": torch.from_numpy(toks[:, :-1]).long().cuda(),
         "labels": torch.from_numpy(toks[:, 1:]).long().cuda()}
    loss, _ = lm.loss(live, b)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    missing = sum(g is None for g in grads)
    finite = all(bool(torch.isfinite(g).all()) for g in grads
                 if g is not None)
    if missing or not finite:
        raise AssertionError(f"(b) full width: {missing} leaves without a "
                             f"gradient, all finite: {finite}")
    out["full_width"] = {"leaves": len(leaves), "loss": loss.item()}
    out["launches"] = _no_launches("(b)")
    del params, live, leaves, grads, loss
    return out


def _peft_full_width(method: str, peak_a: float) -> tuple:
    """(c) One PEFT arm at full width: llama3.2-1b bf16 with rank-16
    adapters (qlora: on the int4 base), PEFT_STEPS steps of 8 x 512.
    Frozen leaves bit-equal before and after, the trainable elements =
    ``count_trainable``, every trainable leaf moved, the loss falls."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.core.apply import apply_to_params
    from repro_torch.core.space import (ArchChoice, EfficiencyConfig,
                                        FtChoice, InfChoice)
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.peft.lora import count_trainable, trainable_mask
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import leaves_with_path
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg, device="cuda")
    eff = EfficiencyConfig(ArchChoice(), FtChoice(method, PEFT_RANK, 2),
                           InfChoice())
    params = apply_to_params(lm.init(SEED), eff, SEED + 1)
    mask = trainable_mask(params, method)
    mflat = dict(leaves_with_path(mask))
    frozen = {p: t.clone() for p, t in leaves_with_path(params)
              if not mflat[p]}
    start = {p: t.clone() for p, t in leaves_with_path(params) if mflat[p]}
    n_train, n_all = count_trainable(params, mask)
    _reset_launches()
    tr = Trainer(lm, SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                     seed=SEED),
                 lr=cosine_schedule(1e-3, 2, PEFT_STEPS), log_every=1,
                 log_fn=_train_quiet)
    tr.set_params(params, mask=mask)
    t0 = time.perf_counter()
    hist = tr.run(PEFT_STEPS)
    wall = time.perf_counter() - t0
    launches = _no_launches(f"(c) {method}")
    after = dict(leaves_with_path(tr.params))
    for p, t in frozen.items():
        a, b = after[p], t
        if a.element_size() == 1:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        if not torch.equal(a, b):
            raise AssertionError(f"(c) {method}: frozen leaf {p} moved")
    moved = sum(after[p].numel() for p, t in start.items()
                if not torch.equal(after[p], t))
    with_state = sum(m.numel() for _, m in leaves_with_path(tr.opt_state.mu))
    if not (with_state == n_train == moved):
        raise AssertionError(f"(c) {method}: trainable {n_train} "
                             f"(count_trainable), AdamW state {with_state},"
                             f" moved {moved}")
    losses = [r["loss"] for r in hist]
    if not all(v == v for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"(c) {method}: losses {losses}")
    res = {"losses": losses, "trainable": n_train, "total": n_all,
           "step_p50_s": statistics.median(r["dt"] for r in hist),
           "wall_s": wall,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "peak_vs_full": torch.cuda.max_memory_allocated() / 1e9 / peak_a,
           "launches": launches}
    return res, (lm, tr.params if method == "lora" else None)


def _resume(ckpt_dir: str) -> dict:
    """(d) A fresh Trainer on (a)'s directory resumes at step 20 with the
    parameters, AdamW state and DataState saved there, bit for bit
    (against the checkpoint's arrays read independently), then runs
    RESUME_STEPS steps."""
    torch = _torch()
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import leaves_with_path
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg, device="cuda")
    t0 = time.perf_counter()
    saved = CheckpointManager(ckpt_dir).restore()
    read_s = time.perf_counter() - t0
    total = TRAIN_STEPS + RESUME_STEPS
    tr = Trainer(lm, SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                     seed=SEED),
                 lr=cosine_schedule(3e-4, 20, total), ckpt_dir=ckpt_dir,
                 log_every=1, log_fn=_train_quiet)
    t0 = time.perf_counter()
    tr.init_or_resume(SEED + 7)        # another seed: it must restore
    resume_s = time.perf_counter() - t0
    if tr.step != TRAIN_STEPS or tr.opt_state.step != TRAIN_STEPS:
        raise AssertionError(f"(d) resumed at step {tr.step} / optimizer "
                             f"{tr.opt_state.step}")
    arrays = saved["arrays"]
    n = 0
    for prefix, tree in (("params/", tr.params), ("opt/mu/", tr.opt_state.mu),
                         ("opt/nu/", tr.opt_state.nu)):
        for path, t in leaves_with_path(tree):
            if not torch.equal(t.cpu(), arrays[prefix + path]):
                raise AssertionError(f"(d) {prefix}{path} differs from the "
                                     "checkpoint")
            n += 1
    want_ds = {"seed": SEED, "step": TRAIN_STEPS}
    if saved["data_state"] != want_ds or \
            tr.pipe.state.to_dict() != want_ds:
        raise AssertionError(f"(d) data state {tr.pipe.state} / saved "
                             f"{saved['data_state']}")
    tr.mgr = None      # (d) checks the restore; its steps save nothing
    _reset_launches()
    hist = tr.run(total)
    launches = _no_launches("(d)")
    losses = [r["loss"] for r in hist]
    if len(losses) != RESUME_STEPS or not all(v == v for v in losses):
        raise AssertionError(f"(d) losses after the resume: {losses}")
    return {"tensors_checked": n, "read_s": read_s, "resume_s": resume_s,
            "losses": losses, "launches": launches}


def _serve_trained(lm, params) -> dict:
    """(e) (c)'s LoRA parameters served through PagedEngine, 4 requests,
    merged (``merge_lora``) and with the adapters unmerged: full streams,
    B1 / B3 / B7 launched; the first prompt's prefill logits, merged vs
    unmerged, within LOGIT_REL_L2."""
    torch = _torch()
    import numpy as np
    from repro_torch.peft.lora import merge_lora
    from repro_torch.serve.engine import PagedEngine
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(0, lm.cfg.vocab_size, (int(n),))
               for n in rng.integers(128, 513, TRAIN_SERVE_REQUESTS)]
    out = {}
    logits = {}
    for arm, p in (("unmerged", params), ("merged", merge_lora(params))):
        cache = lm.init_cache(1, 512)
        first = torch.from_numpy(prompts[0][None]).cuda()
        lg, _ = lm.prefill(p, first, cache)
        logits[arm] = lg.float()
        eng = PagedEngine(lm, p, n_slots=8, max_len=1024, page_size=256,
                          decode_block=8, seed=SEED)
        _reset_launches()
        t0 = time.perf_counter()
        ids = [eng.submit(q, max_new_tokens=32) for q in prompts]
        done = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _read_launches().items() if v}
        short = [i for i in ids if len(done[i].out_tokens) != 32]
        if short or not all(launches.get(k) for k in
                            ("paged_attention", "flash_attention",
                             "rmsnorm")):
            raise AssertionError(f"(e) {arm}: short streams {short}, "
                                 f"launches {launches}")
        out[arm] = {"launches": launches, "wall_s": wall,
                    "tokens_per_s": 32 * len(ids) / wall}
        del eng
    a, b = logits["unmerged"], logits["merged"]
    rel = ((a - b).norm() / b.norm()).item()
    if not (torch.isfinite(a).all() and rel <= LOGIT_REL_L2):
        raise AssertionError(f"(e) merged vs unmerged logits: relative L2 "
                             f"{rel:.3e} (limit {LOGIT_REL_L2})")
    out["logit_rel_l2"] = rel
    return out


def _moe_rwkv_train() -> dict:
    """(f) granite-moe-3b-a800m and rwkv6-1.6b at full width and
    MOE_RWKV_LAYERS layers, bf16, MOE_RWKV_STEPS steps of 8 x 512: finite
    losses, the MoE aux losses in granite's metrics, no kernel launch."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train.loop import Trainer
    out = {}
    for arch in (GRANITE, "rwkv6-1.6b"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch).with_(num_layers=MOE_RWKV_LAYERS)
        lm = LM(cfg, device="cuda")
        tr = Trainer(lm, SyntheticLMData(cfg.vocab_size, TRAIN_SEQ,
                                         TRAIN_BATCH, seed=SEED),
                     lr=cosine_schedule(3e-4, 1, MOE_RWKV_STEPS),
                     log_every=1, log_fn=_train_quiet)
        tr.init_or_resume(SEED)
        _reset_launches()
        hist = tr.run(MOE_RWKV_STEPS)
        launches = _no_launches(f"(f) {arch}")
        losses = [r["loss"] for r in hist]
        if not all(v == v and abs(v) < float("inf") for v in losses):
            raise AssertionError(f"(f) {arch}: losses {losses}")
        if cfg.moe is not None and not {"moe_lb_loss", "moe_z_loss"} <= \
                hist[-1].keys():
            raise AssertionError(f"(f) {arch}: metrics {sorted(hist[-1])}")
        out[arch] = {"losses": losses,
                     "step_p50_s": statistics.median(r["dt"] for r in hist),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "aux": {k: hist[-1][k] for k in hist[-1]
                             if k.startswith("moe_")},
                     "launches": launches}
        del tr, lm
    return out


def _proxy_evaluator() -> dict:
    """(g) The search's proxy evaluator at h100-1 for qwen2-1.5b: the
    reduced model trained on the card for the default 60 steps under
    full, lora and qlora; its accuracy objective and seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import TIERS
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.features import TASKS
    from repro_torch.core.space import (ArchChoice, EfficiencyConfig,
                                        FtChoice, InfChoice)
    ev = Evaluator(get_config("qwen2-1.5b"), TASKS["mmlu"], TIERS["h100-1"],
                   mode="proxy", device="cuda")
    out = {}
    _reset_launches()
    for method in PROXY_METHODS:
        eff = EfficiencyConfig(ArchChoice(), FtChoice(
            method, 0 if method == "full" else PEFT_RANK,
            1 if method == "full" else 2), InfChoice())
        t0 = time.perf_counter()
        obj = ev.evaluate(eff)
        out[method] = {"accuracy": float(obj[0]),
                       "seconds": time.perf_counter() - t0}
        if not 0.0 < obj[0] <= 100.0:
            raise AssertionError(f"(g) {method}: accuracy {obj[0]}")
    out["launches"] = _no_launches("(g)")
    return out


def phase_train(records: list, smi: str) -> dict:
    """Training (see the module docstring, phase 20): (a) the CLI at full
    width, (b) gradients card vs CPU, (c) PEFT at full width, (d) resume
    from (a), (e) serving (c)'s LoRA model, (f) MoE and RWKV-6, (g) the
    proxy evaluator."""
    import shutil
    import tempfile
    torch = _torch()
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    out = {}
    try:
        out["a_cli"] = a = _train_cli(tmp)
        print(f"[20 train] (a) {TRAIN_ARCH} {smi}: launch.train 16L bf16, "
              f"{TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ}: step wall "
              f"p50 {a['step_p50_s'] * 1e3:.1f} ms, "
              f"{a['tokens_per_s']:.0f} tokens/s, peak "
              f"{a['peak_gb']:.2f} GB, loss {a['losses'][0]:.4f} -> "
              f"{a['losses'][-1]:.4f}, wall {a['wall_s']:.1f}s "
              f"({TRAIN_STEPS // TRAIN_CKPT_EVERY} checkpoint(s)), kernel "
              f"launches 0")
        out["b_grads"] = g = _grads_card_vs_cpu()
        print(f"[20 train] (b) {smi}: gradients card vs CPU (float32 smoke"
              f", limit {TRAIN_GRAD_REL_L2}): " + "; ".join(
                  f"{k} worst leaf {v['worst_rel_l2']:.3e}"
                  for k, v in g.items() if "worst_rel_l2" in v)
              + f" | full width: all {g['full_width']['leaves']} float "
              "leaves have a finite gradient")
        gc.collect()
        torch.cuda.empty_cache()
        out["c_peft"] = {}
        lora = None
        for method in PEFT_METHODS:
            res, (lm, p) = _peft_full_width(method, a["peak_gb"])
            out["c_peft"][method] = res
            if p is not None:
                lora = (lm, p)
            print(f"[20 train] (c) {method} r{PEFT_RANK} {smi}: "
                  f"{res['trainable']:,} of {res['total']:,} trainable, "
                  f"step p50 {res['step_p50_s'] * 1e3:.1f} ms, loss "
                  f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, "
                  f"peak {res['peak_gb']:.2f} GB ({res['peak_vs_full']:.2f}"
                  f" x (a)), frozen leaves bit-equal")
        out["d_resume"] = d = _resume(a["ckpt_dir"])
        print(f"[20 train] (d) {smi}: resumed at step {TRAIN_STEPS}, "
              f"{d['tensors_checked']} tensors bit-equal to the checkpoint "
              f"(read {d['read_s']:.1f}s, resume {d['resume_s']:.1f}s), "
              f"{RESUME_STEPS} more steps, loss {d['losses'][0]:.4f} -> "
              f"{d['losses'][-1]:.4f}")
        out["e_serve"] = e = _serve_trained(*lora)
        del lora
        print(f"[20 train] (e) {smi}: the LoRA model served by PagedEngine, "
              f"{TRAIN_SERVE_REQUESTS} requests: " + "; ".join(
                  f"{k} {v['tokens_per_s']:.1f} tokens/s launches "
                  f"{v['launches']}" for k, v in e.items()
                  if isinstance(v, dict))
              + f" | first prefill logits merged vs unmerged relative L2 "
              f"{e['logit_rel_l2']:.3e} (limit {LOGIT_REL_L2})")
        out["f_moe_rwkv"] = f = _moe_rwkv_train()
        print(f"[20 train] (f) {smi}: {MOE_RWKV_LAYERS} layers, "
              f"{MOE_RWKV_STEPS} steps: " + "; ".join(
                  f"{k} loss {v['losses'][0]:.4f} -> {v['losses'][-1]:.4f},"
                  f" step p50 {v['step_p50_s'] * 1e3:.1f} ms, peak "
                  f"{v['peak_gb']:.2f} GB {v['aux']}" for k, v in f.items()))
        out["g_proxy"] = pr = _proxy_evaluator()
        print(f"[20 train] (g) {smi}: proxy evaluator qwen2-1.5b at h100-1: "
              + "; ".join(f"{k} accuracy {v['accuracy']:.3f} in "
                          f"{v['seconds']:.1f}s" for k, v in pr.items()
                          if k != "launches"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for r in records:
        for arm in ("unmerged", "merged"):
            n = out.get("e_serve", {}).get(arm, {}).get("launches", {}).get(
                r["name"])
            if n:
                r.setdefault("launches_by_drive", {})[f"train_serve_{arm}"] \
                    = n
    out["phase_wall_s"] = time.perf_counter() - t_phase
    print(f"[20 train] phase {out['phase_wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 21: the encoder / cross-attention models, MLA, calibration

WHISPER = "whisper-base"
VISION = "llama-3.2-vision-11b"
ENCDEC_DECODE_STEPS = 32
#: (arch, rows, prompt tokens) of phase 21 (b) and (c)
ENCDEC_DRIVES = ((WHISPER, 8, 64), (VISION, 4, 512))
MLA_REQUESTS = 8            # phase 21 (d), each arm
CALIB_REQUESTS = 4          # phase 21 (e)
#: (tag, B, S, T, H, KH, D) of phase 21 (a): B3 without a causal mask at
#: the encoder's and the cross-attention's shapes of (b) and (c)
NONCAUSAL_SHAPES = (("whisper encoder", 8, 1500, 1500, 8, 8, 64),
                    ("whisper xattn prefill", 8, 64, 1500, 8, 8, 64),
                    ("whisper xattn decode", 8, 1, 1500, 8, 8, 64),
                    ("vision xattn prefill", 4, 512, 1600, 32, 8, 128),
                    ("vision xattn decode", 4, 1, 1600, 32, 8, 128))


def _wall_busy(run) -> dict:
    """Host wall of one ``run()`` (synchronized) and the device busy time
    (the sum of its kernels' times, from torch.profiler) of one more."""
    torch = _torch()
    from repro_torch.launch.profile_serve import _device_kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels, runs = _device_kernels(prof)
    busy = sum(kernels.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"wall_ms": wall, "busy_ms": busy, "kernel_runs": runs}


def _noncausal_flash(records: list) -> list:
    """(a) B3 without a causal mask, S != T and S = T = 1,500 (not a
    multiple of 64), against its plain version element by element with
    phase 4's bar, then timed beside the plain version and SDPA."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 21)
    rows = []
    for tag, b, s, t, h, kh, d in NONCAUSAL_SHAPES:
        def inputs():
            return (torch.randn((b, s, h, d), generator=g,
                                device=device).bfloat16(),
                    torch.randn((b, t, kh, d), generator=g,
                                device=device).bfloat16(),
                    torch.randn((b, t, kh, d), generator=g,
                                device=device).bfloat16())
        q, k, v = inputs()
        tc0 = ops.tc_launches
        out = ops.flash_attention(q, k, v, causal=False)
        ref = attention_ref(q, k, v, causal=False)
        torch.cuda.synchronize()
        check = check_close(f"{tag} S{s} T{t} H{h}/{kh} D{d}"
                            + _step_tag(ops.tc_launches - tc0, True),
                            out, ref, 1.0)
        err = (out.float() - ref.float()).abs().max().item()
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        copies = [inputs() for _ in range(n_copies(nbytes))]
        ms = time_ms(lambda a, b_, c: ops.flash_attention(a, b_, c,
                                                          causal=False),
                     copies)
        plain_ms = time_ms(lambda a, b_, c: attention_ref(a, b_, c,
                                                          causal=False),
                           copies, reps=5, rounds=3)
        lib_ms = time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
            enable_gqa=True), copies)
        b_ms, b_by = bound(nbytes, 4.0 * b * h * d * s * t, "bfloat16")
        rows.append({"shape": tag, "B": b, "S": s, "T": t, "H": h, "KH": kh,
                     "D": d, "check": check, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
        del copies
    for r in records:
        if r["name"] == "flash_attention":
            r["noncausal"] = rows
    return rows


def _source_lm(arch: str):
    """``arch`` at full width and depth, bf16, random weights from the
    seed, with the fp32 head made once."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    lm = LM(cfg, device="cuda")
    params = lm.prepare(lm.init(SEED))
    return cfg, lm, params, _setup_peak_gb()


def _encdec_drive(arch: str, rows: int, plen: int) -> dict:
    """(b) / (c): ``rows`` prompts of ``plen`` tokens over stub source
    embeddings (``modality_spec``, N(0, 0.02) as the reference's test
    batches), one ``LM.prefill(modality_input=)`` and
    ``ENCDEC_DECODE_STEPS`` greedy ``LM.decode_step``s, the launch counts
    zeroed just before and read just after.  B3 launches once a
    self-attention block, cross-attention block and encoder layer in the
    prefill and once a cross-attention block a decode step (self-attention
    decode is plain torch over the contiguous cache), every launch on the
    tensor cores; B7 2L + 1 + (cross-attention blocks) a forward for an
    RMSNorm model (llama-3.2-vision; d 4,096 takes its long-row step),
    none for a LayerNorm one (whisper).  Then the prefill's and the first
    decode step's logits against the plain versions, and the wall and
    busy time of a prefill and a decode step."""
    torch = _torch()
    from repro_torch.configs.specs import modality_spec
    from repro_torch.models.transformer import block_kinds
    cfg, lm, params, setup_gb = _source_lm(arch)
    g = torch.Generator(device="cuda").manual_seed(SEED + 211)
    spec = modality_spec(cfg, rows)
    src = (torch.randn(spec.shape, generator=g, device="cuda")
           * 0.02).to(spec.dtype)
    toks = torch.randint(0, cfg.vocab_size, (rows, plen), generator=g,
                         device="cuda")
    max_len = plen + ENCDEC_DECODE_STEPS
    cache = lm.init_cache(rows, max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    logits0, cache = lm.prefill(params, toks, cache, modality_input=src)
    tok = logits0.argmax(-1)
    out, finite = [tok], torch.isfinite(logits0).all()
    step_logits0 = None
    for i in range(ENCDEC_DECODE_STEPS):
        logits, cache = lm.decode_step(
            params, tok, cache, torch.full((rows,), plen + i,
                                           device="cuda"))
        if step_logits0 is None:
            step_logits0 = logits
        finite &= torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        out.append(tok)
    streams = torch.stack(out, 1).tolist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    tc = _tc_launches(arch, exempt=("rmsnorm",))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not bool(finite) or any(len(s) != ENCDEC_DECODE_STEPS + 1 or not all(
            0 <= t < cfg.vocab_size for t in s) for s in streams):
        raise AssertionError(f"{arch}: a short stream, a token out of vocab "
                             "or a non-finite logit")
    xattn = sum(k["xattn"] for k in block_kinds(cfg)) * cfg.num_groups
    enc = cfg.encoder.num_layers if cfg.encoder is not None else 0
    norms = (2 * cfg.num_layers + 1 + xattn) if cfg.norm == "rmsnorm" \
        else 0
    want = {k: 0 for k in launches}
    want["flash_attention"] = enc + cfg.num_layers + xattn \
        + xattn * ENCDEC_DECODE_STEPS
    want["rmsnorm"] = norms * (1 + ENCDEC_DECODE_STEPS)
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches} != {want}")
    # the plain versions: the same prefill and first decode step
    def plain():
        c = lm.init_cache(rows, max_len)
        lp, c = lm.prefill(params, toks, c, modality_input=src)
        sp, _ = lm.decode_step(params, streams_t[:, 0], c,
                               torch.full((rows,), plen, device="cuda"))
        return lp, sp
    streams_t = torch.tensor(streams, device="cuda")
    lp, sp = _swap_plain(plain, ("attention", "norm"))
    v = cfg.vocab_size                 # the padded columns are -1e30
    rel_p, err_p = _worst_slot_rel_l2(f"{arch} prefill", logits0[:, :v],
                                      lp[:, :v], (rows, v))
    rel_d, err_d = _worst_slot_rel_l2(f"{arch} decode step",
                                      step_logits0[:, :v], sp[:, :v],
                                      (rows, v))
    fresh = lm.init_cache(rows, max_len)
    pre = _wall_busy(lambda: lm.prefill(params, toks, fresh,
                                        modality_input=src))
    _, fresh = lm.prefill(params, toks, fresh, modality_input=src)
    step = _wall_busy(lambda: lm.decode_step(
        params, streams_t[:, 0], fresh,
        torch.full((rows,), plen, device="cuda")))
    res = {"params_b": cfg.param_count() / 1e9, "layers": cfg.num_layers,
           "encoder_layers": enc, "xattn_blocks": xattn, "rows": rows,
           "prompt": plen, "source_len": spec.shape[1],
           "decode_steps": ENCDEC_DECODE_STEPS, "wall_s": wall,
           "tokens_per_s": rows * (ENCDEC_DECODE_STEPS + 1) / wall,
           "launches": {k: v for k, v in launches.items() if v},
           "tc_launches": {k: v for k, v in tc.items() if v},
           "prefill_rel_l2": rel_p, "prefill_max_abs": err_p,
           "decode_rel_l2": rel_d, "decode_max_abs": err_d,
           "prefill": pre, "decode_step": step, "setup_peak_gb": setup_gb,
           "peak_gb": peak}
    del lm, params, cache, fresh
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _mla_arm(quant: str) -> dict:
    """(d) qwen2-1.5b under the search's mla arm (kv_lora_rank 384,
    rope_head_dim 64) at full width and depth through the eager Engine,
    bf16 or int8 weights (``apply_to_params``; the absorbed decode reads
    the dequantized up-projections): 8 requests of 200-1,500 tokens, 32-64
    new tokens each.  MLA launches no attention kernel (plain torch, as the
    reference computes it in jnp); B7 at 57 a forward; int8 B4 / B5 at the
    MLA layer's quantized linears (8 a layer in a forward, 6 in a decode
    step: the up-projections are absorbed).  The latent cache's bytes a
    token, and one admission's logits against the plain versions (B7's
    for bf16; B4 / B5's for int8, bit-equal)."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.apply import apply_efficiency_config, \
        apply_to_params
    from repro_torch.core.space import (ArchChoice, EfficiencyConfig,
                                        FtChoice, InfChoice)
    from repro_torch.kvcache import kv_bytes_per_token
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.serve.engine import Engine
    base = get_config("qwen2-1.5b")
    eff = EfficiencyConfig(ArchChoice("mla", 0, 1), FtChoice("full", 0, 1),
                           InfChoice(quant, "none", "full"))
    cfg = apply_efficiency_config(base, eff)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    params = apply_to_params(lm.init(SEED), eff, None)
    setup_gb = _setup_peak_gb()
    tracer = Tracer(enabled=True)
    eng = Engine(lm, params, n_slots=8, max_len=2048, seed=SEED,
                 tracer=tracer)
    rng = np.random.default_rng(SEED + 214)
    eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new_tokens=8)
    eng.run_to_completion()                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),))
               for n in rng.integers(200, 1501, MLA_REQUESTS)]
    res = _eager_drive(eng, tracer, prompts,
                       rng.integers(32, 65, MLA_REQUESTS), f"mla {quant}",
                       qlinears=_qlinears(cfg),
                       decode_qlinears=_qlinears(cfg, decode=True))
    res.pop("streams")
    node = eng.cache[0]["blk0"]["kv"]
    res["cache_bytes_per_token"] = len(eng.cache) * sum(
        t[0, 0].numel() * t.element_size() for t in node.values())
    res["kv_bytes_per_token"] = kv_bytes_per_token(cfg)
    res["gqa_kv_bytes_per_token"] = kv_bytes_per_token(base)
    res["params_b"] = cfg.param_count() / 1e9
    res["setup_peak_gb"] = setup_gb
    # int8: the matmuls alone (B4 / B5 are bit-equal to their plain
    # versions; a B7 ulp would move a whole int8 step, ROADMAP C trap 5)
    lk = eng._prefill_slot(prompts[0], 0)
    lp = _swap_plain(lambda: eng._prefill_slot(prompts[0], 0),
                     ("matmul",) if quant == "int8" else ("norm",))
    res["logit_rel_l2"], res["logit_max_abs"] = _worst_slot_rel_l2(
        f"mla {quant} admission", lk[None], lp[None], (1, cfg.vocab_size))
    del eng, lm, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _linear_at(params: dict, path: str) -> dict:
    """The linear at a calibration path (``/layers/g{i}/blk0/mlp/gate``)."""
    parts = path.strip("/").split("/")
    node = params["layers"][int(parts[1][1:])]
    for key in parts[2:]:
        node = node[key]
    return node


def _calibration() -> dict:
    """(e) calibration at qwen2-1.5b's full width: ``collect_linear_inputs``
    on the card (2 x 256 tokens: ``wq`` and ``gate`` of the 28 layers),
    SmoothQuant and AWQ (8 bits) scales over every capture, the
    SmoothQuant-calibrated int8 tree (``apply_to_params(calib=)``) served
    through the eager Engine with its launches checked, and
    ``gptq_quantize_matrix`` on layer 0's 1,536 x 8,960 ``gate`` on the
    host (4 bits), timed, its output error on the captured activations
    beside round-to-nearest's."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.apply import apply_to_params
    from repro_torch.core.space import (ArchChoice, EfficiencyConfig,
                                        FtChoice, InfChoice)
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.quant import calibrate as cal
    from repro_torch.serve.engine import Engine
    cfg = get_config("qwen2-1.5b")
    gc.collect()
    torch.cuda.empty_cache()
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 215)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                         device="cuda")
    _reset_launches()
    t0 = time.perf_counter()
    caps = cal.collect_linear_inputs(lm, params, toks)
    torch.cuda.synchronize()
    t_collect = time.perf_counter() - t0
    want = {f"/layers/g{i}/blk0/{n}" for i in range(cfg.num_layers)
            for n in ("attn/wq", "mlp/gate")}
    if set(caps) != want or any(c.shape != (256, cfg.d_model)
                                or not torch.isfinite(c).all()
                                for c in caps.values()):
        raise AssertionError(f"calibration: captured {sorted(caps)[:4]}... "
                             f"({len(caps)} linears), want {len(want)}")
    t0 = time.perf_counter()
    sq = {p: cal.smoothquant_scales(x.abs().amax(dim=0),
                                    _linear_at(params, p)["w"])
          for p, x in caps.items()}
    torch.cuda.synchronize()
    t_sq = time.perf_counter() - t0
    t0 = time.perf_counter()
    awq = {p: cal.awq_search_scales(_linear_at(params, p)["w"], x, bits=8)
           for p, x in caps.items()}
    torch.cuda.synchronize()
    t_awq = time.perf_counter() - t0
    for name, sc in (("smoothquant", sq), ("awq", awq)):
        if not all(torch.isfinite(s).all() and (s > 0).all()
                   for s in sc.values()):
            raise AssertionError(f"calibration: {name} scales not finite")
    # GPTQ on the host
    gate = "/layers/g0/blk0/mlp/gate"
    x = caps[gate].double().cpu().numpy()
    w = _linear_at(params, gate)["w"].double().cpu().numpy()
    t0 = time.perf_counter()
    h = cal.hessian_from_inputs(x)
    wq, _ = cal.gptq_quantize_matrix(w, h, bits=4)
    t_gptq = time.perf_counter() - t0
    q, s = cal._rtn(torch.from_numpy(w), 4)
    w_rtn = (q * s[None, :]).numpy()
    y = x @ w
    gptq_err = float(np.linalg.norm(x @ wq - y) / np.linalg.norm(y))
    rtn_err = float(np.linalg.norm(x @ w_rtn - y) / np.linalg.norm(y))
    # the SmoothQuant-calibrated int8 model served
    eff = EfficiencyConfig(ArchChoice("gqa", 0, 1), FtChoice("full", 0, 1),
                           InfChoice("int8", "smoothquant", "full"))
    qparams = apply_to_params(params, eff, None, calib=sq)
    del params, caps
    qlm = LM(cfg.with_(quant="int8"), device="cuda")
    setup_gb = _setup_peak_gb()
    tracer = Tracer(enabled=True)
    eng = Engine(qlm, qparams, n_slots=4, max_len=1024, seed=SEED,
                 tracer=tracer)
    rng = np.random.default_rng(SEED + 216)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),))
               for n in rng.integers(200, 801, CALIB_REQUESTS)]
    served = _eager_drive(eng, tracer, prompts,
                          np.full(CALIB_REQUESTS, 32), "calibrated int8",
                          qlinears=_qlinears(qlm.cfg))
    served.pop("streams")
    served["setup_peak_gb"] = setup_gb
    del eng, qlm, qparams
    gc.collect()
    torch.cuda.empty_cache()
    return {"captured": len(want), "collect_s": t_collect,
            "smoothquant_s": t_sq, "awq_s": t_awq, "gptq_s": t_gptq,
            "gptq_out_rel_err": gptq_err, "rtn_out_rel_err": rtn_err,
            "awq_scale_range": [min(float(s.min()) for s in awq.values()),
                                max(float(s.max()) for s in awq.values())],
            "served": served}


def phase_encdec(records: list, smi: str) -> dict:
    """Phase 21: (a) B3 non-causal at whisper's and the vision model's
    shapes; (b) whisper-base and (c) llama-3.2-vision-11b at full width
    and depth through ``LM.prefill(modality_input=)`` + ``decode_step``;
    (d) qwen2-1.5b's MLA arm through the eager Engine, bf16 and int8;
    (e) calibration at qwen2-1.5b's full width."""
    torch = _torch()
    t_phase = time.perf_counter()
    out = {"a_noncausal": _noncausal_flash(records)}
    print(f"[21 encdec] (a) {smi}: B3 non-causal vs plain (bar of phase 4) "
          + "; ".join(f"{r['check']}: {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f}, "
                      f"bound {r['bound_ms']:.4f} ({r['bound_by']})"
                      for r in out["a_noncausal"]))
    for (arch, rows, plen), key in zip(ENCDEC_DRIVES, ("b_whisper",
                                                       "c_vision")):
        out[key] = d = _encdec_drive(arch, rows, plen)
        for r in records:
            if r["name"] in d["launches"]:
                r.setdefault("launches_by_drive", {})[f"encdec_{arch}"] = \
                    d["launches"][r["name"]]
        print(f"[21 encdec] ({key[0]}) {arch} {smi}: "
              f"{d['params_b']:.2f} B params, {d['layers']}L"
              + (f" + {d['encoder_layers']}L encoder" if d["encoder_layers"]
                 else "")
              + f", {d['xattn_blocks']} cross-attention blocks, {rows} x "
              f"{plen} tokens over {d['source_len']} source positions, "
              f"{ENCDEC_DECODE_STEPS} decode steps: {d['tokens_per_s']:.1f}"
              f" tokens/s, launches {d['launches']} (tensor-core / warp "
              f"{d['tc_launches']}), prefill wall {d['prefill']['wall_ms']:.2f}"
              f" ms busy {d['prefill']['busy_ms']:.2f} ms, decode step wall "
              f"{d['decode_step']['wall_ms']:.2f} ms busy "
              f"{d['decode_step']['busy_ms']:.2f} ms, logits vs plain "
              f"(relative L2, limit {LOGIT_REL_L2}) prefill "
              f"{d['prefill_rel_l2']:.3e}, decode {d['decode_rel_l2']:.3e}, "
              f"peak {d['peak_gb']:.2f} GB (set-up {d['setup_peak_gb']:.2f} "
              f"GB)")
    out["d_mla"] = {}
    for quant in ("bf16", "int8"):
        out["d_mla"][quant] = m = _mla_arm(quant)
        for r in records:
            if r["name"] in m["launches"]:
                r.setdefault("launches_by_drive", {})[f"mla_{quant}"] = \
                    m["launches"][r["name"]]
        print(f"[21 encdec] (d) qwen2-1.5b mla {quant} {smi}: "
              f"{m['params_b']:.2f} B params, latent "
              f"{m['cache_bytes_per_token']} B a token (kv_bytes_per_token "
              f"{m['kv_bytes_per_token']:.0f}; GQA "
              f"{m['gqa_kv_bytes_per_token']:.0f}), {m['requests']} req, "
              f"{m['tokens']} tokens in {m['wall_s']:.3f}s "
              f"({m['tokens_per_s']:.1f} tok/s), TTFT p50 "
              f"{m['ttft_p50_s']:.4f}s, {m['admissions']} admissions + "
              f"{m['decode_steps']} decode steps = {m['syncs']} syncs, "
              f"launches {m['launches']}, admission logits vs plain "
              f"{m['logit_rel_l2']:.3e}, peak {m['peak_mem_gb']:.2f} GB")
    out["e_calibration"] = c = _calibration()
    s = c["served"]
    print(f"[21 encdec] (e) calibration qwen2-1.5b {smi}: "
          f"collect_linear_inputs {c['captured']} linears in "
          f"{c['collect_s']:.2f}s, SmoothQuant {c['smoothquant_s']:.3f}s, "
          f"AWQ (8 bits) {c['awq_s']:.2f}s (scales "
          f"{c['awq_scale_range'][0]:.3g}..{c['awq_scale_range'][1]:.3g}), "
          f"GPTQ 4 bits on 1536 x 8960 gate (host) {c['gptq_s']:.2f}s, "
          f"output error GPTQ {c['gptq_out_rel_err']:.4f} vs RTN "
          f"{c['rtn_out_rel_err']:.4f} | SmoothQuant int8 served: "
          f"{s['requests']} req, {s['tokens']} tokens "
          f"({s['tokens_per_s']:.1f} tok/s), launches {s['launches']}")
    for r in records:
        if r["name"] in s["launches"]:
            r.setdefault("launches_by_drive", {})["calibrated_int8"] = \
                s["launches"][r["name"]]
    out["phase_wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    print(f"[21 encdec] phase {out['phase_wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 22: Mamba and the jamba hybrid

JAMBA = "jamba-1.5-large-398b"
#: the cut that fits one card: block_pattern[:5], 4 Mamba blocks and the
#: attention block, MoE on blocks 0, 2 and 4 (33.1 B parameters, 66.2 GB
#: in bf16; one whole group is 90.5 GB)
JAMBA_LAYERS = 5
JAMBA_SLOTS = 4
JAMBA_STEPS = 32           # new tokens a request in (b) and (c)
JAMBA_PROMPT = 2048        # (a)'s admission; the longest prompt of (b)
#: (a): the main path's scan against the sequential recurrence, fp32,
#: relative L2 of y and of the final state
MAMBA_SCAN_REL_L2 = 1e-4
#: (K, N) of the Mamba in_proj and out_proj at jamba's width (rows 4j, 5j)
JAMBA_QMM = ((8192, 32768), (16384, 8192))


def _jamba_config():
    from repro_torch.configs import first_layers, get_config
    return first_layers(get_config(JAMBA), JAMBA_LAYERS)


def _hold_jamba_kernels(records: list) -> dict:
    """(e) B3 at jamba's attention layer (1 x 2,048, 64 heads over 8, D
    128, causal, bf16) element by element against its plain version; B5
    (M 4) and B4 (M 256) bit for bit against their plain versions on CPU
    copies at the Mamba ``in_proj`` (K 8,192 -> N 32,768) and ``out_proj``
    (16,384 -> 8,192); B7 at (4, 8,192) and (2,048, 8,192) within one bf16
    ulp.  Then each timed at the main path's shapes (B3 1 x 2,048, B4 M
    2,048, B5 M 4, B7 2,048 and 4 rows) beside its plain version and its
    library call, with its bound: rows 3j, 4j, 5j and 7j."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.int8_matmul.ref import (int8_matmul_ref,
                                                     quantize_rowwise,
                                                     w8a8_decode_ref)
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 221)
    bf16 = torch.bfloat16
    cfg = _jamba_config()
    h, kh, d = (cfg.attention.num_heads, cfg.attention.num_kv_heads,
                cfg.attention.head_dim)
    s, dm = JAMBA_PROMPT, cfg.d_model
    line, times = [], {}
    q, k, v = _flash_inputs(1, s, bf16, g, device, h, kh, d)
    tc0 = fops.tc_launches
    out = fops.flash_attention(q, k, v, causal=True)
    line.append(check_close(
        f"B3 1x{s} H{h}/{kh}" + _step_tag(fops.tc_launches - tc0, True),
        out, attention_ref(q, k, v, causal=True), 1.0))
    del q, k, v, out
    for kk, n in JAMBA_QMM:
        qw, ws, _ = _qlinear(g, device, kk, n, "int8")
        x = torch.randn((JAMBA_SLOTS, kk), generator=g, device=device).to(
            bf16)
        tc0 = qmm.decode_tc_launches
        out = qmm.w8a8_matmul_decode(x, qw, ws)
        step = "tensor cores" if qmm.decode_tc_launches > tc0 else "ragged"
        if not torch.equal(out.cpu(), w8a8_decode_ref(_cpu(x), _cpu(qw),
                                                      _cpu(ws), None)):
            raise AssertionError(f"B5 K{kk} N{n}: differs from the plain "
                                 "version on the CPU copy")
        xq, xs = quantize_rowwise(torch.randn((256, kk), generator=g,
                                              device=device).to(bf16))
        tc0 = qmm.tc_launches
        out = qmm.int8_matmul(xq, qw, xs, ws, out_dtype=bf16)
        b4_step = "wgmma" if qmm.tc_launches > tc0 else "ragged"
        if not torch.equal(out.cpu(), int8_matmul_ref(
                _cpu(xq), _cpu(qw), _cpu(xs), _cpu(ws), bf16)):
            raise AssertionError(f"B4 M256 K{kk} N{n}: differs from the "
                                 "plain version on the CPU copy")
        line.append(f"K{kk} N{n}: B5 M{JAMBA_SLOTS} [{step}] and B4 M256 "
                    f"[{b4_step}] bit-equal to the plain versions")
    del qw, ws, x, xq, xs, out
    for rows in (JAMBA_SLOTS, s):
        x = torch.randn((rows, dm), generator=g, device=device).to(bf16)
        w = torch.randn((dm,), generator=g, device=device).to(bf16)
        worst = _within_one_ulp(f"B7 ({rows}, {dm})", rops.rmsnorm(x, w),
                                rmsnorm_ref(x.cpu(), w.cpu()))
        line.append(f"B7 ({rows}, {dm}) worst {worst:.2f} ulp")

    # times at the main path's shapes
    times["flash_attention"] = _flash_times(1, s, h, kh, d, g, device)
    for kind, m in (("B5", JAMBA_SLOTS), ("B4", s)):
        per = {f"K{kk}xN{n}": _qmm_times(kind, m, kk, n, g, device)
               for kk, n in JAMBA_QMM}
        times[QMM_KERNELS[kind][0]] = {"M": m, "per_shape": per}
    per = {}
    for rows in (s, JAMBA_SLOTS):
        copies = [(torch.randn((rows, dm), generator=g,
                               device=device).to(bf16),
                   torch.ones((dm,), device=device, dtype=bf16))
                  for _ in range(n_copies(rows * dm * 4))]
        per[f"{rows}x{dm}"] = {
            "ms": time_ms(rops.rmsnorm, copies),
            "plain_ms": time_ms(rmsnorm_ref, copies, reps=5, rounds=3),
            "library_ms": time_ms(lambda x, w: F.rms_norm(x, (dm,), w, 1e-5),
                                  copies),
            **dict(zip(("bound_ms", "bound_by"),
                       bound(rows * dm * 4 + dm * 2, 4.0 * rows * dm,
                             "float32")))}
        del copies
    times["rmsnorm"] = {"per_shape": per}
    for r in records:
        if r["name"] in times:
            r.setdefault("jamba_shapes", times[r["name"]])
    return {"held": line, "times": times}


def _mamba_layer_alone() -> dict:
    """(a) One Mamba layer at jamba's width (d 8,192, d_inner 16,384, N 16,
    d_conv 4, bf16 weights from the seed), one 2,048-token admission: the
    main path's scan (chunks of 128, a log-step scan in each) against the
    sequential recurrence on the same fp32 operands, y and the final state
    within MAMBA_SCAN_REL_L2 relative L2; then the wall and device busy
    time of ``mamba_forward`` at 1 x 2,048, of the scan alone (beside the
    bound of a fused scan that reads dt, x, B and C and writes y once) and
    of 32 ``mamba_decode`` steps after it."""
    torch = _torch()
    from repro_torch.models import ssm
    cfg = _jamba_config()
    s, dm = cfg.ssm, cfg.d_model
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 222)
    p = ssm.init_mamba(g, dm, s, torch.bfloat16, dev)
    x = torch.randn((1, JAMBA_PROMPT, dm), generator=g, device=dev).to(
        torch.bfloat16)
    st = ssm.init_mamba_state(1, dm, s, dev)
    with torch.no_grad():
        _, xf, dt, a, bmat, cmat, _ = ssm.mamba_scan_inputs(p, x, s, st)
        h0 = st["ssm"]
        h, y = ssm.mamba_scan(h0, dt, a, bmat, cmat, xf)
        h_ref, y_ref = ssm.mamba_scan_ref(h0, dt, a, bmat, cmat, xf)
        rel = {name: ((got - want).norm() / want.norm()).item()
               for name, got, want in (("y", y, y_ref), ("h", h, h_ref))}
        if not all(torch.isfinite(t).all() for t in (y, h)) or not max(
                rel.values()) <= MAMBA_SCAN_REL_L2:
            raise AssertionError(f"(a) Mamba scan vs the sequential "
                                 f"recurrence: relative L2 {rel} > "
                                 f"{MAMBA_SCAN_REL_L2} (or not finite)")
        del h_ref, y_ref
        fwd = _wall_busy(lambda: ssm.mamba_forward(p, x, s, st))
        scan = _wall_busy(lambda: ssm.mamba_scan(h0, dt, a, bmat, cmat, xf))
        _, st1 = ssm.mamba_forward(p, x, s, st)
        xt = torch.randn((1, 1, dm), generator=g, device=dev).to(
            torch.bfloat16)

        def decode():
            state = st1
            for _ in range(JAMBA_STEPS):
                _, state = ssm.mamba_decode(p, xt, s, state)
        dec = _wall_busy(decode)
    di, n, sl = s.expand * dm, s.d_state, JAMBA_PROMPT
    b_ms, b_by = bound(4 * (3 * sl * di + 2 * sl * n + 2 * di * n),
                       6.0 * sl * di * n, "float32")
    del p, x, xf, dt, bmat, cmat, y, h
    gc.collect()
    torch.cuda.empty_cache()
    return {"scan_rel_l2": rel, "forward": fwd, "scan": scan,
            "decode_32_steps": dec, "scan_bound_ms": b_ms,
            "scan_bound_by": b_by, "tokens": sl, "d_inner": di,
            "d_state": n}


def _qmm_calls_vs_plain(fn) -> tuple:
    """Run ``fn()`` with every B4 and B5 call also computed by its plain
    version on the same inputs, held bit for bit (not B7 as well: ROADMAP
    C trap 5); the forward goes on with the kernel's output.  Returns
    (fn's result, {kernel: calls checked}, the (kernel, M, K, N) shapes)."""
    torch = _torch()
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.int8_matmul.ref import (int8_matmul_ref,
                                                     w8a8_decode_ref)
    from repro_torch.quant import qops
    calls = {"int8_matmul": 0, "w8a8_decode_matmul": 0}
    shapes = set()
    b4, b5 = qmm.int8_matmul, qops.w8a8_matmul_decode

    def tiled(xq, wq, xs, ws, *, out_dtype=torch.bfloat16):
        out = b4(xq, wq, xs, ws, out_dtype=out_dtype)
        if not torch.equal(out, int8_matmul_ref(xq, wq, xs, ws,
                                                out_dtype=out_dtype)):
            raise AssertionError(f"B4 call {calls['int8_matmul']} "
                                 f"{tuple(xq.shape)} x {tuple(wq.shape)}: "
                                 "differs from the plain version")
        calls["int8_matmul"] += 1
        shapes.add(("B4", *xq.shape, wq.shape[1]))
        return out

    def decode(x2, wq, ws, *, bias=None, out_dtype=None):
        out = b5(x2, wq, ws, bias=bias, out_dtype=out_dtype)
        if not torch.equal(out, w8a8_decode_ref(x2, wq, ws, bias,
                                                out_dtype or x2.dtype)):
            raise AssertionError(f"B5 call {calls['w8a8_decode_matmul']} "
                                 f"{tuple(x2.shape)} x {tuple(wq.shape)}: "
                                 "differs from the plain version")
        calls["w8a8_decode_matmul"] += 1
        shapes.add(("B5", *x2.shape, wq.shape[1]))
        return out

    qmm.int8_matmul, qops.w8a8_matmul_decode = tiled, decode
    try:
        return fn(), calls, sorted(shapes)
    finally:
        qmm.int8_matmul, qops.w8a8_matmul_decode = b4, b5


def _jamba_prompts(rng, vocab: int) -> list:
    """4 prompts of 512-2,048 tokens, the first 2,048 (the port takes any
    length: the reference's fault 10 does not apply)."""
    plens = [JAMBA_PROMPT, *rng.integers(512, JAMBA_PROMPT + 1, 3)]
    return [rng.integers(0, vocab, (int(n),)) for n in plens]


def _jamba_step_inputs(eng, prompt) -> tuple:
    """A decode step's (tokens, positions) for every slot of ``eng``, with
    slot 0 just past ``prompt``."""
    torch = _torch()
    toks = torch.full((eng.n_slots,), int(prompt[-1]), device=eng.device)
    pos = torch.full((eng.n_slots,), len(prompt), device=eng.device)
    return toks, pos


def _jamba_served(lm, params, prompts, tag: str, qlinears: int = 0) -> dict:
    """One jamba arm through the eager Engine (JAMBA_SLOTS slots, max_len
    past the longest prompt and its JAMBA_STEPS tokens): a warm-up
    request, then the drive (``_eager_drive``: tokens, syncs = admissions
    + decode steps, B3 once an admission, B7 11 a forward on its long-row
    step, B4 / B5 ``qlinears`` an admission / decode step), then the same
    drive again: every slot is reused, its Mamba state non-zero before the
    admission, and each request's stream must equal the first run's.
    Returns the engine with the result."""
    torch = _torch()
    import numpy as np
    from repro_torch.obs import Tracer
    from repro_torch.serve.engine import Engine
    cfg = lm.cfg
    tracer = Tracer(enabled=True)
    eng = Engine(lm, params, n_slots=JAMBA_SLOTS,
                 max_len=JAMBA_PROMPT + JAMBA_STEPS + 1, seed=SEED,
                 tracer=tracer)
    rng = np.random.default_rng(SEED + 224)
    eng.submit(rng.integers(0, cfg.vocab_size, 300), max_new_tokens=4)
    eng.run_to_completion()                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    max_new = np.full(len(prompts), JAMBA_STEPS)
    exempt = ("rmsnorm", "w8a8_decode_matmul")   # d 8,192; K 24,576
    res = _eager_drive(eng, tracer, prompts, max_new, tag,
                       qlinears=qlinears, exempt=exempt)
    states = [node["state"]["ssm"] for node in eng.cache[0].values()
              if "state" in node]
    if not all(bool((st != 0).any(dim=(1, 2)).all()) for st in states):
        raise AssertionError(f"{tag}: a slot's Mamba state is zero after "
                             "the drive")
    again = _eager_drive(eng, tracer, prompts, max_new, f"{tag} again",
                         qlinears=qlinears, exempt=exempt)
    if again["streams"] != res["streams"]:
        raise AssertionError(f"{tag}: the second run (reused slots) gave "
                             "other streams")
    res["second_run_tokens_per_s"] = again["tokens_per_s"]
    return eng, res


def _jamba_model(records: list, smi: str) -> dict:
    """(b) jamba-1.5-large-398b's first five layers at full width, bf16
    weights from the seed (made on the card, no fp32 copy of a whole
    expert stack), through the eager Engine: the drive and its second
    run; one admission's and one decode step's logits with B3 and B7
    swapped for their plain versions within LOGIT_REL_L2; the admission's
    and a decode step's wall and device busy time by kernel family.  (c)
    The same with ``quantize_tree(int8)`` (Mamba in_proj / out_proj, the
    attention and dense-MLP linears; the expert stacks stay bf16): B4 / B5
    launches, and every B4 / B5 call of one admission and one decode step
    bit-equal to its plain version."""
    torch = _torch()
    import numpy as np
    from repro_torch.launch.profile_serve import _phase, families
    from repro_torch.models.model import LM
    from repro_torch.quant import quantize_tree
    from repro_torch.quant.qops import memory_bytes
    cfg = _jamba_config()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, device="cuda")
    t0 = time.perf_counter()
    params = lm.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    out = {"params_b": cfg.param_count() / 1e9, "init_s": init_s,
           "weights_gb": memory_bytes(params) / 1e9,
           "setup_peak_gb": _setup_peak_gb()}
    rng = np.random.default_rng(SEED + 223)
    prompts = _jamba_prompts(rng, cfg.vocab_size)
    eng, out["b"] = _jamba_served(lm, params, prompts, "jamba bf16")
    b = out["b"]
    v = cfg.vocab_size
    toks, pos = _jamba_step_inputs(eng, prompts[0])

    def admit():
        return eng._prefill_slot(prompts[0], 0)

    def step():
        return lm.decode_step(eng.params, toks, eng.cache, pos)[0]
    lk = admit()
    lp = _swap_plain(admit, ("attention", "norm"))
    b["admission_rel_l2"], b["admission_max_abs"] = _worst_slot_rel_l2(
        "jamba admission", lk[None], lp[None], (1, v))
    sk = step()
    sp = _swap_plain(step, ("attention", "norm"))
    b["decode_rel_l2"], b["decode_max_abs"] = _worst_slot_rel_l2(
        "jamba decode step", sk, sp, (JAMBA_SLOTS, v))
    del lp, sp
    b["admission_profile"] = _phase(f"22 jamba admit 1x{JAMBA_PROMPT}",
                                    lambda: admit().cpu(), families)
    b["decode_profile"] = _phase(f"22 jamba decode step, {JAMBA_SLOTS} "
                                 "slots", lambda: step().cpu(), families)
    del eng, lk, sk
    gc.collect()
    torch.cuda.empty_cache()
    # (c) int8 weights: the bf16 leaves that get quantized are freed
    qparams = quantize_tree(params, quant="int8")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    qlm = LM(cfg.with_(quant="int8"), device="cuda")
    out["int8_weights_gb"] = memory_bytes(qparams) / 1e9
    eng, out["c"] = _jamba_served(qlm, qparams, prompts, "jamba int8",
                                  qlinears=_qlinears(qlm.cfg))
    c = out["c"]
    toks, pos = _jamba_step_inputs(eng, prompts[0])
    _, c["admission_calls"], shapes = _qmm_calls_vs_plain(
        lambda: eng._prefill_slot(prompts[0], 0))
    _, c["decode_calls"], more = _qmm_calls_vs_plain(
        lambda: qlm.decode_step(eng.params, toks, eng.cache, pos))
    want = _qlinears(qlm.cfg)
    if c["admission_calls"] != {"int8_matmul": want,
                                "w8a8_decode_matmul": 0} or \
            c["decode_calls"] != {"int8_matmul": 0,
                                  "w8a8_decode_matmul": want}:
        raise AssertionError(f"jamba int8: B4 / B5 calls checked "
                             f"{c['admission_calls']} / {c['decode_calls']},"
                             f" want {want} each")
    c["qmm_shapes"] = [list(sh) for sh in shapes + more]
    del eng, qparams, qlm, lm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_jamba(records: list, smi: str) -> dict:
    """Phase 22: (e) B3 / B4 / B5 / B7 held and timed at jamba's shapes
    (rows 3j / 4j / 5j / 7j); (a) one Mamba layer at jamba's width, the
    scan against its oracle and timed; (d) the smoke jamba's loss and
    gradients on the card against the CPU's; (b) jamba-1.5-large-398b's
    first five layers at full width through the eager Engine, bf16, and
    (c) with int8 weights."""
    torch = _torch()
    import numpy as np
    t_phase = time.perf_counter()
    out = {"e_kernels": _hold_jamba_kernels(records)}
    t = out["e_kernels"]["times"]
    print(f"[22 jamba] (e) {smi}: " + "; ".join(out["e_kernels"]["held"])
          + "; times " + "; ".join(
              f"{name} {r.get('shape', '')}: ms {r['ms']:.4f} plain "
              f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']})"
              for name, r in (("B3", t["flash_attention"]),))
          + "; " + "; ".join(
              f"{kind} M{t[name]['M']} {shape}: ms {r['ms']:.4f} plain "
              f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} bf16 "
              f"{r['bf16_ms']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})"
              for kind, name in (("B4", "int8_matmul"),
                                 ("B5", "w8a8_decode_matmul"))
              for shape, r in t[name]["per_shape"].items())
          + "; " + "; ".join(
              f"B7 {shape}: ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
              f"F.rms_norm {r['library_ms']:.4f} bound {r['bound_ms']:.4f}"
              f" ({r['bound_by']})"
              for shape, r in t["rmsnorm"]["per_shape"].items()))
    out["a_mamba_layer"] = a = _mamba_layer_alone()
    print(f"[22 jamba] (a) one Mamba layer, d {_jamba_config().d_model}, "
          f"d_inner {a['d_inner']}, N {a['d_state']}, 1 x {a['tokens']} "
          f"{smi}: scan vs the sequential recurrence (fp32, relative L2, "
          f"limit {MAMBA_SCAN_REL_L2}) y {a['scan_rel_l2']['y']:.3e} h "
          f"{a['scan_rel_l2']['h']:.3e}; forward wall "
          f"{a['forward']['wall_ms']:.2f} ms busy "
          f"{a['forward']['busy_ms']:.2f} ms ({a['forward']['kernel_runs']}"
          f" kernel runs); scan alone wall {a['scan']['wall_ms']:.2f} busy "
          f"{a['scan']['busy_ms']:.2f} ms, bound of a fused scan "
          f"{a['scan_bound_ms']:.4f} ms ({a['scan_bound_by']}); "
          f"{JAMBA_STEPS} decode steps wall "
          f"{a['decode_32_steps']['wall_ms']:.2f} busy "
          f"{a['decode_32_steps']['busy_ms']:.2f} ms")
    _reset_launches()
    out["d_train"] = d = _smoke_grads_card_vs_cpu(
        JAMBA, np.random.default_rng(SEED + 225), "(d)", nonzero=True)
    d["launches"] = _no_launches("(d)")
    print(f"[22 jamba] (d) smoke jamba float32 loss card {d['loss_card']:.6f}"
          f" cpu {d['loss_cpu']:.6f}, {d['leaves']} gradient leaves, worst "
          f"relative L2 card vs CPU {d['worst_rel_l2']:.3e} (limit "
          f"{TRAIN_GRAD_REL_L2}), every leaf's gradient non-zero, no kernel "
          "launch")
    m = _jamba_model(records, smi)
    out.update(m)
    b, c = m["b"], m["c"]
    adm = b["admission_profile"]
    b["mamba_share_of_admission"] = (
        _jamba_config().block_pattern.count("mamba")
        * a["forward"]["busy_ms"] / adm["device_busy_ms"])
    for arm, r in (("jamba_bf16", b), ("jamba_int8", c)):
        for rec in records:
            if rec["name"] in r["launches"]:
                rec.setdefault("launches_by_drive", {})[arm] = \
                    r["launches"][rec["name"]]
    dec = b["decode_profile"]
    print(f"[22 jamba] (b) {JAMBA} first {JAMBA_LAYERS} layers "
          f"{_jamba_config().block_pattern} {smi}: {m['params_b']:.2f} B "
          f"params, {m['weights_gb']:.2f} GB of weights made in "
          f"{m['init_s']:.1f}s; {b['requests']} req, {b['tokens']} tokens "
          f"in {b['wall_s']:.3f}s ({b['tokens_per_s']:.1f} tok/s; second "
          f"run {b['second_run_tokens_per_s']:.1f}, same streams), TTFT p50 "
          f"{b['ttft_p50_s']:.4f}s, {b['admissions']} admissions + "
          f"{b['decode_steps']} decode steps = {b['syncs']} syncs, launches "
          f"{b['launches']}; admission 1 x {JAMBA_PROMPT} wall "
          f"{adm['wall_ms']:.2f} ms busy {adm['device_busy_ms']:.2f} ms "
          f"(matmul {adm['matmul_ms']:.2f}, attention "
          f"{adm['attention_ms']:.2f}, rmsnorm {adm['rmsnorm_ms']:.2f}, "
          f"other {adm['other_ms']:.2f}), the 4 Mamba layers' share "
          f"{b['mamba_share_of_admission']:.3f}; decode step wall "
          f"{dec['wall_ms']:.2f} ms busy {dec['device_busy_ms']:.2f} ms "
          f"(matmul {dec['matmul_ms']:.2f}); logits vs plain B3 / B7 "
          f"(relative L2, limit {LOGIT_REL_L2}) admission "
          f"{b['admission_rel_l2']:.3e}, decode {b['decode_rel_l2']:.3e}; "
          f"peak {b['peak_mem_gb']:.2f} GB (set-up "
          f"{m['setup_peak_gb']:.2f} GB)")
    print(f"[22 jamba] (c) int8 weights ({m['int8_weights_gb']:.2f} GB) "
          f"{smi}: {c['requests']} req, {c['tokens']} tokens "
          f"({c['tokens_per_s']:.1f} tok/s), TTFT p50 {c['ttft_p50_s']:.4f}s,"
          f" launches {c['launches']}; every B4 / B5 call of one admission "
          f"({c['admission_calls']}) and one decode step "
          f"({c['decode_calls']}) bit-equal to its plain version; peak "
          f"{c['peak_mem_gb']:.2f} GB")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    print(f"[22 jamba] phase {out['phase_wall_s']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 23: tensor-parallel serving, two ranks sharing the card


TP_RANKS = 2
TP_HEADS = (6, 1, 128)      # qwen2-1.5b's heads on one of two ranks
TP_F32_LAYERS = 4           # (b): phase 16's float32 depth
TP_F32_REQUESTS = 2
TP_SCHED_REQUESTS = 4       # (c): half behind a shared prefix
TP_SCHED_NEW = 16           # (c): new tokens a request
TP_Q_REQUESTS = 4           # (d), 8 new tokens each
TP_Q_NEW = 8
TP_GATHER_STEPS = 2         # (e)
TP_GATHER_MIN_RATIO = 4.0   # (e): kv_shard's all-gather bytes at least 4x
                            # below gather's (the reference's bar)


def _tp_kernel_rows() -> dict:
    """(f): B1, B2 and B3 at one rank's heads (6 over 1, D 128), element
    by element against their plain versions on phases 3 / 6 / 4's
    operands, and timed beside the plain version, SDPA and the bound
    (rows 1t / 2t / 3t)."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefix_extend_ref)
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 23)
    h, kh, d = TP_HEADS
    rows, held = {}, []
    # B1: phase 3's slots (a free slot, one token, partial pages, the
    # full horizon), 8 slots x 4 pages of 256
    lengths = [0, 1, 300, 1024, 517, 256, 77, 900]
    args = _paged_inputs("bfloat16", g, device, lengths, h, kh, d)
    out = pops.paged_attention(*args)
    ref = paged_attention_ref(*args)
    torch.cuda.synchronize()
    vp = args[2]
    held.append(check_close(f"1t B1 H{h}/{kh} D{d}", out, ref,
                            vp.float().pow(2).mean().sqrt().item()))
    nbytes, flops = paged_bytes_flops(args[0], args[1], args[3], args[4],
                                      args[5])
    copies = [_paged_inputs("bfloat16", g, device, lengths, h, kh, d)
              for _ in range(n_copies(vp.numel() * vp.element_size() * 2))]
    lib_in = []
    for (q_, kp_, vp_, bt_, ln_, _, _) in copies:
        t = bt_.shape[1] * kp_.shape[1]
        kc = kp_[bt_.long()].reshape(8, t, kh, d).transpose(1, 2)
        vc = vp_[bt_.long()].reshape(8, t, kh, d).transpose(1, 2)
        mask = (torch.arange(t, device=device)[None, :]
                < ln_[:, None])[:, None, None, :]
        lib_in.append((q_[:, :, None, :], kc.contiguous(), vc.contiguous(),
                       mask))
    rows["1t"] = {
        "shape": f"8 slots, H{h}/{kh} D{d}, lengths {lengths}",
        "max_abs_err": (out.float() - ref.float()).abs().max().item(),
        "ms": time_ms(pops.paged_attention, copies),
        "plain_ms": time_ms(paged_attention_ref, copies, reps=5, rounds=3),
        "library_ms": time_ms(
            lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mm, enable_gqa=True), lib_in),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, flops, "bfloat16")))}

    # B2: phase 6's timed case, the scheduler's continuation chunks
    def extend():
        return _extend_inputs("bfloat16", g, device, [512, 1024, 2048, 3072],
                              [512] * 4, 512, h, kh, d, pps=16)

    args = extend()
    out = pops.paged_prefix_extend_attention(*args)
    ref = paged_prefix_extend_ref(*args)
    torch.cuda.synchronize()
    held.append(check_close(f"2t B2 W512 H{h}/{kh} D{d}", out, ref, 1.0))
    nbytes, flops = extend_bytes_flops(args)
    copies = [args] + [extend() for _ in range(3)]
    lib_in = [_extend_sdpa_inputs(a) for a in copies[:2]]
    rows["2t"] = {
        "shape": f"4 x 512 chunk rows over prefixes 512-3072, H{h}/{kh} D{d}",
        "max_abs_err": (out.float() - ref.float()).abs().max().item(),
        "ms": time_ms(pops.paged_prefix_extend_attention, copies, reps=10),
        "plain_ms": time_ms(paged_prefix_extend_ref, copies[:2], reps=3,
                            rounds=3),
        "library_ms": time_ms(
            lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mm, enable_gqa=True), lib_in,
            reps=10),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, flops, "bfloat16")))}
    # B3: an admission of 8 x 512 tokens
    q, k, v = _flash_inputs(8, 512, torch.bfloat16, g, device, h, kh, d)
    out = fops.flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    held.append(check_close(f"3t B3 8 x 512 H{h}/{kh} D{d} causal", out,
                            ref, v.float().pow(2).mean().sqrt().item()))
    rows["3t"] = {**_flash_times(8, 512, h, kh, d, g, device),
                  "max_abs_err": (out.float() - ref.float()).abs().max(
                      ).item()}
    return {"rows": rows, "held": held}


def _tp_prompts(vocab: int) -> tuple:
    """Phase 5's drive, from its seed: the warm-up prompt, the 12
    prompts of 64-512 tokens and half their 32-64 new tokens (time)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    warm = rng.integers(0, vocab, (64,))
    plens = rng.integers(64, 513, 12)
    max_new = rng.integers(32, 65, 12) // 2
    return warm, [rng.integers(0, vocab, (int(n),)) for n in plens], max_new


def _tp_shared_prompts(vocab: int) -> list:
    """(c): 4 prompts of repeated passages (the n-gram drafter proposes),
    two of them behind a shared 512-token prefix."""
    import numpy as np
    rng = np.random.default_rng(SEED + 231)
    out = []
    for i in range(TP_SCHED_REQUESTS):
        passage = rng.integers(0, vocab, (48,))
        out.append(np.tile(passage, 12)[:512 + 64 * i])
    shared = out[0][:512]
    return out[:2] + [np.concatenate([shared, p[:256]]) for p in out[2:]]


def _tp_logit_inputs(vocab: int) -> tuple:
    """One admission of 8 rows (100-500 tokens, padded to 512) and the
    decode step after it (the same next token on every side)."""
    import numpy as np
    rng = np.random.default_rng(SEED + 232)
    plens = rng.integers(100, 500, 8).astype(np.int32)
    toks = np.zeros((8, 512), np.int64)
    for s, n in enumerate(plens):
        toks[s, :n] = rng.integers(0, vocab, n)
    return toks, plens, rng.integers(0, vocab, 8).astype(np.int32)


def _tp_logits(lm, params, inputs, wrap=None) -> dict:
    """The logits (CPU float32) of one admission prefill and one decode
    step on a fresh paged cache of ``lm``'s heads; ``wrap(fn)`` (e.g.
    ``_qmm_calls_vs_plain``) runs each forward and returns (result,
    calls, shapes)."""
    torch = _torch()
    import numpy as np
    from repro_torch.serve.paged import (PageAllocator,
                                         scatter_prefill_cache,
                                         set_block_table_rows)
    wrap = wrap or (lambda fn: (fn(), None, None))
    toks, plens, nxt = inputs
    n_s, pps = 8, 4
    alloc = PageAllocator(n_s * pps + 1, pps, n_s)
    cache = lm.init_paged_cache(n_s, n_s * pps + 1, pps, page_size=256)
    for s, n in enumerate(plens):
        alloc.alloc(s, alloc.pages_needed(int(n) + 8, 256))
    set_block_table_rows(cache, np.arange(n_s), alloc.table)
    dev = lm.device
    t_toks = torch.as_tensor(toks, device=dev)
    t_plens = torch.as_tensor(plens, device=dev)
    stage = lm.init_cache(n_s, 512, kv_dtype="bfloat16")
    (pre, stage), pre_calls, pre_shapes = wrap(
        lambda: lm.prefill(params, t_toks, stage, lengths=t_plens))
    scatter_prefill_cache(cache, stage, torch.arange(n_s, device=dev),
                          t_plens)
    (dec, _), dec_calls, dec_shapes = wrap(
        lambda: lm.decode_step(params, torch.as_tensor(nxt, device=dev),
                               cache, t_plens))
    return {"prefill": pre.float().cpu().numpy(),
            "decode": dec.float().cpu().numpy(),
            "prefill_calls": pre_calls, "decode_calls": dec_calls,
            "shapes": sorted(set(pre_shapes or []) | set(dec_shapes or []))}


def _tp_paged_drive(eng, prompts, max_new, tag: str) -> dict:
    """Serve ``prompts`` through a PagedEngine with the launch counts
    zeroed just before and read just after (phase 5's checks: token
    counts, syncs = admissions + decode blocks, B1 = L x decode steps, B3
    = L x admissions, B7 = (2L + 1) x forwards), the decode steps'
    collectives and the streams."""
    torch = _torch()
    cfg = eng.lm.cfg
    cnt0 = eng.metrics.snapshot()["counters"]
    syncs0, steps0 = eng.sync_count, eng.steps_run
    t_dec0 = eng.t_decode_s
    coll0 = eng.decode_collectives.copy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=int(m))
           for p, m in zip(prompts, max_new)]
    done = eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    cnt = eng.metrics.snapshot()["counters"]
    admits = int(cnt["serve_prefill_dispatches_total"]
                 - cnt0["serve_prefill_dispatches_total"])
    blocks = int(cnt["serve_decode_dispatches_total"]
                 - cnt0["serve_decode_dispatches_total"])
    syncs, steps = eng.sync_count - syncs0, eng.steps_run - steps0
    streams = [list(done[i].out_tokens) for i in ids]
    for s, m in zip(streams, max_new):
        if len(s) != int(m) or not all(0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"{tag}: a stream of {len(s)} tokens, want "
                                 f"{m}, or a token out of vocab")
    layers = cfg.num_layers
    want = {"paged_attention": layers * steps,
            "flash_attention": layers * admits,
            "rmsnorm": (2 * layers + 1) * (admits + steps)}
    got = {k: launches[k] for k in want}
    if syncs != admits + blocks or got != want:
        raise AssertionError(f"{tag}: {syncs} syncs for {admits} admissions "
                             f"+ {blocks} blocks; launches {got} != {want}")
    ttft = sorted(done[i].t_first - done[i].t_submit for i in ids)
    n_tok = sum(len(s) for s in streams)
    return {"streams": streams, "tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "ttft_p50_s": statistics.median(ttft), "admissions": admits,
            "decode_blocks": blocks, "decode_steps": steps, "syncs": syncs,
            "decode_step_wall_ms": (eng.t_decode_s - t_dec0) / max(steps, 1)
            * 1e3,
            "launches": {k: v for k, v in launches.items() if v},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "decode_collectives": eng.decode_collectives.since(
                coll0).to_dict(steps=max(steps, 1))}


def _tp_probe(mesh) -> dict:
    """Every collective the path makes, once on CUDA tensors, checked:
    all-reduce sum and max (fp32), all-gather (built from broadcasts) of
    bf16, int8 and fp8 pieces."""
    torch = _torch()
    from repro_torch.sharding.collectives import all_gather, all_reduce
    dev, r, m = mesh.device, mesh.model_rank, mesh.model
    x = torch.arange(6, device=dev, dtype=torch.float32) + 10 * r
    want_sum = sum(torch.arange(6, dtype=torch.float32) + 10 * i
                   for i in range(m))
    ok = {"sum": torch.equal(all_reduce(x, "sum", mesh).cpu(), want_sum),
          "max": torch.equal(all_reduce(x, "max", mesh).cpu(),
                             torch.arange(6, dtype=torch.float32)
                             + 10 * (m - 1))}
    for dt in (torch.bfloat16, torch.int8, torch.float8_e4m3fn):
        piece = (torch.full((2, 3), r + 1, device=dev)).to(dt)
        got = all_gather(piece, 0, mesh).float().cpu()
        ok[str(dt)[6:]] = torch.equal(
            got, torch.arange(1, m + 1).float().repeat_interleave(2)[:, None]
            .expand(2 * m, 3))
    if not all(ok.values()):
        raise AssertionError(f"collective probe on {dev} ({mesh.backend}): "
                             f"{ok}")
    return ok


def _tp_rank(rank: int) -> dict:
    """One of the two ranks of phase 23, on the card the parent holds:
    (a) qwen2-1.5b at full width through PagedEngine, phase 5's drive,
    and the logits of one admission and one decode step; (c) SchedEngine
    and the n-gram SpecEngine; phase 30 (a), (b) on the clock; (e) the
    gather arm for two decode steps; (d) int8 weights and int8 pools with
    every B4 / B5 call of one admission and one decode step held bit for
    bit; (b) float32 at 4 layers, then phase 30 (c)."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.quant import quantize_tree
    from repro_torch.sched import SchedEngine
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.spec import SpecEngine
    missing = [n for n in build.SOURCES if not build.lib_path(n).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels {missing} not built by "
                           "phase 2 (the ranks load, never build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    mesh = make_host_mesh(model=TP_RANKS, device="cuda")
    out = {"mesh": mesh.describe(), "probe": _tp_probe(mesh)}
    cfg = get_config("qwen2-1.5b")
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    paged = dict(n_slots=8, max_len=1024, page_size=256, seed=SEED,
                 mesh=mesh)
    # (a)
    eng = PagedEngine(lm, params, decode_block=8, **paged)
    out["local_heads"] = [tuple(eng.cache[0]["blk0"]["kv"]["k_pages"].shape),
                          tuple(eng.params["embed"]["w"].shape)]
    warm, prompts, max_new = _tp_prompts(cfg.vocab_size)
    eng.submit(warm, max_new_tokens=8)
    eng.run_to_completion()
    out["a"] = _tp_paged_drive(eng, prompts, max_new, f"rank {rank} (a)")
    out["a"]["setup_s"] = time.perf_counter() - t_start
    out["a"]["logits"] = _tp_logits(eng.lm, eng.params,
                                    _tp_logit_inputs(cfg.vocab_size))
    del eng
    # (c)
    shared = _tp_shared_prompts(cfg.vocab_size)
    sched_kw = dict(paged, decode_block=8, policy="fcfs", prefix_cache=True,
                    prefill_chunk=512)
    out["c"] = {}
    for name, cls, kw in (("sched", SchedEngine, {}),
                          ("spec", SpecEngine, {"spec": "ngram",
                                                "draft_k": 4})):
        tracer = Tracer(enabled=True)
        eng = cls(lm, params, tracer=tracer, **sched_kw, **kw)
        if name == "spec":
            r = _spec_drive(eng, tracer, shared,
                            [TP_SCHED_NEW] * len(shared),
                            f"rank {rank} (c) spec")
        else:
            r = _tp_sched_drive(eng, tracer, shared, f"rank {rank} (c)")
        r["streams"] = [list(q.out_tokens) for q in
                        sorted(eng.registry.values(), key=lambda q: q.rid)]
        out["c"][name] = r
        del eng
    # phase 30 (a), (b): decisions on the clock, rank 1's skewed
    out["clk"] = _clk_rank(rank, lm, params, mesh)
    # (e)
    glm = LM(cfg.with_(tp_attn_impl="gather"), device="cuda")
    eng = PagedEngine(glm, params, decode_block=TP_GATHER_STEPS, **paged)
    _reset_launches()
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=1 + TP_GATHER_STEPS)
    eng.step()
    if eng.steps_run != TP_GATHER_STEPS:
        raise AssertionError(f"rank {rank} (e): {eng.steps_run} decode steps")
    out["e"] = {"decode_collectives": eng.decode_collectives.to_dict(
        steps=TP_GATHER_STEPS), "launches": _read_launches(),
        "pages": eng.alloc.n_pages}
    del eng
    # (d)
    qcfg = cfg.with_(quant="int8", kv_cache_dtype="int8")
    qlm = LM(qcfg, device="cuda")
    qparams = quantize_tree(params, quant="int8")
    del params
    eng = PagedEngine(qlm, qparams, decode_block=8, **paged)
    out["d"] = _tp_paged_drive(eng, prompts[:TP_Q_REQUESTS],
                               [TP_Q_NEW] * TP_Q_REQUESTS,
                               f"rank {rank} (d)")
    lg = _tp_logits(eng.lm, eng.params, _tp_logit_inputs(cfg.vocab_size),
                    wrap=_qmm_calls_vs_plain)
    out["d"]["bit_equal_calls"] = {"admission": lg["prefill_calls"],
                                   "decode": lg["decode_calls"],
                                   "shapes": lg["shapes"]}
    del eng, qparams, lm
    gc.collect()
    torch.cuda.empty_cache()
    # (b)
    f32 = cfg.with_(num_layers=TP_F32_LAYERS, dtype="float32")
    flm = LM(f32, device="cuda")
    fparams = flm.init(SEED)
    eng = PagedEngine(flm, fparams, decode_block=8, **paged)
    out["b"] = {"streams": _tp_f32_streams(eng)}
    del eng
    # phase 30 (c): the float32 drive whose clock one rank replays
    out["clk"]["c"] = _clk_f32(rank, flm, fparams, mesh)
    out["wall_s"] = time.perf_counter() - t_start
    return out


def _tp_sched_drive(eng, tracer, prompts, tag: str) -> dict:
    """(c)'s SchedEngine drive: TP_SCHED_NEW tokens a request, in two waves
    (the second behind the first's prefix: prefix-cache hits), the launch
    counts zeroed just before; B2 = L x continuation chunks, B3 = L x
    fresh chunks, B1 = L x decode steps."""
    torch = _torch()
    base = _counts(eng, tracer, 0)
    n_ev = len(tracer.events)
    _reset_launches()
    half = len(prompts) // 2
    for wave in (prompts[:half], prompts[half:]):
        for p in wave:
            eng.submit(p, max_new_tokens=TP_SCHED_NEW)
        eng.run_to_completion()
    torch.cuda.synchronize()
    launches = _read_launches()
    now = _counts(eng, tracer, n_ev)
    steps = now["steps"] - base["steps"]
    layers = eng.lm.cfg.num_layers
    want = {"paged_prefix_extend": layers * now["cont"],
            "flash_attention": layers * now["fresh"],
            "paged_attention": layers * steps}
    got = {k: launches[k] for k in want}
    if got != want or now["cont"] <= 0 or eng.stats.prefix_hit_tokens <= 0:
        raise AssertionError(f"{tag}: launches {got} != {want} "
                             f"({now['cont']} continuation chunks, "
                             f"{eng.stats.prefix_hit_tokens} prefix hits)")
    return {"launches": got, "cont_dispatches": now["cont"],
            "fresh_dispatches": now["fresh"], "decode_steps": steps,
            "prefix_hit_tokens": eng.stats.prefix_hit_tokens}


def _tp_f32_streams(eng) -> list:
    """(b)'s float32 drive: phase 5's first 8 prompts, 24 new tokens."""
    warm, prompts, _ = _tp_prompts(eng.lm.cfg.vocab_size)
    ids = [eng.submit(p, max_new_tokens=24)
           for p in prompts[:TP_F32_REQUESTS]]
    done = eng.run_to_completion()
    return [list(done[i].out_tokens) for i in ids]


def _tp_single_rank() -> dict:
    """The single-rank side of (a) and (b), in this process: phase 5's
    drive and logits, and the float32 streams."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import PagedEngine
    cfg = get_config("qwen2-1.5b")
    paged = dict(n_slots=8, max_len=1024, page_size=256, seed=SEED,
                 decode_block=8)
    lm = LM(cfg, device="cuda")
    eng = PagedEngine(lm, lm.init(SEED), **paged)
    warm, prompts, max_new = _tp_prompts(cfg.vocab_size)
    eng.submit(warm, max_new_tokens=8)
    eng.run_to_completion()
    out = {"a": _tp_paged_drive(eng, prompts, max_new, "one rank (a)")}
    out["a"]["logits"] = _tp_logits(lm, eng.params,
                                    _tp_logit_inputs(cfg.vocab_size))
    del eng
    f32 = LM(cfg.with_(num_layers=TP_F32_LAYERS, dtype="float32"),
             device="cuda")
    eng = PagedEngine(f32, f32.init(SEED), **paged)
    out["b"] = {"streams": _tp_f32_streams(eng)}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel_l2_all(a, b) -> float:
    import numpy as np
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rel_l2_rows(a, b) -> float:
    import numpy as np
    return float((np.linalg.norm(a - b, axis=-1)
                  / np.linalg.norm(b, axis=-1)).max())


def phase_tp(records: list, e2e: dict, smi: str) -> dict:
    """Phase 23: qwen2-1.5b at full width served by two ranks that share
    the card over gloo (NCCL refuses two ranks on one device), against
    the single rank in this process; and phase 30 on the same ranks, its
    (c) replayed here on one rank."""
    torch = _torch()
    from repro_torch.launch.mesh import spawn_world
    t_phase = time.perf_counter()
    f = _tp_kernel_rows()
    single = _tp_single_rank()
    ranks = spawn_world(_tp_rank, TP_RANKS, device="cuda")
    r0, a1 = ranks[0], single["a"]
    out = {"f": f, "single": {k: v for k, v in a1.items()
                              if k not in ("streams", "logits")},
           "ranks": []}
    for k in ("a", "b", "d"):
        for r in ranks[1:]:
            if r[k]["streams"] != r0[k]["streams"]:
                raise AssertionError(f"({k}) a rank's streams differ "
                                     "from rank 0's")
    for name in ("sched", "spec"):
        if any(r["c"][name]["streams"] != r0["c"][name]["streams"]
               for r in ranks[1:]):
            raise AssertionError(f"(c) {name}: a rank's streams differ")
    # (a) against the single rank
    for key in ("admissions", "decode_steps", "syncs", "launches"):
        if any(r["a"][key] != a1[key] for r in ranks):
            raise AssertionError(f"(a) {key}: ranks "
                                 f"{[r['a'][key] for r in ranks]} vs one "
                                 f"rank {a1[key]}")
    errs = {}
    for step in ("prefill", "decode"):
        errs[step] = max(_rel_l2_rows(r["a"]["logits"][step],
                                      a1["logits"][step]) for r in ranks)
        if not errs[step] <= LOGIT_REL_L2:
            raise AssertionError(f"(a) {step} logits 2 ranks vs one: a "
                                 f"row's relative L2 {errs[step]:.3e} > "
                                 f"{LOGIT_REL_L2}")
    pairs = [(x, y) for s, t in zip(r0["a"]["streams"], a1["streams"])
             for x, y in zip(s, t)]
    equal_share = sum(x == y for x, y in pairs) / len(pairs)
    # (b) float32 identity
    if r0["b"]["streams"] != single["b"]["streams"]:
        raise AssertionError("(b) float32 streams: 2 ranks differ from one")
    # phase 30: the ranks' clock decisions, and (c) replayed on one rank
    clk = _clk_check(r0["clk"], ranks,
                     _clk_replay(r0["clk"]["c"]["readings"]), smi)
    # (e) the gather arm's all-gather bytes a decode step
    ag = {"kv_shard": r0["a"]["decode_collectives"]
          ["bytes_per_step_by_op"].get("all-gather/model", 0.0),
          "gather": r0["e"]["decode_collectives"]["bytes_per_step_by_op"]
          .get("all-gather/model", 0.0)}
    if not ag["gather"] >= TP_GATHER_MIN_RATIO * max(ag["kv_shard"], 1.0):
        raise AssertionError(f"(e) all-gather bytes a step {ag}: kv_shard "
                             f"not {TP_GATHER_MIN_RATIO}x below gather")
    for r in ranks:
        out["ranks"].append({
            "a": {k: v for k, v in r["a"].items()
                  if k not in ("streams", "logits")},
            "c": {n: {k: v for k, v in c.items() if k != "streams"}
                  for n, c in r["c"].items()},
            "d": {k: v for k, v in r["d"].items() if k != "streams"},
            "e": r["e"], "wall_s": r["wall_s"], "mesh": r["mesh"],
            "probe": r["probe"], "local_heads": r["local_heads"]})
    out.update(logit_rel_l2=errs, equal_token_share=equal_share,
               all_gather_bytes_per_step=ag, clock=clk)
    for rec in records:
        if rec["name"] in r0["a"]["launches"]:
            rec.setdefault("launches_by_drive", {})["tp_rank0"] = \
                r0["a"]["launches"][rec["name"]]
        if rec["name"] in r0["clk"]["a"]["launches"]:
            rec.setdefault("launches_by_drive", {})["clock_rank0"] = \
                r0["clk"]["a"]["launches"][rec["name"]]
    rows = f["rows"]
    print(f"[23 tp] (f) {smi}: " + "; ".join(f["held"]) + "; " + "; ".join(
        f"{tag} {r['shape']}: ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
        f"sdpa {r['library_ms']:.4f} bound {r['bound_ms']:.4f} "
        f"({r['bound_by']})" for tag, r in rows.items()))
    a0 = r0["a"]
    coll = a0["decode_collectives"]
    print(f"[23 tp] (a) {smi}: {r0['mesh']}, probe {r0['probe']}, rank "
          f"pools / embedding {r0['local_heads']}; 2 ranks: "
          f"{a0['tokens']} tokens, " + ", ".join(
              f"rank {i} {r['a']['tokens_per_s']:.1f} tok/s TTFT p50 "
              f"{r['a']['ttft_p50_s']:.4f}s decode step "
              f"{r['a']['decode_step_wall_ms']:.2f} ms peak "
              f"{r['a']['peak_mem_gb']:.2f} GB" for i, r in
              enumerate(ranks))
          + f"; one rank here {a1['tokens_per_s']:.1f} tok/s TTFT p50 "
          f"{a1['ttft_p50_s']:.4f}s decode step "
          f"{a1['decode_step_wall_ms']:.2f} ms (phase 5: "
          f"{e2e['tokens_per_s']:.1f} tok/s, TTFT p50 "
          f"{e2e['ttft_p50_s']:.4f}s); {a0['admissions']} admissions + "
          f"{a0['decode_blocks']} blocks = {a0['syncs']} syncs, "
          f"{a0['decode_steps']} steps as one rank's; launches per rank "
          f"{[r['a']['launches'] for r in ranks]}; logits vs one rank "
          f"(worst row's relative L2, limit {LOGIT_REL_L2}) prefill "
          f"{errs['prefill']:.3e} decode {errs['decode']:.3e}; equal "
          f"tokens {equal_share:.4f}; collectives a decode step "
          f"{coll['count_by_op']} calls / {a0['decode_steps']} steps, "
          f"bytes a step {coll['bytes_per_step_by_op']} (total "
          f"{coll['total_bytes_per_step']:.0f})")
    print(f"[23 tp] (b) float32 {TP_F32_LAYERS} layers: "
          f"{len(r0['b']['streams'])} streams of 2 ranks equal one rank's "
          "token for token")
    for name, c in r0["c"].items():
        print(f"[23 tp] (c) {name}: streams equal on both ranks, launches "
              f"per rank {[r['c'][name]['launches'] for r in ranks]}, "
              f"{c['cont_dispatches']} continuation chunks"
              + (f", {c['verify_rounds']} verify rounds, acceptance "
                 f"{c['acceptance_rate']:.3f}" if name == "spec" else "")
              + (f", prefix hits {c['prefix_hit_tokens']} tokens"
                 if name == "sched" else ""))
    d0 = r0["d"]
    print(f"[23 tp] (d) int8 weights + int8 pools: {d0['tokens']} tokens "
          f"({d0['tokens_per_s']:.1f} tok/s), launches per rank "
          f"{[r['d']['launches'] for r in ranks]}; every B4 / B5 call of "
          f"one admission {d0['bit_equal_calls']['admission']} and one "
          f"decode step {d0['bit_equal_calls']['decode']} bit-equal to its "
          f"plain version on each rank, shapes "
          f"{d0['bit_equal_calls']['shapes']}")
    print(f"[23 tp] (e) all-gather bytes a decode step: kv_shard "
          f"{ag['kv_shard']:.0f}, gather {ag['gather']:.0f} "
          f"({ag['gather'] / max(ag['kv_shard'], 1.0):.1f}x; limit "
          f"{TP_GATHER_MIN_RATIO}x), gather arm collectives "
          f"{r0['e']['decode_collectives']['bytes_per_step_by_op']} over "
          f"{r0['e']['pages']} pages")
    out["phase_wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    print(f"[23 tp] phase {out['phase_wall_s']:.1f}s (ranks "
          f"{[round(r['wall_s'], 1) for r in ranks]}s)")
    return out


# ---------------------------------------------------------------------------
# phase 30: host decisions that read the clock, on phase 23's two ranks

CLK_SKEW_S = 3600.0          # rank 1's own clock: an hour ahead and
CLK_SKEW_RATE = 1.5          # running 1.5x as fast
CLK_REPEATS = 2              # (a), (c): phase 23 (c)'s 4 prompts, twice
CLK_NEW = 16                 # (a), (c): new tokens a request
CLK_RATE = 20.0              # (a), (c): Poisson arrivals a second
#: (a), (c): each arrival's TTFT target in turn: relaxed, relaxed, one
#: no prefill meets (admission control drops it), one that EDF puts
#: ahead of the relaxed ones queued before it
CLK_SLOS = (60.0, 60.0, 1e-4, 20.0)
CLK_SLO_TTFT = 1.0           # (a), (c): the ladder's TTFT target
CLK_SLO_TPOT = 0.5
CLK_MAX_REQUEST_S = 60.0
CLK_SLOTS = 2
CLK_PAGES = 5                # (a), (c): the null page and 4 of 256: a
                             # 512- and a 768-token request that share
                             # their prefix do not fit at once (preemption)
CLK_SPEC_SLO_TTFT = 4.0      # (b): the engine's TTFT target, and the
CLK_SPEC_SLACK_S = 2.0       # slack that turns speculation off
CLK_SPEC_CHAOS = "seed=0,fault=0.1,draft=0.2"
CLK_F32_CHAOS = "seed=0,oom=0.05,fault=0.1"
CLK_RETRIES = 50             # (b), (c): faults are recovered, not failed
CLK_RANK_S = 30.0            # phase 30's wall a rank


def _clk_clock(rank: int):
    """Rank 1's ``serve.engine.host_clock`` skewed (``CLK_SKEW_S`` ahead,
    ``CLK_SKEW_RATE`` as fast); rank 0's recorded, each reading with the
    host-loop function that took it.  Returns (readings, sites, the real
    clock to put back)."""
    from repro_torch.serve import engine as se
    real = se.host_clock
    readings, sites = [], []
    if rank == 0:
        def clock():
            t = real()
            f = sys._getframe(1)
            while f.f_code.co_name in ("shared_clock", "_clock"):
                f = f.f_back
            readings.append(t)
            sites.append(f.f_code.co_name)
            return t
    else:
        t0 = real()

        def clock():
            return CLK_SKEW_S + t0 + CLK_SKEW_RATE * (real() - t0)
    se.host_clock = clock
    return readings, sites, real


def _clk_prompts(vocab: int) -> list:
    """(a), (c): phase 23 (c)'s shared-prefix prompts, ``CLK_REPEATS``
    times over (the repeats hit the prefix cache)."""
    return _tp_shared_prompts(vocab) * CLK_REPEATS


def _clk_sched(lm, params, mesh, tracer, chaos=None):
    """(a) / (c)'s SchedEngine: EDF with admission control, TTFT / TPOT
    targets, the ladder, deadlines, the prefix cache, chunks of 512 and
    blocks of 8, on a pool that a 512- and a 768-token request sharing
    their prefix overflow."""
    from repro_torch.resil import FaultInjector
    from repro_torch.sched import SchedEngine
    return SchedEngine(
        lm, params, policy="edf", admission_control=True,
        slo_ttft=CLK_SLO_TTFT, slo_tpot=CLK_SLO_TPOT, ladder=True,
        max_request_s=CLK_MAX_REQUEST_S, prefix_cache=True,
        prefill_chunk=512, decode_block=8, n_slots=CLK_SLOTS, max_len=1024,
        page_size=256, n_pages=CLK_PAGES, seed=SEED, mesh=mesh,
        tracer=tracer, max_retries=CLK_RETRIES,
        injector=FaultInjector.from_spec(chaos))


def _clk_open_loop(eng, tracer, prompts, tag: str, sites=None) -> dict:
    """Serve ``prompts`` open loop (Poisson offsets from ``SEED + 30``)
    with ``CLK_SLOS`` in turn, the launch counts zeroed just before and
    read just after: the streams, outcomes, first admissions in order,
    the ladder's rung after every tick, the dispatches and their
    launches (B2 = L x continuation chunks, B3 = L x fresh chunks, B1 =
    L x decode steps, B7 = (2L + 1) x forwards) and host syncs (the
    dispatches plus the decode blocks), and the shared clock's readings
    (on rank 0 by the function that took them)."""
    torch = _torch()
    import numpy as np
    from repro_torch.serve.engine import run_open_loop
    cfg = eng.lm.cfg
    admits, rungs = [], []
    admit_one, step, submit = eng._admit_one, eng.step, eng.submit
    slos = iter(CLK_SLOS * len(prompts))

    def admit(req, now):
        ok = admit_one(req, now)
        if ok:
            admits.append(req.rid)
        return ok

    def tick():
        out = step()
        rungs.append(eng.ladder.rung)
        return out

    def submit_slo(p, **kw):
        return submit(p, slo_ttft=next(slos), **kw)

    recoveries = []

    def counted(fn):
        def recover(err, now):
            recoveries.append(type(err).__name__)
            return fn(err, now)
        return recover
    eng._admit_one, eng.step, eng.submit = admit, tick, submit_slo
    eng._recover_transient = counted(eng._recover_transient)
    eng._recover_oom = counted(eng._recover_oom)
    base = _counts(eng, tracer, 0)
    n_ev = len(tracer.events)
    n_sites = len(sites) if sites is not None else 0
    coll0 = eng.mesh.stats.copy() if eng.mesh is not None else None
    offsets = np.cumsum(np.random.default_rng(SEED + 30).exponential(
        1.0 / CLK_RATE, len(prompts)))
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    ids = run_open_loop(eng, prompts, offsets, max_new_tokens=CLK_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    now = _counts(eng, tracer, n_ev)
    steps, blocks = now["steps"] - base["steps"], now["blocks"] - base[
        "blocks"]
    syncs = now["syncs"] - base["syncs"]
    layers = cfg.num_layers
    want = {"paged_prefix_extend": layers * now["cont"],
            "flash_attention": layers * now["fresh"],
            "paged_attention": layers * steps,
            "rmsnorm": (2 * layers + 1) * (now["cont"] + now["fresh"]
                                           + steps)}
    got = {k: launches[k] for k in want}
    if got != want or syncs != now["cont"] + now["fresh"] + blocks:
        raise AssertionError(f"{tag}: launches {got} != {want}, or {syncs} "
                             f"syncs != {now['cont']} + {now['fresh']} "
                             f"chunks + {blocks} blocks")
    reqs = [eng.registry[i] for i in ids]
    for r in reqs:
        if r.outcome == "ok" and (len(r.out_tokens) != CLK_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens)):
            raise AssertionError(f"{tag}: request {r.rid} ok with "
                                 f"{len(r.out_tokens)} tokens, want "
                                 f"{CLK_NEW}, or a token out of vocab")
    ttft = [r.t_first - r.t_submit for r in reqs if r.t_first is not None]
    out = {"streams": [list(r.out_tokens) for r in reqs],
           "outcomes": [r.outcome for r in reqs],
           "admits": admits, "rungs": rungs, "ticks": len(rungs),
           "recoveries": len(recoveries),
           "slo_rejected": eng.stats.slo_rejected,
           "preemptions": eng.stats.preemptions,
           "prefix_hit_tokens": eng.stats.prefix_hit_tokens,
           "cont_dispatches": now["cont"], "fresh_dispatches": now["fresh"],
           "decode_blocks": blocks, "decode_steps": steps, "syncs": syncs,
           "launches": got, "wall_s": wall,
           "tick_wall_ms": wall / max(len(rungs), 1) * 1e3,
           "ttft_p50_s": statistics.median(ttft) if ttft else None,
           "injected": (dict(eng.injector.counts)
                        if eng.injector is not None else None)}
    if coll0 is not None:
        out["shared_readings"] = eng.mesh.stats.since(
            coll0).count_by_op.get("broadcast/clock", 0)
    if sites is not None:
        mine = sites[n_sites:]
        out["sites"] = {k: mine.count(k) for k in sorted(set(mine))}
    return out


def _clk_spec(lm, params, mesh, tracer, prompts, tag: str,
              sites=None) -> dict:
    """(b): the n-gram SpecEngine (k 4) under EDF with ``spec_slack_s``
    and chaos (faults, mangled drafts), the prompts submitted at once on
    two slots; streams, outcomes, injected faults, verify rounds and the
    launches (B2 = L x (continuations + verify rounds), B3 = L x fresh
    chunks, B1 = L x fallback decode steps, B7 = (2L + 1) x forwards)."""
    torch = _torch()
    from repro_torch.resil import FaultInjector
    from repro_torch.spec import SpecEngine
    eng = SpecEngine(lm, params, spec="ngram", draft_k=4, policy="edf",
                     slo_ttft=CLK_SPEC_SLO_TTFT,
                     spec_slack_s=CLK_SPEC_SLACK_S, prefix_cache=True,
                     prefill_chunk=512, decode_block=8, n_slots=CLK_SLOTS,
                     max_len=1024, page_size=256, seed=SEED, mesh=mesh,
                     tracer=tracer, max_retries=CLK_RETRIES,
                     injector=FaultInjector.from_spec(CLK_SPEC_CHAOS))
    n_sites = len(sites) if sites is not None else 0
    _reset_launches()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=CLK_NEW) for p in prompts]
    eng.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    d = _spec_counts(eng, tracer, 0)
    layers = eng.lm.cfg.num_layers
    want = {"paged_prefix_extend": layers * (d["cont"] + d["verify"]),
            "flash_attention": layers * d["fresh"],
            "paged_attention": layers * d["steps"],
            "rmsnorm": (2 * layers + 1) * (d["cont"] + d["fresh"]
                                           + d["verify"] + d["steps"])}
    got = {k: launches[k] for k in want}
    if got != want or d["syncs"] != d["cont"] + d["fresh"] + d["verify"] \
            + d["blocks"] or d["verify"] <= 0:
        raise AssertionError(f"{tag}: launches {got} != {want}, or "
                             f"{d['syncs']} syncs != chunks + verify rounds "
                             f"+ blocks, or {d['verify']} verify rounds")
    reqs = [eng.registry[i] for i in ids]
    st = eng.spec_stats
    out = {"streams": [list(r.out_tokens) for r in reqs],
           "outcomes": [r.outcome for r in reqs],
           "injected": dict(eng.injector.counts),
           "verify_rounds": st.verify_steps,
           "skipped_urgent": st.skipped_urgent,
           "fallback_blocks": d["blocks"], "cont_dispatches": d["cont"],
           "fresh_dispatches": d["fresh"], "syncs": d["syncs"],
           "launches": got, "wall_s": wall}
    if sites is not None:
        mine = sites[n_sites:]
        out["sites"] = {k: mine.count(k) for k in sorted(set(mine))}
    return out


def _clk_rank(rank: int, lm, params, mesh) -> dict:
    """Phase 30 (a) and (b) in one rank of phase 23, at full width."""
    from repro_torch.obs import Tracer
    from repro_torch.serve import engine as se
    t0 = time.perf_counter()
    readings, sites, real = _clk_clock(rank)
    try:
        prompts = _clk_prompts(lm.cfg.vocab_size)
        tracer = Tracer(enabled=True)
        eng = _clk_sched(lm, params, mesh, tracer)
        a = _clk_open_loop(eng, tracer, prompts, f"rank {rank} (a)",
                           sites if rank == 0 else None)
        a["readings"] = len(readings)
        del eng
        b = _clk_spec(lm, params, mesh, Tracer(enabled=True),
                      prompts[:len(prompts) // CLK_REPEATS],
                      f"rank {rank} (b)", sites if rank == 0 else None)
    finally:
        se.host_clock = real
    return {"a": a, "b": b, "wall_s": time.perf_counter() - t0}


def _clk_f32(rank, flm, fparams, mesh) -> dict:
    """Phase 30 (c) in one rank: (a)'s drive at float32 and 4 layers,
    with chaos; rank 0's readings kept for the replay on one rank."""
    from repro_torch.obs import Tracer
    from repro_torch.serve import engine as se
    t0 = time.perf_counter()
    readings, sites, real = _clk_clock(rank)
    try:
        tracer = Tracer(enabled=True)
        eng = _clk_sched(flm, fparams, mesh, tracer, CLK_F32_CHAOS)
        c = _clk_open_loop(eng, tracer, _clk_prompts(flm.cfg.vocab_size),
                           f"rank {rank} (c)")
    finally:
        se.host_clock = real
    c["readings"] = readings if rank == 0 else None
    c["wall_s"] = time.perf_counter() - t0
    return c


def _clk_replay(readings: list) -> dict:
    """Phase 30 (c) on one rank in this process, its ``host_clock``
    returning rank 0's readings in order."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.obs import Tracer
    from repro_torch.serve import engine as se
    cfg = get_config("qwen2-1.5b").with_(num_layers=TP_F32_LAYERS,
                                        dtype="float32")
    flm = LM(cfg, device="cuda")
    it = iter(readings)
    real, used = se.host_clock, []

    def replay():
        t = next(it, None)
        if t is None:
            raise AssertionError(f"(c) the replay read the clock more than "
                                 f"the {len(readings)} times rank 0 did")
        used.append(t)
        return t
    se.host_clock = replay
    try:
        tracer = Tracer(enabled=True)
        eng = _clk_sched(flm, flm.init(SEED), None, tracer, CLK_F32_CHAOS)
        out = _clk_open_loop(eng, tracer, _clk_prompts(cfg.vocab_size),
                             "one rank (c)")
    finally:
        se.host_clock = real
    out["replayed"] = len(used)
    return out


def _clk_check(r0: dict, ranks: list, replay: dict, smi: str) -> dict:
    """Phase 30's bars: every rank's (a), (b) and (c) equal rank 0's;
    (a) shows an EDF reorder, an admission drop, a rung above 0 and a
    timeout or a preemption, its launches as one rank's formulas, its
    readings as predicted (one a request, a tick, a dispatch and an
    open-loop iteration, every one shared); (c) replayed on one rank
    equal to the ranks."""
    same_a = ("streams", "outcomes", "admits", "rungs", "slo_rejected",
              "preemptions", "syncs", "launches", "decode_steps",
              "cont_dispatches", "fresh_dispatches", "shared_readings")
    same_b = ("streams", "outcomes", "injected", "verify_rounds", "syncs",
              "launches")
    same_c = ("streams", "outcomes", "syncs", "rungs", "injected", "admits")
    for i, r in enumerate(ranks[1:], 1):
        for part, keys in (("a", same_a), ("b", same_b), ("c", same_c)):
            diff = [k for k in keys if r["clk"][part][k] != r0[part][k]]
            if diff:
                raise AssertionError(f"[30] ({part}) rank {i}'s {diff} "
                                     "differ from rank 0's")
    diff = [k for k in same_c if replay[k] != r0["c"][k]]
    if diff or replay["replayed"] != len(r0["c"]["readings"]):
        raise AssertionError(f"[30] (c) one rank on rank 0's clock: {diff} "
                             f"differ, {replay['replayed']} of "
                             f"{len(r0['c']['readings'])} readings used")
    a = r0["a"]
    firsts = list(dict.fromkeys(a["admits"]))
    shown = {"edf_reorder": firsts != sorted(firsts),
             "admission_drop": a["slo_rejected"] > 0,
             "rung_above_0": max(a["rungs"]) > 0,
             "timeout_or_preemption": a["preemptions"] > 0
             or "timed_out" in a["outcomes"]}
    sites, n_req = a["sites"], len(a["streams"])
    want = {"submit": n_req, "step": a["ticks"] + a["recoveries"],
            "_dispatch_chunks": a["cont_dispatches"] + a["fresh_dispatches"],
            "_dispatch_decode": a["decode_blocks"]}
    walls = [round(r["clk"]["wall_s"] + r["clk"]["c"]["wall_s"], 1)
             for r in ranks]
    if max(walls) > CLK_RANK_S:
        print(f"[30 clock] phase 30 took {walls}s a rank, over "
              f"{CLK_RANK_S}s")
    b = r0["b"]
    print(f"[30 clock] (a) {smi}: qwen2-1.5b full width, 2 ranks, EDF + "
          f"admission control + ladder + deadlines, {n_req} requests open "
          f"loop at {CLK_RATE}/s: outcomes {a['outcomes']}, first "
          f"admissions {firsts}, rungs {a['rungs']}, slo_rejected "
          f"{a['slo_rejected']}, preemptions {a['preemptions']}; shown "
          f"{shown}; equal on both ranks (rank 1 skewed {CLK_SKEW_S}s, "
          f"x{CLK_SKEW_RATE}); {a['cont_dispatches']} + "
          f"{a['fresh_dispatches']} chunks + {a['decode_blocks']} blocks = "
          f"{a['syncs']} syncs; launches per rank "
          f"{[r['clk']['a']['launches'] for r in ranks]}; readings {sites} "
          f"= {a['readings']}, all shared, {a['readings'] / a['ticks']:.2f} "
          f"a tick over {a['ticks']} ticks; tick wall " + ", ".join(
              f"rank {i} {r['clk']['a']['tick_wall_ms']:.1f} ms TTFT p50 "
              f"{r['clk']['a']['ttft_p50_s']:.4f}s" for i, r in
              enumerate(ranks)))
    print(f"[30 clock] (b) spec n-gram + EDF + spec_slack "
          f"{CLK_SPEC_SLACK_S}s + chaos '{CLK_SPEC_CHAOS}': outcomes "
          f"{b['outcomes']}, injected {b['injected']}, {b['verify_rounds']} "
          f"verify rounds, {b['skipped_urgent']} urgent skips, "
          f"{b['fallback_blocks']} fallback blocks, readings {b['sites']}; "
          f"launches per rank {[r['clk']['b']['launches'] for r in ranks]}, "
          "equal on both ranks")
    c = r0["c"]
    print(f"[30 clock] (c) float32 {TP_F32_LAYERS} layers + chaos "
          f"'{CLK_F32_CHAOS}': outcomes {c['outcomes']}, injected "
          f"{c['injected']}, rungs {c['rungs']}, {c['syncs']} syncs; one "
          f"rank replaying rank 0's {len(c['readings'])} readings: the same "
          f"streams, outcomes, syncs, rungs and faults; phase 30 {walls}s a "
          "rank")
    loops = sites.get("run_open_loop", 0)
    if any(sites.get(k, 0) != v for k, v in want.items()) \
            or loops < a["ticks"] + 1 \
            or set(sites) - set(want) - {"run_open_loop"} \
            or a["shared_readings"] != a["readings"]:
        raise AssertionError(f"[30] (a) clock readings {sites} "
                             f"({a['shared_readings']} shared of "
                             f"{a['readings']}) != the prediction {want} + "
                             f"run_open_loop >= {a['ticks'] + 1}")
    if not all(shown.values()):
        raise AssertionError(f"[30] (a) did not show {shown}")
    return {"a": {k: v for k, v in a.items() if k != "streams"},
            "b": {k: v for k, v in b.items() if k != "streams"},
            "c": {k: v for k, v in c.items()
                  if k not in ("streams", "readings")},
            "shown": shown, "walls_s": walls,
            "ranks": [{"a": {k: r["clk"]["a"][k] for k in
                             ("tick_wall_ms", "ttft_p50_s", "wall_s")}}
                      for r in ranks]}


# ---------------------------------------------------------------------------
# phase 24: sharded training, two ranks sharing the card

TRAIN_TP_RANKS = 2
TRAIN_TP_STEPS = 2
TRAIN_TP_LR, TRAIN_TP_WARMUP = 3e-4, 20   # launch.train's defaults
TRAIN_TP_LOSS_RTOL = 2e-2      # (a), (b): bf16, each step vs one rank's
TRAIN_TP_F32_LAYERS = 2        # (c): float32 at full width
TRAIN_TP_GRAD_REL_L2 = 1e-4    # (c): every leaf's first-step gradient
TRAIN_TP_F32_LOSS_RTOL = 1e-5  # (c): each step's loss


def _train_tp_cli(n: int, tmp: Path) -> dict:
    """(a) ``python -m repro_torch.launch.train --arch llama3.2-1b
    --model-parallel n`` (its ``main``, in this process) at full width
    and depth, bf16, TRAIN_TP_STEPS steps of phase 20's batch: rank 0's
    history, its output and every rank's report (one rank: this
    process's figures)."""
    import contextlib
    import io
    torch = _torch()
    from repro_torch.launch import train as train_cli
    hist = tmp / f"a{n}_history.json"
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_TP_STEPS),
            "--global-batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
            "--lr", str(TRAIN_TP_LR), "--warmup", str(TRAIN_TP_WARMUP),
            "--log-every", "1", "--seed", str(SEED), "--history-out",
            str(hist), "--model-parallel", str(n)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _no_launches(f"(a) launch.train --model-parallel {n}")
    text = buf.getvalue()
    h = json.loads(hist.read_text())
    losses = [r["loss"] for r in h]
    if rc != 0 or len(h) != TRAIN_TP_STEPS:
        raise AssertionError(f"(a) --model-parallel {n}: rc {rc}, {len(h)} "
                             f"history rows")
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"(a) --model-parallel {n}: non-finite loss "
                             f"{losses}")
    reports = [json.loads(ln.split(" report ", 1)[1])
               for ln in text.splitlines() if ln.startswith("[train] rank ")]
    if n == 1:
        p50 = statistics.median(r["dt"] for r in h)
        reports = [{"step_p50_s": p50,
                    "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / p50,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "kernel_launches": sum(launches.values()),
                    "collectives_a_step": {}}]
    mesh_line = [ln for ln in text.splitlines() if "[train] mesh" in ln]
    if n > 1 and (len(reports) != n or not mesh_line):
        raise AssertionError(f"(a) --model-parallel {n}: {len(reports)} "
                             f"rank reports, mesh line {mesh_line}")
    if any(r["kernel_launches"] for r in reports):
        raise AssertionError(f"(a) kernel launches in a training rank: "
                             f"{[r['kernel_launches'] for r in reports]}")
    return {"losses": losses, "ranks": reports, "wall_s": wall,
            "mesh": mesh_line[0][8:] if mesh_line else None}


def _train_tp_reports(tr, torch) -> dict:
    """A rank's figures after ``tr.run``, as ``launch.train`` reports
    them."""
    p50 = statistics.median(tr.step_times)
    n = max(tr.steps_run, 1)
    st = tr.step_collectives
    return {"step_p50_s": p50,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / p50,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "collectives_a_step": {k: [st.count_by_op[k] / n,
                                       st.bytes_by_op[k] / n]
                                   for k in sorted(st.count_by_op)
                                   if st.count_by_op[k]}}


def _train_tp_f32(mesh, fsdp: bool, one: dict) -> dict:
    """(c) on ``mesh``: float32 llama3.2-1b at TRAIN_TP_F32_LAYERS layers
    of full width; the first batch's gradient gathered whole against one
    rank's (``one``, computed in this rank) leaf by leaf, then
    TRAIN_TP_STEPS steps' losses."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.sharding.rules import gather_leaf, make_param_specs
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = get_config(TRAIN_ARCH).with_(num_layers=TRAIN_TP_F32_LAYERS,
                                       dtype="float32")
    specs = make_param_specs(LM(cfg, device="meta").init(torch.Generator()),
                             mesh, fsdp=True) if fsdp else None
    tr = Trainer(LM(cfg, device="cuda"),
                 SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                 seed=SEED),
                 lr=cosine_schedule(TRAIN_TP_LR, TRAIN_TP_WARMUP,
                                    TRAIN_TP_STEPS), mesh=mesh,
                 param_specs=specs, log_every=1, log_fn=_train_quiet)
    tr.init_or_resume(SEED)
    pieces, _ = tr._step_fn.compute_grads(tr.params, one["batch"])
    whole = tree_map(lambda g, s: gather_leaf(g, s, mesh), pieces, tr.specs)
    want = dict(leaves_with_path(one["grads"]))
    errs = {}
    for path, g in leaves_with_path(whole):
        w = want[path]
        den = float(w.norm())
        errs[path] = float((g - w).norm()) / den if den else float(g.norm())
    del pieces, whole
    worst = max(errs, key=errs.get)
    if not errs[worst] <= TRAIN_TP_GRAD_REL_L2:
        raise AssertionError(f"(c) {mesh.describe()}: gradient of {worst} "
                             f"relative L2 {errs[worst]:.3e} > "
                             f"{TRAIN_TP_GRAD_REL_L2}")
    losses = [r["loss"] for r in tr.run(TRAIN_TP_STEPS)]
    for step, (a, b) in enumerate(zip(losses, one["losses"])):
        if not abs(a - b) <= TRAIN_TP_F32_LOSS_RTOL * abs(b):
            raise AssertionError(f"(c) {mesh.describe()}: step {step + 1} "
                                 f"loss {a} vs one rank's {b}")
    return {"mesh": mesh.describe(), "leaves": len(errs),
            "worst_leaf": worst, "worst_rel_l2": errs[worst],
            "losses": losses}


def _train_tp_one_f32() -> dict:
    """(c)'s single rank, computed in each rank: the first batch, its
    gradient and TRAIN_TP_STEPS steps' losses."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.train.loop import Trainer, loss_and_grads
    cfg = get_config(TRAIN_ARCH).with_(num_layers=TRAIN_TP_F32_LAYERS,
                                       dtype="float32")
    lm = LM(cfg, device="cuda")
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in
             SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                             seed=SEED).next_batch().items()}
    _, _, grads = loss_and_grads(lm, lm.init(SEED), batch)
    tr = Trainer(lm, SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                     seed=SEED),
                 lr=cosine_schedule(TRAIN_TP_LR, TRAIN_TP_WARMUP,
                                    TRAIN_TP_STEPS), log_every=1,
                 log_fn=_train_quiet)
    tr.init_or_resume(SEED)
    losses = [r["loss"] for r in tr.run(TRAIN_TP_STEPS)]
    return {"batch": batch, "grads": grads, "losses": losses}


def _train_tp_rank(rank: int) -> dict:
    """One of the two ranks of phase 24 (b) and (c), on the card the
    parent holds: (b) llama3.2-1b at full width and depth, bf16, over a
    data axis of 2 with FSDP at the default minimum size, each rank 4 of
    the 8 rows; (c) float32 at 2 layers over (a)'s mesh (model 2) and
    (b)'s, against one rank's gradient and losses."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.sharding.rules import make_param_specs
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    data = make_host_mesh(model=1, device="cuda")
    model = make_host_mesh(model=TRAIN_TP_RANKS, device="cuda")
    out = {"mesh_b": data.describe()}
    # (b)
    cfg = get_config(TRAIN_ARCH)
    specs = make_param_specs(LM(cfg, device="meta").init(torch.Generator()),
                             data, fsdp=True)
    tr = Trainer(LM(cfg, device="cuda"),
                 SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                 seed=SEED),
                 lr=cosine_schedule(TRAIN_TP_LR, TRAIN_TP_WARMUP,
                                    TRAIN_TP_STEPS), mesh=data,
                 param_specs=specs, log_every=1, log_fn=_train_quiet)
    tr.init_or_resume(SEED)
    split = sum("data" in s for s in leaves(specs))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    hist = tr.run(TRAIN_TP_STEPS)
    out["b"] = dict(_train_tp_reports(tr, torch),
                    losses=[r["loss"] for r in hist],
                    launches=_no_launches(f"rank {rank} (b)"),
                    rows=TRAIN_BATCH // data.data, split_leaves=split,
                    param_count=tr.param_count())
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # (c)
    _reset_launches()
    one = _train_tp_one_f32()
    out["c"] = {"model2": _train_tp_f32(model, False, one),
                "data2_fsdp": _train_tp_f32(data, True, one),
                "one_rank_losses": one["losses"]}
    out["c"]["launches"] = _no_launches(f"rank {rank} (c)")
    del one
    out["wall_s"] = time.perf_counter() - t_start
    return out


def _coll_line(c: dict) -> str:
    return ", ".join(f"{k} {v[0]:g} x {v[1] / 1e6:.1f} MB"
                     for k, v in c.items())


def phase_train_tp(smi: str) -> dict:
    """Phase 24: llama3.2-1b trained by two ranks that share the card over
    gloo, against one rank in this process: (a) ``launch.train
    --model-parallel 2``, (b) a data axis of 2 with FSDP, (c) float32 at
    2 layers over both meshes, gradient and losses."""
    import shutil
    import tempfile
    torch = _torch()
    from repro_torch.launch.mesh import spawn_world
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_tp_"))
    try:
        one = _train_tp_cli(1, tmp)
        two = _train_tp_cli(TRAIN_TP_RANKS, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    worst = {}
    worst["a"] = max(abs(a - b) / abs(b)
                     for a, b in zip(two["losses"], one["losses"]))
    if not worst["a"] <= TRAIN_TP_LOSS_RTOL:
        raise AssertionError(f"(a) losses {two['losses']} vs one rank's "
                             f"{one['losses']}: {worst['a']:.3e} > "
                             f"{TRAIN_TP_LOSS_RTOL}")
    ranks = spawn_world(_train_tp_rank, TRAIN_TP_RANKS, device="cuda")
    r0 = ranks[0]
    if any(r["b"]["losses"] != r0["b"]["losses"] for r in ranks):
        raise AssertionError("(b) the ranks report different losses")
    worst["b"] = max(abs(a - b) / abs(b)
                     for a, b in zip(r0["b"]["losses"], one["losses"]))
    if not worst["b"] <= TRAIN_TP_LOSS_RTOL:
        raise AssertionError(f"(b) losses {r0['b']['losses']} vs one "
                             f"rank's {one['losses']}: {worst['b']:.3e} > "
                             f"{TRAIN_TP_LOSS_RTOL}")
    a1 = one["ranks"][0]
    print(f"[24 train_tp] (a) {smi}: launch.train --model-parallel "
          f"{TRAIN_TP_RANKS}, {two['mesh']}, {TRAIN_ARCH} 16L bf16, "
          f"{TRAIN_TP_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ}: losses "
          f"{[round(v, 5) for v in two['losses']]} vs one rank's "
          f"{[round(v, 5) for v in one['losses']]} (worst relative "
          f"{worst['a']:.3e}, limit {TRAIN_TP_LOSS_RTOL}); " + "; ".join(
              f"rank {i} step wall p50 {r['step_p50_s'] * 1e3:.1f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, peak {r['peak_gb']:.2f} "
              f"GB, collectives a step {_coll_line(r['collectives_a_step'])}"
              for i, r in enumerate(two["ranks"]))
          + f"; one rank step wall p50 {a1['step_p50_s'] * 1e3:.1f} ms, "
          f"{a1['tokens_per_s']:.0f} tokens/s, peak {a1['peak_gb']:.2f} GB;"
          f" kernel launches 0")
    b0 = r0["b"]
    print(f"[24 train_tp] (b) {smi}: {r0['mesh_b']}, FSDP at the default "
          f"minimum size ({b0['split_leaves']} leaves split over data), "
          f"{b0['rows']} of {TRAIN_BATCH} rows a rank, 16L bf16, "
          f"{TRAIN_TP_STEPS} steps: losses "
          f"{[round(v, 5) for v in b0['losses']]} (worst relative vs one "
          f"rank {worst['b']:.3e}); " + "; ".join(
              f"rank {i} step wall p50 {r['b']['step_p50_s'] * 1e3:.1f} ms,"
              f" {r['b']['tokens_per_s']:.0f} tokens/s, peak "
              f"{r['b']['peak_gb']:.2f} GB, collectives a step "
              f"{_coll_line(r['b']['collectives_a_step'])}"
              for i, r in enumerate(ranks)) + "; kernel launches 0")
    c0 = r0["c"]
    print(f"[24 train_tp] (c) float32 {TRAIN_TP_F32_LAYERS} layers: "
          + "; ".join(f"{c0[k]['mesh']}: {c0[k]['leaves']} leaves' first-"
                      f"step gradients, worst {c0[k]['worst_leaf']} "
                      f"{c0[k]['worst_rel_l2']:.3e} (limit "
                      f"{TRAIN_TP_GRAD_REL_L2}), losses "
                      f"{c0[k]['losses']}" for k in ("model2", "data2_fsdp"))
          + f"; one rank's {c0['one_rank_losses']} (limit "
          f"{TRAIN_TP_F32_LOSS_RTOL} relative); kernel launches 0")
    out = {"a": {"one": one, "two": two}, "ranks": ranks,
           "worst_loss_rel": worst,
           "phase_wall_s": time.perf_counter() - t_phase}
    torch.cuda.empty_cache()
    print(f"[24 train_tp] phase {out['phase_wall_s']:.1f}s (ranks "
          f"{[round(r['wall_s'], 1) for r in ranks]}s)")
    return out


# ---------------------------------------------------------------------------
# phase 25: MoE, fp8 / int4 weights and adapters under a model axis

TPM_RANKS = 2
TPM_HEADS = (12, 4, 64)      # granite's heads on one of two ranks
#: B6 at qwen2-1.5b's rank linears: (K, N, out dtype) of the column-split
#: gate / up and the row-split down (an fp32 partial, no bias), M 8
TPM_B6 = ((1536, 4480, "bfloat16"), (4480, 1536, "float32"))
TPM_B6_M = 8
TPM_REQUESTS = 2             # (a): phase 19's engine, 64-512-token prompts
TPM_GATHER_STEPS = 2         # (b)
TPM_F32_LAYERS = 2           # (c)
TPM_F32_REL_L2 = 1e-3        # (a): float32 logits, 2 ranks vs one, a row
#: (a): bf16 logits on these seeds, each row of 2 ranks' within
#: TPM_WITNESS_FACTOR times the worst row of one rank's summation-order
#: witness (``_moe_rank_combine``) from one rank's: the ratio read
#: 1.13-1.42 on the two seeds' prefill and decode logits
TPM_SEEDS = (SEED, SEED + 1)
TPM_WITNESS_FACTOR = 2.0
TPM_Q_REQUESTS, TPM_Q_NEW = 4, 4     # (d)
TPM_LORA_RANK = 16           # (e)


def _without_arrays(d):
    """``d`` without its logits and streams (for the JSON summary)."""
    if isinstance(d, dict):
        return {k: _without_arrays(v) for k, v in d.items()
                if not str(k).startswith(("logits", "streams"))}
    if isinstance(d, list):
        return [_without_arrays(v) for v in d]
    return d


def _tpm_b6_row(k: int, n: int, out: str, g, device) -> tuple:
    """B6 at M TPM_B6_M over a (K, N) fp8 linear with ``out`` output (no
    bias for an fp32 partial, a bf16 bias else): element by element
    against its plain version on the CPU copy, then timed beside it, a
    bf16 product over the dequantized weight (the library call) and the
    bound (``_qmm_times``)."""
    torch = _torch()
    from repro_torch.kernels.int8_matmul import ops as qmm
    from repro_torch.kernels.int8_matmul.ref import fp8_decode_ref
    odt = getattr(torch, out)
    m, partial = TPM_B6_M, out == "float32"
    qw, ws, b = _qlinear(g, device, k, n, "fp8")
    b = None if partial else b
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    tc0 = qmm.fp8_tc_launches
    got = qmm.fp8_matmul_decode(x, qw, ws, bias=b, out_dtype=odt).cpu()
    step = _step_tag(qmm.fp8_tc_launches - tc0, True)
    ref = fp8_decode_ref(_cpu(x), _cpu(qw), _cpu(ws), _cpu(b), odt)
    line = check_close(f"6t B6 M{m} K{k} N{n} {out} out{step}", got, ref,
                       ref.float().pow(2).mean().sqrt().item())
    times = _qmm_times("B6", m, k, n, g, device, out_dtype=odt,
                       bias=not partial)
    return line, {
        "shape": f"M{m} K{k} N{n}, {out} out, "
        + ("no bias" if partial else "bf16 bias"),
        "max_abs_err": (got.float() - ref.float()).abs().max().item(),
        **{key: times[key] for key in ("ms", "plain_ms", "library_ms",
                                       "bound_ms", "bound_by")}}


def _tpm_kernel_rows() -> dict:
    """(f): B1 and B3 at granite's rank heads (12 over 4, D 64: a group of
    3) on phases 3 / 4's cases, and B6 at qwen2's rank linears, element by
    element against their plain versions and timed (rows 1g / 3g / 6t)."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 25)
    h, kh, d = TPM_HEADS
    rows, held = {}, []
    lengths = [0, 1, 300, 1024, 517, 256, 77, 900]
    args = _paged_inputs("bfloat16", g, device, lengths, h, kh, d)
    out = pops.paged_attention(*args)
    ref = paged_attention_ref(*args)
    torch.cuda.synchronize()
    held.append(check_close(f"1g B1 H{h}/{kh} D{d}", out, ref,
                            args[2].float().pow(2).mean().sqrt().item()))
    nbytes, flops = paged_bytes_flops(args[0], args[1], args[3], args[4],
                                      args[5])
    copies = [_paged_inputs("bfloat16", g, device, lengths, h, kh, d)
              for _ in range(n_copies(args[2].numel() * 2 * 2))]
    lib_in = []
    for (q_, kp_, vp_, bt_, ln_, _, _) in copies:
        t = bt_.shape[1] * kp_.shape[1]
        mask = (torch.arange(t, device=device)[None, :]
                < ln_[:, None])[:, None, None, :]
        lib_in.append((q_[:, :, None, :], *(
            p_[bt_.long()].reshape(8, t, kh, d).transpose(1, 2).contiguous()
            for p_ in (kp_, vp_)), mask))
    rows["1g"] = {
        "shape": f"8 slots, H{h}/{kh} D{d}, lengths {lengths}",
        "max_abs_err": (out.float() - ref.float()).abs().max().item(),
        "ms": time_ms(pops.paged_attention, copies),
        "plain_ms": time_ms(paged_attention_ref, copies, reps=5, rounds=3),
        "library_ms": time_ms(
            lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=mm, enable_gqa=True), lib_in),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, flops, "bfloat16")))}
    del copies, lib_in
    q, k, v = _flash_inputs(8, 512, torch.bfloat16, g, device, h, kh, d)
    out = fops.flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    held.append(check_close(f"3g B3 8 x 512 H{h}/{kh} D{d} causal", out,
                            ref, v.float().pow(2).mean().sqrt().item()))
    rows["3g"] = {**_flash_times(8, 512, h, kh, d, g, device),
                  "max_abs_err": (out.float() - ref.float()).abs().max(
                      ).item()}
    rows["6t"] = {}
    for k_, n_, o_ in TPM_B6:
        line, row = _tpm_b6_row(k_, n_, o_, g, device)
        held.append(line)
        rows["6t"][f"K{k_}xN{n_}"] = row
    return {"rows": rows, "held": held}


def _fp8_calls_vs_plain(fn) -> tuple:
    """Run ``fn()`` with every B6 call (``quant.qops.fp8_matmul_decode``:
    the column-split linears and the row-split fp32 partials) also
    computed by its plain version on the same inputs and held element by
    element (phase 8's limits); the forward goes on with the kernel's
    output.  Returns (fn's result, calls checked, the (M, K, N, out)
    shapes)."""
    from repro_torch.kernels.int8_matmul.ref import fp8_decode_ref
    from repro_torch.quant import qops
    b6 = qops.fp8_matmul_decode
    calls, shapes = [0], set()

    def held(x2, wq, ws, *, bias=None, out_dtype=None):
        out = b6(x2, wq, ws, bias=bias, out_dtype=out_dtype)
        ref = fp8_decode_ref(x2, wq, ws, bias, out_dtype or x2.dtype)
        check_close(f"B6 call {calls[0]} {tuple(x2.shape)} x "
                    f"{tuple(wq.shape)}", out, ref,
                    ref.float().pow(2).mean().sqrt().item())
        calls[0] += 1
        shapes.add((*x2.shape, wq.shape[1], str(out.dtype)[6:]))
        return out
    qops.fp8_matmul_decode = held
    try:
        return fn(), calls[0], sorted(shapes)
    finally:
        qops.fp8_matmul_decode = b6


def _tpm_prompts(vocab: int) -> tuple:
    """(a)'s drive: TPM_REQUESTS prompts of 64-512 tokens (phase 23's
    lengths) and 8-16 new tokens, from their own seed."""
    import numpy as np
    rng = np.random.default_rng(SEED + 25)
    plens = rng.integers(64, 513, TPM_REQUESTS)
    return ([rng.integers(0, vocab, (int(n),)) for n in plens],
            rng.integers(8, 17, TPM_REQUESTS))


def _with_lora_b(tree, seed: int, scale: float):
    """``tree`` with every adapter's ``b`` drawn from a normal of ``scale``
    on the card from ``seed`` (LoRA's zero ``b`` would add nothing to the
    logits and leave ``a`` no first-step gradient)."""
    torch = _torch()
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(node):
        if isinstance(node, list):
            for v in node:
                draw(v)
        elif isinstance(node, dict):
            if "lora" in node:
                b = node["lora"]["b"]
                node["lora"]["b"] = torch.randn(b.shape, generator=g,
                                                device=b.device) * scale
            for v in node.values():
                draw(v)
    draw(tree)
    return tree


def _tpm_lora(params):
    """qwen2's tree with rank-16 LoRA adapters on every attention and MLP
    linear, their ``b`` drawn."""
    from repro_torch.peft.lora import apply_peft
    return _with_lora_b(apply_peft(params, SEED + 26, method="lora",
                                   rank=TPM_LORA_RANK), SEED + 27, 0.02)


def _tpm_qwen2(quant, mesh=None) -> dict:
    """(d) / (e) on one side: qwen2-1.5b with fp8 or int4 weights (a
    TPM_Q_REQUESTS x TPM_Q_NEW PagedEngine drive, then one admission's
    and one decode step's logits, every B6 call held), or with LoRA
    adapters (``quant`` "lora": logits only)."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.quant import quantize_tree
    from repro_torch.serve.engine import PagedEngine
    cfg = get_config("qwen2-1.5b")
    params = LM(cfg, device="cuda").init(SEED)
    if quant == "lora":
        params = _tpm_lora(params)
    else:
        params = quantize_tree(params, quant=quant)
        cfg = cfg.with_(quant=quant)
    lm = LM(cfg, device="cuda")
    eng = PagedEngine(lm, params, n_slots=8, max_len=1024, page_size=256,
                      decode_block=8, seed=SEED, mesh=mesh)
    del params
    out = {}
    if quant != "lora":
        prompts = _tp_prompts(cfg.vocab_size)[1]
        out = _tp_paged_drive(eng, prompts[:TPM_Q_REQUESTS],
                              [TPM_Q_NEW] * TPM_Q_REQUESTS,
                              f"(d) {quant}")
    wrap = _fp8_calls_vs_plain if quant == "fp8" else None
    out["logits"] = _tp_logits(eng.lm, eng.params,
                               _tp_logit_inputs(cfg.vocab_size), wrap=wrap)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _moe_rank_combine():
    """A context in which one rank's MoE layers run as the one rank of a
    model axis of one: every expert, the combine an fp32 partial rounded
    once by ``row_linear``, the arithmetic a rank of phase 25 does (one
    sum over 40 experts in place of two over 20 and an all-reduce).  Its
    logits against one rank's are the witness of how far a change of
    summation order alone moves granite's bf16 logits."""
    import contextlib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.collectives import TensorParallel
    scope = TensorParallel(make_host_mesh(model=1, device="cuda"))

    @contextlib.contextmanager
    def run():
        share = moe._share
        moe._share = lambda p, m: (scope, 0, m.padded_experts, False)
        try:
            yield
        finally:
            moe._share = share
    return run()


def _tpm_seed_logits(lm, params, inputs, mesh) -> dict:
    """bf16 granite logits of ``_tp_logit_inputs`` and, on one rank
    (``mesh=None``), the summation-order witness's."""
    out = {"logits": _tp_logits(lm, params, inputs)}
    if mesh is None:
        with _moe_rank_combine():
            out["logits_witness"] = _tp_logits(lm, params, inputs)
    return out


def _tpm_granite(mesh=None) -> dict:
    """(a) and (c) on one side (``mesh=None``: one rank): granite at full
    width and depth through PagedEngine, the drive and the logits (bf16
    on each of TPM_SEEDS, one rank's summation-order witness beside
    them), the logits again in float32; and the float32 2-layer
    streams.  Under ``mesh`` also (b), the gather dispatch for
    TPM_GATHER_STEPS decode steps.  A rank keeps only its pieces while it
    serves (the whole tree is drawn again for (b))."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import PagedEngine
    from repro_torch.sharding.tp import shard_model
    cfg = get_config(GRANITE)
    kw = dict(n_slots=8, max_len=4096, page_size=256, seed=SEED, mesh=mesh)
    lm = LM(cfg, device="cuda")
    t0 = time.perf_counter()
    eng = PagedEngine(lm, lm.init(SEED), decode_block=8, **kw)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"local": {k: tuple(v.shape) for k, v in
                     eng.params["layers"][0]["blk0"]["moe"].items()
                     if k != "router"},
           "embed": tuple(eng.params["embed"]["w"].shape)}
    prompts, max_new = _tpm_prompts(cfg.vocab_size)
    eng.submit(prompts[0][:64], max_new_tokens=8)
    eng.run_to_completion()                  # warm-up
    tag = "one rank" if mesh is None else f"rank {mesh.rank}"
    out["a"] = _tp_paged_drive(eng, prompts, max_new, f"{tag} (a)")
    out["a"]["setup_s"] = time.perf_counter() - t0
    inputs = _tp_logit_inputs(cfg.vocab_size)
    out["seeds"] = {SEED: _tpm_seed_logits(eng.lm, eng.params, inputs,
                                           mesh)}
    del eng
    gc.collect()
    for seed in TPM_SEEDS[1:]:
        slm, params = lm, lm.init(seed)
        if mesh is not None:
            slm, params = shard_model(lm, params, mesh)
        out["seeds"][seed] = _tpm_seed_logits(slm, params, inputs, mesh)
        del slm, params
        gc.collect()
    if mesh is not None:
        glm = LM(cfg.with_(moe_impl="gather"), device="cuda")
        eng = PagedEngine(glm, lm.init(SEED), decode_block=TPM_GATHER_STEPS,
                          **kw)
        _reset_launches()
        for p in prompts[:4]:
            eng.submit(p, max_new_tokens=1 + TPM_GATHER_STEPS)
        eng.step()
        if eng.steps_run != TPM_GATHER_STEPS:
            raise AssertionError(f"{tag} (b): {eng.steps_run} decode steps")
        out["b"] = {"decode_collectives": eng.decode_collectives.to_dict(
            steps=TPM_GATHER_STEPS), "launches": _read_launches(),
            "streams": [list(q.out_tokens) for q in sorted(
                eng.registry.values(), key=lambda q: q.rid)]}
        del eng
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    # (a) in float32 at full width and depth: the logits alone
    flm = LM(cfg.with_(dtype="float32"), device="cuda")
    fparams = flm.init(SEED)
    if mesh is not None:
        flm, fparams = shard_model(flm, fparams, mesh)
    out["a"]["logits_f32"] = _tp_logits(flm, fparams, inputs)
    del flm, fparams
    gc.collect()
    torch.cuda.empty_cache()
    f32 = LM(cfg.with_(num_layers=TPM_F32_LAYERS, dtype="float32"),
             device="cuda")
    eng = PagedEngine(f32, f32.init(SEED), decode_block=8, **kw)
    ids = [eng.submit(p, max_new_tokens=24) for p in prompts]
    done = eng.run_to_completion()
    out["c"] = {"streams": [list(done[i].out_tokens) for i in ids]}
    del eng, f32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tpm_rank(rank: int) -> dict:
    """One of the two ranks of phase 25, on the card the parent holds."""
    torch = _torch()
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    missing = [n for n in build.SOURCES if not build.lib_path(n).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels {missing} not built by "
                           "phase 2 (the ranks load, never build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    mesh = make_host_mesh(model=TPM_RANKS, device="cuda")
    out = {"mesh": mesh.describe(), "granite": _tpm_granite(mesh)}
    for quant in ("fp8", "int4", "lora"):
        out[quant] = _tpm_qwen2(quant, mesh)
    out["wall_s"] = time.perf_counter() - t_start
    return out


def phase_tp_moe(records: list, smi: str) -> dict:
    """Phase 25: granite-moe-3b-a800m, qwen2-1.5b with fp8 / int4 weights
    and with LoRA adapters, served by two ranks that share the card over
    gloo, against one rank in this process."""
    torch = _torch()
    from repro_torch.launch.mesh import spawn_world
    t_phase = time.perf_counter()
    f = _tpm_kernel_rows()
    one = {"granite": _tpm_granite()}
    for quant in ("fp8", "int4", "lora"):
        one[quant] = _tpm_qwen2(quant)
    ranks = spawn_world(_tpm_rank, TPM_RANKS, device="cuda")
    r0, g1 = ranks[0], one["granite"]
    streams = [("granite", "a"), ("granite", "b"), ("granite", "c"),
               ("fp8", None), ("int4", None)]
    for key, sub in streams:
        pick = (lambda r: r[key][sub]["streams"]) if sub else \
            (lambda r: r[key]["streams"])
        if any(pick(r) != pick(r0) for r in ranks[1:]):
            raise AssertionError(f"{key} {sub or ''}: a rank's streams "
                                 "differ from rank 0's")
    if r0["granite"]["c"]["streams"] != g1["c"]["streams"]:
        raise AssertionError("(c) float32 granite streams: 2 ranks differ "
                             "from one")
    for key in ("admissions", "decode_steps", "syncs", "launches"):
        if any(r["granite"]["a"][key] != g1["a"][key] for r in ranks):
            raise AssertionError(
                f"(a) {key}: ranks {[r['granite']['a'][key] for r in ranks]}"
                f" vs one rank {g1['a'][key]}")
    ep = g1["local"]["gate_e"][0] // TPM_RANKS      # EP: E/m experts a rank
    if any(r["granite"]["local"]["gate_e"][0] != ep for r in ranks):
        raise AssertionError(f"(a) not EP at {ep} experts a rank: "
                             f"{r0['granite']['local']}")
    # granite in bf16: a bf16 ulp in a router input flips near-tied
    # top-8 choices of single tokens, and over 32 layers of random
    # weights the flips compound.  Held row by row (as phase 23): the
    # float32 logits within TPM_F32_REL_L2 of one rank's; the bf16 logits,
    # on each of two seeds, within TPM_WITNESS_FACTOR times the distance
    # of one rank's summation-order witness from one rank's.
    errs, worst_row = {}, {}
    for step in ("prefill", "decode"):
        key = f"granite {step} f32"
        errs[key] = worst_row[key] = max(
            _rel_l2_rows(r["granite"]["a"]["logits_f32"][step],
                         g1["a"]["logits_f32"][step]) for r in ranks)
        if not errs[key] <= TPM_F32_REL_L2:
            raise AssertionError(f"{key} logits 2 ranks vs one: a row's "
                                 f"relative L2 {errs[key]:.3e} > "
                                 f"{TPM_F32_REL_L2}")
        for seed in TPM_SEEDS:
            one_s = g1["seeds"][seed]
            key = f"granite {step} seed {seed}"
            errs[key] = worst_row[key] = max(
                _rel_l2_rows(r["granite"]["seeds"][seed]["logits"][step],
                             one_s["logits"][step]) for r in ranks)
            wit = errs[key + " witness"] = _rel_l2_rows(
                one_s["logits_witness"][step], one_s["logits"][step])
            if not errs[key] <= TPM_WITNESS_FACTOR * wit:
                raise AssertionError(
                    f"{key} bf16 logits 2 ranks vs one: a row's relative "
                    f"L2 {errs[key]:.3e} > {TPM_WITNESS_FACTOR:g} x the "
                    f"summation-order witness's {wit:.3e}")
    for q in ("fp8", "int4", "lora"):
        for step in ("prefill", "decode"):
            key = f"{q} {step}"
            errs[key] = worst_row[key] = max(
                _rel_l2_rows(r[q]["logits"][step], one[q]["logits"][step])
                for r in ranks)
            if not errs[key] <= LOGIT_REL_L2:
                raise AssertionError(f"{key} logits 2 ranks vs one: a "
                                     f"row's relative L2 {errs[key]:.3e} "
                                     f"> {LOGIT_REL_L2}")
    b6 = [r["fp8"]["logits"]["decode_calls"] for r in ranks]
    if not all(b6) or one["fp8"]["logits"]["decode_calls"] <= 0:
        raise AssertionError(f"(d) no B6 call held in a decode step: {b6}")
    for rec in records:
        if rec["name"] in r0["granite"]["a"]["launches"]:
            rec.setdefault("launches_by_drive", {})["tp_moe_rank0"] = \
                r0["granite"]["a"]["launches"][rec["name"]]
        if rec["name"] == "fp8_decode_matmul":
            rec.setdefault("launches_by_drive", {})["tp_fp8_rank0"] = \
                r0["fp8"]["launches"].get(rec["name"], 0)
    rows = f["rows"]
    print(f"[25 tp_moe_quant] (f) {smi}: " + "; ".join(f["held"]) + "; "
          + "; ".join(f"{tag} {r['shape']}: ms {r['ms']:.4f} plain "
                      f"{r['plain_ms']:.4f} library {r['library_ms']:.4f} "
                      f"bound {r['bound_ms']:.4f} ({r['bound_by']})"
                      for tag, r in [("1g", rows["1g"]), ("3g", rows["3g"])]
                      + [(f"6t {k}", v) for k, v in rows["6t"].items()]))
    a0 = r0["granite"]["a"]
    coll = a0["decode_collectives"]
    print(f"[25 tp_moe_quant] (a) {smi}: {r0['mesh']}, {GRANITE} 32L bf16 "
          f"einsum, rank experts {r0['granite']['local']}, embedding "
          f"{r0['granite']['embed']}; 2 ranks: {a0['tokens']} tokens, "
          + ", ".join(f"rank {i} {r['granite']['a']['tokens_per_s']:.1f} "
                      f"tok/s TTFT p50 {r['granite']['a']['ttft_p50_s']:.4f}"
                      f"s decode step "
                      f"{r['granite']['a']['decode_step_wall_ms']:.2f} ms "
                      f"peak {r['granite']['a']['peak_mem_gb']:.2f} GB"
                      for i, r in enumerate(ranks))
          + f"; one rank here {g1['a']['tokens_per_s']:.1f} tok/s TTFT p50 "
          f"{g1['a']['ttft_p50_s']:.4f}s decode step "
          f"{g1['a']['decode_step_wall_ms']:.2f} ms peak "
          f"{g1['a']['peak_mem_gb']:.2f} GB; {a0['admissions']} admissions "
          f"+ {a0['decode_blocks']} blocks = {a0['syncs']} syncs, "
          f"{a0['decode_steps']} steps as one rank's; launches per rank "
          f"{[r['granite']['a']['launches'] for r in ranks]}; logits vs one"
          f" rank (worst row) float32 prefill "
          f"{errs['granite prefill f32']:.3e} decode "
          f"{errs['granite decode f32']:.3e} (limit {TPM_F32_REL_L2}); "
          f"bf16 " + "; ".join(
              f"seed {k[-1]} {k[0]} {errs[k[1]]:.3e} (witness "
              f"{errs[k[2]]:.3e}, ratio {errs[k[1]] / errs[k[2]]:.3f})"
              for k in ((st, f"granite {st} seed {sd}",
                         f"granite {st} seed {sd} witness", sd)
                        for sd in TPM_SEEDS for st in ("prefill", "decode")))
          + f" (limit {TPM_WITNESS_FACTOR:g} x the witness); collectives a "
          f"decode step "
          f"{coll['count_by_op']} calls / {a0['decode_steps']} steps, bytes "
          f"a step {coll['bytes_per_step_by_op']}")
    b0 = r0["granite"]["b"]
    print(f"[25 tp_moe_quant] (b) gather dispatch, {TPM_GATHER_STEPS} "
          f"decode steps: streams equal on both ranks, launches "
          f"{b0['launches']}, collectives a step "
          f"{b0['decode_collectives']['bytes_per_step_by_op']}")
    print(f"[25 tp_moe_quant] (c) float32 granite {TPM_F32_LAYERS} layers: "
          f"{len(r0['granite']['c']['streams'])} streams of 2 ranks equal "
          "one rank's token for token")
    for q in ("fp8", "int4"):
        d0 = r0[q]
        print(f"[25 tp_moe_quant] (d) qwen2-1.5b {q} weights: "
              f"{d0['tokens']} tokens ({d0['tokens_per_s']:.1f} tok/s, one "
              f"rank {one[q]['tokens_per_s']:.1f}), decode step "
              f"{d0['decode_step_wall_ms']:.2f} ms (one rank "
              f"{one[q]['decode_step_wall_ms']:.2f}), launches per rank "
              f"{[r[q]['launches'] for r in ranks]}, streams equal on both "
              f"ranks; logits vs one rank prefill {errs[q + ' prefill']:.3e}"
              f" decode {errs[q + ' decode']:.3e}"
              + (f"; every B6 call of one decode step held: "
                 f"{[r[q]['logits']['decode_calls'] for r in ranks]} a "
                 f"rank (one rank {one[q]['logits']['decode_calls']}), "
                 f"shapes {d0['logits']['shapes']}" if q == "fp8" else "")
              + f"; collectives a decode step "
              f"{d0['decode_collectives']['bytes_per_step_by_op']}")
    print(f"[25 tp_moe_quant] (e) qwen2-1.5b + rank-{TPM_LORA_RANK} LoRA "
          f"unmerged: logits vs one rank prefill {errs['lora prefill']:.3e} "
          f"decode {errs['lora decode']:.3e}")
    out = _without_arrays({"f": f, "one": one, "ranks": ranks,
                           "logit_rel_l2": errs,
                           "logit_rel_l2_worst_row": worst_row})
    out["phase_wall_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    print(f"[25 tp_moe_quant] phase {out['phase_wall_s']:.1f}s (ranks "
          f"{[round(r['wall_s'], 1) for r in ranks]}s)")
    return out


# ---------------------------------------------------------------------------
# phase 26: sharded fine-tuning with adapters, quantized bases and MoE

TTP_RANKS = 2
TTP_STEPS = 2
TTP_PEFT = ("lora", "qlora")       # (a), rank PEFT_RANK
TTP_GRANITE_LAYERS = 4             # (b): the first 4 of granite's 32
TTP_LLAMA_LAYERS = 8               # (a): the first 8 of llama3.2-1b's 16
TTP_F32_LAYERS = 2                 # (c)
#: (c): a leaf's gradient is held within the larger of
#: TRAIN_TP_GRAD_REL_L2 and this many times the distance a change of
#: summation order alone puts between two one-rank gradients (a scalar
#: such as LoRA's ``scaling`` sums millions of terms that cancel)
TTP_FLOOR_FACTOR = 3.0


def _ttp_config(arch: str, layers=None, dtype=None):
    from repro_torch.configs import first_layers, get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = first_layers(cfg, layers)
    return cfg if dtype is None else cfg.with_(dtype=dtype)


def _ttp_params(cfg, method: str):
    """``cfg``'s weights from SEED, then its fine-tuning arm: int4 base for
    QLoRA, and PEFT_RANK adapters (``b`` drawn from a seeded normal, so
    that the first step's gradients reach ``a``), with their trainable
    mask (``None``: every leaf)."""
    from repro_torch.models.model import LM
    from repro_torch.peft.lora import apply_peft, trainable_mask
    from repro_torch.quant import quantize_tree
    params = LM(cfg, device="cuda").init(SEED)
    if method == "full":
        return params, None
    if method == "qlora":
        params = quantize_tree(params, quant="int4")
    params = _with_lora_b(apply_peft(params, SEED + 1, method=method,
                                     rank=PEFT_RANK), SEED + 2, 0.01)
    return params, trainable_mask(params, method)


def _ttp_train(cfg, method: str, mesh=None) -> dict:
    """TTP_STEPS steps of ``Trainer(mesh=, mask=)`` on phase 20's batch
    (one rank: ``mesh=None``), the launch counts zeroed before: the
    losses and the rank's figures."""
    torch = _torch()
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import LM
    from repro_torch.optim.adamw import cosine_schedule
    from repro_torch.peft.lora import count_trainable
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import tree_map
    tr = Trainer(LM(cfg, device="cuda"),
                 SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                 seed=SEED),
                 lr=cosine_schedule(TRAIN_TP_LR, TRAIN_TP_WARMUP, TTP_STEPS),
                 mesh=mesh, log_every=1, log_fn=_train_quiet)
    params, mask = _ttp_params(cfg, method)
    trainable = count_trainable(params, mask)[0] if mask is not None \
        else count_trainable(params, tree_map(lambda _: True, params))[0]
    tr.set_params(params, mask=mask)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    hist = tr.run(TTP_STEPS)
    losses = [r["loss"] for r in hist]
    if not all(v == v and abs(v) < float("inf") for v in losses):
        raise AssertionError(f"{cfg.name} {method}: non-finite loss "
                             f"{losses}")
    out = dict(_train_tp_reports(tr, torch), losses=losses,
               launches=_no_launches(f"{cfg.name} {method}"),
               trainable=trainable)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ttp_f32_grads(arch: str, method: str, mesh) -> dict:
    """(c): float32 at TTP_F32_LAYERS layers of full width: every
    trainable leaf's first-step gradient, gathered whole from the ranks'
    pieces, against one rank's (computed in this rank)."""
    import dataclasses
    torch = _torch()
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import gather_leaf, make_param_specs
    from repro_torch.sharding.tp import shard_model
    from repro_torch.train.loop import loss_and_grads, sharded_grads
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = _ttp_config(arch, TTP_F32_LAYERS, "float32")
    if cfg.moe is not None:
        # dropless (capacity_factor E / k: a group's capacity is every
        # token): under drops a token's slot moves with a rounding-level
        # change of a router input, and the first-step gradient of its
        # expert with it, so two exact implementations differ there
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    params, mask = _ttp_params(cfg, method)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in
             SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                             seed=SEED).next_batch().items()}
    lm = LM(cfg, device="cuda")
    _, _, want = loss_and_grads(lm, params, batch)
    # the same gradient as the mean of two half batches' (mathematically
    # equal; every sum over tokens in another order): how far a change
    # of summation order alone moves each leaf on one rank
    half = TRAIN_BATCH // 2
    halves = [loss_and_grads(lm, params, {k: v[i * half:(i + 1) * half]
                                          for k, v in batch.items()})[2]
              for i in range(2)]
    again = dict(leaves_with_path(tree_map(
        lambda a, b: None if a is None else (a.float() + b.float()) / 2,
        *halves)))
    del halves
    specs = make_param_specs(params, mesh)
    tlm, local = shard_model(lm, params, mesh)
    pieces, _ = sharded_grads(tlm, local, batch, mesh, specs)
    whole = tree_map(lambda g, s: None if g is None
                     else gather_leaf(g, s, mesh), pieces, specs)
    trainable = dict(leaves_with_path(mask)) if mask is not None else None
    want = dict(leaves_with_path(want))
    def rel(g, w):
        den = float(w.norm())
        return float((g.float() - w).norm()) / den if den \
            else float(g.float().norm())
    errs, limits = {}, {}
    for path, g in leaves_with_path(whole):
        if g is None or (trainable is not None and not trainable[path]):
            continue
        w = want[path].float()
        errs[path] = rel(g, w)
        limits[path] = max(TRAIN_TP_GRAD_REL_L2,
                           TTP_FLOOR_FACTOR * rel(again[path], w))
    share = {p: errs[p] / limits[p] for p in errs}
    worst = max(share, key=share.get)
    if not share[worst] <= 1.0:
        raise AssertionError(f"(c) {arch} {method}: gradient of {worst} "
                             f"relative L2 {errs[worst]:.3e} > "
                             f"{limits[worst]:.3e}")
    loose = {p: limits[p] for p in limits
             if limits[p] > TRAIN_TP_GRAD_REL_L2}
    router = [p for p in errs if "/router/" in p]
    if arch == GRANITE and not router:
        raise AssertionError("(c) granite: no router gradient held")
    del params, pieces, whole, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"leaves": len(errs), "worst_leaf": worst,
            "worst_rel_l2": errs[worst], "worst_limit": limits[worst],
            "above_1e-4": {p: errs[p] for p in errs
                           if errs[p] > TRAIN_TP_GRAD_REL_L2},
            "order_floor_limits": loose,
            "floor_ratio": {p: errs[p] * TTP_FLOOR_FACTOR / limits[p]
                            for p in loose},
            "router_rel_l2": max((errs[p] for p in router), default=None)}


def _ttp_rank(rank: int) -> dict:
    """One of the two ranks of phase 26, on the card the parent holds:
    (a) llama3.2-1b LoRA and QLoRA, (b) granite's first 4 layers, full
    fine-tune, under a model axis of 2; (c) float32 gradients."""
    torch = _torch()
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    mesh = make_host_mesh(model=TTP_RANKS, device="cuda")
    out = {"mesh": mesh.describe()}
    llama = _ttp_config(TRAIN_ARCH, TTP_LLAMA_LAYERS)
    for method in TTP_PEFT:
        out[method] = _ttp_train(llama, method, mesh)
    out["granite"] = _ttp_train(_ttp_config(GRANITE, TTP_GRANITE_LAYERS),
                                "full", mesh)
    _reset_launches()
    out["c"] = {f"{a} {m}": _ttp_f32_grads(a, m, mesh)
                for a, m in ((GRANITE, "full"), (TRAIN_ARCH, "lora"),
                             (TRAIN_ARCH, "qlora"))}
    out["c_launches"] = _no_launches(f"rank {rank} (c)")
    out["wall_s"] = time.perf_counter() - t_start
    return out


def phase_train_tp_peft(smi: str) -> dict:
    """Phase 26: LoRA / QLoRA on llama3.2-1b's first 8 layers and
    granite's first 4 trained by two ranks that share the card over gloo,
    against one rank in this process."""
    torch = _torch()
    from repro_torch.launch.mesh import spawn_world
    t_phase = time.perf_counter()
    llama = _ttp_config(TRAIN_ARCH, TTP_LLAMA_LAYERS)
    one = {m: _ttp_train(llama, m) for m in TTP_PEFT}
    one["granite"] = _ttp_train(_ttp_config(GRANITE, TTP_GRANITE_LAYERS),
                                "full")
    ranks = spawn_world(_ttp_rank, TTP_RANKS, device="cuda")
    r0 = ranks[0]
    worst = {}
    for key in one:
        if any(r[key]["losses"] != r0[key]["losses"] for r in ranks):
            raise AssertionError(f"({key}) the ranks report different "
                                 "losses")
        worst[key] = max(abs(a - b) / abs(b) for a, b in
                         zip(r0[key]["losses"], one[key]["losses"]))
        if not worst[key] <= TRAIN_TP_LOSS_RTOL:
            raise AssertionError(f"({key}) losses {r0[key]['losses']} vs "
                                 f"one rank's {one[key]['losses']}: "
                                 f"{worst[key]:.3e} > {TRAIN_TP_LOSS_RTOL}")
    for key, tag in (("lora", "(a) LoRA"), ("qlora", "(a) QLoRA"),
                     ("granite", f"(b) {GRANITE} first "
                                 f"{TTP_GRANITE_LAYERS} layers, full")):
        arch = GRANITE if key == "granite" \
            else f"{TRAIN_ARCH} {TTP_LLAMA_LAYERS}L"
        print(f"[26 train_tp_peft] {tag} {smi}: {r0['mesh']}, {arch} bf16, "
              f"{TTP_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ}, "
              f"{r0[key]['trainable']} trainable elements: losses "
              f"{[round(v, 5) for v in r0[key]['losses']]} vs one rank's "
              f"{[round(v, 5) for v in one[key]['losses']]} (worst relative "
              f"{worst[key]:.3e}, limit {TRAIN_TP_LOSS_RTOL}); " + "; ".join(
                  f"rank {i} step wall p50 {r[key]['step_p50_s'] * 1e3:.1f} "
                  f"ms, {r[key]['tokens_per_s']:.0f} tokens/s, peak "
                  f"{r[key]['peak_gb']:.2f} GB, collectives a step "
                  f"{_coll_line(r[key]['collectives_a_step'])}"
                  for i, r in enumerate(ranks))
              + f"; one rank step wall p50 "
              f"{one[key]['step_p50_s'] * 1e3:.1f} ms, "
              f"{one[key]['tokens_per_s']:.0f} tokens/s, peak "
              f"{one[key]['peak_gb']:.2f} GB; kernel launches 0")
    c0 = r0["c"]
    print(f"[26 train_tp_peft] (c) float32 {TTP_F32_LAYERS} layers, "
          f"{r0['mesh']}: " + "; ".join(
              f"{k}: {v['leaves']} trainable leaves' first-step gradients, "
              f"worst {v['worst_leaf']} {v['worst_rel_l2']:.3e} (limit "
              f"{v['worst_limit']:.3e}), past {TRAIN_TP_GRAD_REL_L2}: "
              f"{len(v['above_1e-4'])} ({v['above_1e-4']}; their limits "
              f"from the summation-order floor: {v['order_floor_limits']},"
              f" each leaf's error over its floor: {v['floor_ratio']})"
              + (f", router {v['router_rel_l2']:.3e}"
                 if v["router_rel_l2"] is not None else "")
              for k, v in c0.items())
          + f" (limit: the larger of {TRAIN_TP_GRAD_REL_L2} and "
          f"{TTP_FLOOR_FACTOR:g}x the floor); kernel launches 0")
    out = {"one": one, "ranks": ranks, "worst_loss_rel": worst,
           "phase_wall_s": time.perf_counter() - t_phase}
    torch.cuda.empty_cache()
    print(f"[26 train_tp_peft] phase {out['phase_wall_s']:.1f}s (ranks "
          f"{[round(r['wall_s'], 1) for r in ranks]}s)")
    return out


# ---------------------------------------------------------------------------
# Phase 27: the dry-run cells on the card, context-parallel decode, GPipe


CELL_REPS = 3                   # (a): timed runs of each cell
CELL_TRAIN_REPS = 1             # (a): timed steps of the train cell
CELL_TRAIN_SEQ = 4096           # train_4k's rows
CELL_TRAIN_ROWS = 2             # (a): the rows train_4k runs (time)
CELL_MEM_SHARE = 0.9            # (a): of the card's memory for the rows
CELL_PREFILL = (1, 32_768)      # prefill_32k cut from 32 rows to 1
CELL_DECODE = (16, 32_768)      # decode_32k cut from 128 rows to 16
CELL_ATTN_BLOCK = 4096          # the dry-run's chunk at 32,768 (S / 8)
CELL_LOSS_RTOL = 1e-5
CP_ARCH, CP_RANKS = "qwen2-1.5b", 4
CP_BATCH, CP_SEQ, CP_STEPS = 8, 32_768, 2
#: (b): each row's first position, on and around the 4 shards' edges
CP_POS = (8191, 8192, 16383, 16384, 20000, 24575, 24576, 32000)
CP_F32_LAYERS, CP_F32_REL_L2 = 2, 1e-5
#: (b): a rank's collectives a decode step, predicted in PERF.md §6 before
#: the first run: 28 layers x (q / k / v gathers; the combine's max, l
#: and o; wo and down) + the embedding's sum + the logits' gather
CP_PREDICTED = {"all-reduce/model": (141, 4_199_424.0),
                "all-gather/model": (85, 1_444_864.0)}
PIPE_RANKS, PIPE_MICRO, PIPE_MB = 2, 4, (2, 512)
#: phase 28: qwen2-1.5b's heads over 27 (b)'s four ranks (12 query heads
#: divide, 2 kv heads do not): every rank computes every head
WH_ROWS, WH_SEQ = 4, 512        # (a) prefill and (b) train: 4 x 512
WH_TRAIN_STEPS = 2
WH_REPS = 1                     # (a): timed prefill after the counted one
WH_LOGIT_REL_L2 = 2e-2          # (a) bf16, per row, vs one rank's
WH_F32_REL_L2 = 1e-5            # (a) float32 at CP_F32_LAYERS layers
WH_LOSS_RTOL = 2e-2             # (b) bf16, each step vs one rank's
WH_F32_GRAD_REL_L2 = 1e-4       # (b) float32: every leaf's gradient
WH_F32_LOSS_RTOL = 1e-5         # (b) float32: the loss
#: (a): a rank's collectives a bf16 prefill, predicted in PERF.md §6
#: before the first run: 28 layers x (q / k / v gathers of the rank's
#: columns: 384 + 64 + 64 of 4 x 512 rows in bf16) + the last token's
#: logits (37,984 fp32 a row); 28 x (wo, down: fp32 partials of 4 x 512 x
#: 1,536) + the embedding's sum
WH_PREDICTED = {"all-gather/model": (85, 59_328_000.0),
                "all-reduce/model": (57, 717_225_984.0)}
#: (a): a rank's launches a prefill: B3 a layer, B7 twice a layer and once
#: for the final norm
WH_LAUNCHES = {"flash_attention": 28, "rmsnorm": 57}


def _cell_walls(fn, runs: int) -> tuple:
    """``fn()`` ``runs`` times: (its last output, each run's wall in ms
    from CUDA events)."""
    torch = _torch()
    walls, out = [], None
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
    return out, walls


def _cell_flops(fn) -> tuple:
    """(output, FLOPs FlopCounterMode counts) of one real run of ``fn``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn()
    _torch().cuda.synchronize()
    return out, fc.get_total_flops()


def _cell_trace(cfg, shape) -> dict:
    """The meta trace of ``cfg``'s cell at ``shape`` on one rank's
    abstract mesh (a world of one), computed on the host."""
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.launch.roofline import model_flops_for
    from repro_torch.launch.steps import build_cell
    t0 = time.perf_counter()
    terms = build_cell(cfg, shape, abstract_mesh({})).trace(
        model_flops_for(cfg, shape))
    return {"flops": terms.flops, "bytes": terms.hbm_bytes,
            "bottleneck": terms.bottleneck, "t_max_ms": terms.t_max * 1e3,
            "t_compute_ms": terms.t_compute * 1e3,
            "t_memory_ms": terms.t_memory * 1e3,
            "trace_s": time.perf_counter() - t0}


def _cell_line(tag: str, r: dict) -> str:
    t = r["trace"]
    return (f"{tag}: wall median {r['wall_ms']:.2f} ms ({r['walls']}), "
            f"peak {r['peak_gb']:.2f} GB, launches {r['launches']} "
            f"(formula {r['want_launches']}); meta trace {t['flops']:.4g} "
            f"FLOPs, {t['bytes']:.4g} B, {t['bottleneck']}-bound, t_max "
            f"{t['t_max_ms']:.3f} ms = {t['t_max_ms'] / r['wall_ms']:.3f} "
            f"of the wall")


def _cell_launches(l_count: int, runs: int, b1: bool, b3: bool,
                   b7: bool) -> dict:
    return {"paged_attention": l_count * runs if b1 else 0,
            "flash_attention": l_count * runs if b3 else 0,
            "rmsnorm": (2 * l_count + 1) * runs if b7 else 0}


def _cell_take(want: dict, tag: str) -> dict:
    got = {k: v for k, v in _read_launches().items() if k in want}
    if got != want:
        raise AssertionError(f"(a) {tag}: launches {got} != {want}")
    return got


def _cells_train(cfg, mesh, params0, traces) -> dict:
    """(a) train_4k: a 1-row probe step's peak sizes the rows; then the
    cell at those rows: its loss against LM.loss, FlopCounterMode over
    one real step against the meta trace, and CELL_REPS timed steps."""
    torch = _torch()
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim.adamw import init_adamw
    g = torch.Generator(device="cuda").manual_seed(SEED + 27)

    def batch(rows):
        toks = torch.randint(0, cfg.vocab_size, (rows, CELL_TRAIN_SEQ + 1),
                             generator=g, device="cuda")
        return {"tokens": toks[:, :-1].int(), "labels": toks[:, 1:].int(),
                "mask": torch.ones((rows, CELL_TRAIN_SEQ), device="cuda")}

    def cell_at(rows):
        return build_cell(cfg, ShapeConfig("train_4k", CELL_TRAIN_SEQ, rows,
                                           "train"), mesh)

    params = _clone_tree(params0)
    opt = init_adamw(params)
    gc.collect()
    torch.cuda.synchronize()
    static = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    probe = CELL_TRAIN_ROWS // 2       # a step's peak at half the rows
    cell_at(probe).fn(params, opt, batch(probe))
    torch.cuda.synchronize()
    p_half = torch.cuda.max_memory_allocated() / 1e9
    rows = CELL_TRAIN_ROWS
    cell = cell_at(rows)
    b = batch(rows)
    loss_ref = float(cell.lm.loss(params, b)[0])
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    (_, _, metrics), flops_real = _cell_flops(
        lambda: cell.fn(params, opt, b))
    loss = float(metrics["loss"])
    _, walls = _cell_walls(lambda: cell.fn(params, opt, b), CELL_TRAIN_REPS)
    want = _cell_launches(cfg.num_layers, CELL_TRAIN_REPS + 1, False, False,
                          False)
    launches = _cell_take(want, "train_4k")
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the rows the card holds, from the peaks at half the rows and at all
    per_row = (peak - p_half) / (rows - probe)
    fixed = peak - rows * per_row      # weights, state, gradients
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    holds = int((CELL_MEM_SHARE * total - fixed) // per_row) \
        if per_row > 0.05 else None
    if not abs(loss - loss_ref) <= CELL_LOSS_RTOL * abs(loss_ref):
        raise AssertionError(f"(a) train_4k loss {loss} vs LM.loss "
                             f"{loss_ref}")
    trace = traces["train"].result()
    if trace["flops"] != flops_real:
        raise AssertionError(f"(a) train_4k: meta trace {trace['flops']} "
                             f"FLOPs != the real run's {flops_real}")
    del params, opt, cell
    torch.cuda.empty_cache()
    return {"rows": rows, "holds_rows": holds, "per_row_gb": per_row,
            "fixed_gb": fixed, "static_gb": static,
            "loss": loss, "loss_ref": loss_ref, "flops_real": flops_real,
            "wall_ms": statistics.median(walls), "walls": walls,
            "peak_gb": peak, "launches": launches, "want_launches": want,
            "trace": trace}


def _clone_tree(tree):
    from repro_torch.tree import tree_map
    torch = _torch()
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tree)


def _cells_prefill(cfg, mesh, params, traces) -> dict:
    """(a) prefill_32k at 1 x 32,768: B3 and B7 on every layer; logits
    against the plain versions (chunked attention, plain RMSNorm)."""
    torch = _torch()
    import numpy as np
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_cell
    b, s = CELL_PREFILL
    shape = ShapeConfig("prefill_32k", s, b, "prefill")
    cfg = _cells_prefill_config(cfg)
    cell = build_cell(cfg, shape, mesh)
    g = torch.Generator(device="cuda").manual_seed(SEED + 28)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                         device="cuda").int()
    cache = cell.lm.init_cache(b, s)
    _setup_peak_gb()
    _reset_launches()
    (logits, _), walls = _cell_walls(lambda: cell.fn(params, toks, cache),
                                     CELL_REPS)
    want = _cell_launches(cfg.num_layers, CELL_REPS, False, True, True)
    launches = _cell_take(want, "prefill_32k")
    peak = torch.cuda.max_memory_allocated() / 1e9
    direct, _ = cell.lm.prefill(params, toks, cache)
    err_direct = _rel_l2_all(logits.float().cpu().numpy(),
                             direct.float().cpu().numpy())
    if not err_direct <= LOGIT_REL_L2:
        raise AssertionError(f"(a) prefill_32k cell vs LM.prefill: "
                             f"{err_direct:.3e}")
    plain, _ = _swap_plain(lambda: cell.lm.prefill(params, toks, cache),
                           ("chunked", "norm"))
    err = _rel_l2_all(logits.float().cpu().numpy(),
                      plain.float().cpu().numpy())
    if not (np.isfinite(logits.float().cpu().numpy()).all()
            and err <= LOGIT_REL_L2):
        raise AssertionError(f"(a) prefill_32k logits vs plain: {err:.3e}")
    del cache
    torch.cuda.empty_cache()
    return {"wall_ms": statistics.median(walls), "walls": walls,
            "peak_gb": peak, "launches": launches, "want_launches": want,
            "logits_rel_l2_vs_prefill": err_direct,
            "logits_rel_l2_vs_plain": err,
            "trace": traces["prefill"].result()}


def _cells_decode(cfg, mesh, params, traces) -> dict:
    """(a) decode_32k at 16 x 32,768 over a random contiguous cache (the
    plain decode, B7 on every norm) and the same contents in page pools
    (B1): logits against the plain RMSNorm and against each other; the
    contiguous cell's FLOPs against its meta trace."""
    torch = _torch()
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.steps import build_cell
    b, s = CELL_DECODE
    shape = ShapeConfig("decode_32k", s, b, "decode")
    g = torch.Generator(device="cuda").manual_seed(SEED + 29)
    tok = torch.randint(0, cfg.vocab_size, (b,), generator=g,
                        device="cuda").int()
    pos = (s - 1 - 997 * torch.arange(b, device="cuda")).int()
    out = {}
    cell = build_cell(cfg, shape, mesh)
    cache = cell.lm.init_cache(b, s)
    for grp in cache:
        for node in grp.values():
            for t in node["kv"].values():
                t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    _setup_peak_gb()
    _reset_launches()
    (logits_c, _), flops_real = _cell_flops(
        lambda: cell.fn(params, tok, cache, pos))
    _, walls = _cell_walls(lambda: cell.fn(params, tok, cache, pos),
                           CELL_REPS)
    want = _cell_launches(cfg.num_layers, CELL_REPS + 1, False, False, True)
    launches = _cell_take(want, "decode_32k contiguous")
    peak = torch.cuda.max_memory_allocated() / 1e9
    direct, _ = cell.lm.decode_step(params, tok, cache, pos)
    err_direct = _rel_l2_all(logits_c.float().cpu().numpy(),
                             direct.float().cpu().numpy())
    if not err_direct <= LOGIT_REL_L2:
        raise AssertionError(f"(a) decode_32k cell vs LM.decode_step: "
                             f"{err_direct:.3e}")
    plain, _ = _swap_plain(lambda: cell.lm.decode_step(params, tok, cache,
                                                       pos), ("norm",))
    err = _rel_l2_all(logits_c.float().cpu().numpy(),
                      plain.float().cpu().numpy())
    if not err <= LOGIT_REL_L2:
        raise AssertionError(f"(a) decode_32k contiguous logits vs plain "
                             f"RMSNorm: {err:.3e}")
    trace = traces["decode"].result()
    if trace["flops"] != flops_real:
        raise AssertionError(f"(a) decode_32k: meta trace {trace['flops']} "
                             f"FLOPs != the real run's {flops_real}")
    out["contiguous"] = {"wall_ms": statistics.median(walls),
                         "walls": walls, "peak_gb": peak,
                         "launches": launches, "want_launches": want,
                         "flops_real": flops_real,
                         "logits_rel_l2_vs_decode_step": err_direct,
                         "logits_rel_l2_vs_plain": err, "trace": trace}
    # the same contents in page pools: slot i's pages 1 + 128 i + j
    pcfg = cfg.with_(decode_attn_impl="paged_pallas")
    pcell = build_cell(pcfg, shape, mesh)
    page = 256
    pps = s // page
    pcache = pcell.lm.init_paged_cache(b, b * pps + 1, pps, page_size=page)
    bt = pcache[0]["blk0"]["kv"]["block_table"]
    bt.copy_((1 + torch.arange(b * pps, device="cuda")).view(b, pps))
    for grp, pgrp in zip(cache, pcache):
        for name, node in grp.items():
            for k in ("k", "v"):
                pages = pgrp[name]["kv"][f"{k}_pages"]
                pages[1:].view(b, pps, page, *pages.shape[2:]).copy_(
                    node["kv"][k].view(b, pps, page, *pages.shape[2:]))
    del cache
    torch.cuda.empty_cache()
    _setup_peak_gb()
    _reset_launches()
    (logits_p, _), walls = _cell_walls(
        lambda: pcell.fn(params, tok, pcache, pos), CELL_REPS)
    want = _cell_launches(cfg.num_layers, CELL_REPS, True, False, True)
    launches = _cell_take(want, "decode_32k paged")
    peak = torch.cuda.max_memory_allocated() / 1e9
    direct, _ = pcell.lm.decode_step(params, tok, pcache, pos)
    err = _rel_l2_all(logits_p.float().cpu().numpy(),
                      direct.float().cpu().numpy())
    if not err <= LOGIT_REL_L2:
        raise AssertionError(f"(a) decode_32k paged cell vs "
                             f"LM.decode_step: {err:.3e}")
    plain, _ = _swap_plain(lambda: pcell.lm.decode_step(params, tok, pcache,
                                                        pos),
                           ("attention", "norm"))
    lp = logits_p.float().cpu().numpy()
    out["paged"] = {"wall_ms": statistics.median(walls), "walls": walls,
                    "peak_gb": peak, "launches": launches,
                    "want_launches": want,
                    "logits_rel_l2_vs_decode_step": err,
                    # bf16 over 16 random layers: B1 / B7 against their
                    # plain versions, and against the contiguous cell's
                    # attention, recorded (each B1 call is held element by
                    # element at this shape in _cells_kernel_rows)
                    "logits_rel_l2_vs_plain": _rel_l2_all(
                        lp, plain.float().cpu().numpy()),
                    "logits_rel_l2_vs_contiguous": _rel_l2_all(
                        lp, logits_c.float().cpu().numpy()),
                    "trace": traces["paged"].result()}
    del pcache
    torch.cuda.empty_cache()
    return out


def _cells_kernel_rows(records: list) -> dict:
    """B3 at 1 x 32,768 causal and B1 at 16 slots x 32,768, llama3.2-1b's
    heads (32 over 8, D 64): held element by element (B3 against the
    chunked plain version: the plain version's 32,768^2 scores would take
    137 GB), timed beside the plain version, SDPA and the bound."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops as pops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(SEED + 30)
    h, kh, d = 32, 8, 64
    b, s = CELL_PREFILL
    q, k, v = _flash_inputs(b, s, torch.bfloat16, g, device, h, kh, d)
    out = fops.flash_attention(q, k, v)
    chunked = _chunked_plain()
    # the plain side in fp32 on the bf16 operands, as attention_ref holds
    # B3 in phase 4 (a bf16-rounded plain output would add its own ulp)
    ref = chunked(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    held = [check_close(f"B3 {b} x {s} H{h}/{kh} D{d} causal vs chunked "
                        "(fp32, bf16 bar)", out, ref,
                        v.float().pow(2).mean().sqrt().item(), "bfloat16")]
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * b * h * d * (s * (s + 1) // 2)
    copies = [(q, k, v), _flash_inputs(b, s, torch.bfloat16, g, device, h,
                                       kh, d)]
    rows = {"3c": {
        "shape": f"{b} x {s}, H{h}/{kh} D{d}, causal",
        "max_abs_err": (out.float() - ref.float()).abs().max().item(),
        "ms": time_ms(lambda a, b_, c: fops.flash_attention(a, b_, c),
                      copies, reps=5, rounds=3),
        "plain_ms": time_ms(chunked, copies, reps=1, rounds=3),
        "plain": "chunked attention (blocks of 1,024)",
        "library_ms": time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a.transpose(1, 2), b_.transpose(1, 2), c.transpose(1, 2),
            is_causal=True, enable_gqa=True), copies, reps=5, rounds=3),
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, flops, "bfloat16")))}}
    del copies, q, k, v, out, ref
    bs, s = CELL_DECODE
    lengths = [s] * bs
    args = _paged_inputs("bfloat16", g, device, lengths, h, kh, d,
                         pps=s // 256)
    out = pops.paged_attention(*args)
    ref = paged_attention_ref(*args)
    torch.cuda.synchronize()
    held.append(check_close(f"B1 {bs} slots x {s} H{h}/{kh} D{d}", out, ref,
                            args[2].float().pow(2).mean().sqrt().item()))
    nbytes, flops = paged_bytes_flops(args[0], args[1], args[3], args[4],
                                      args[5])
    copies = [args, _paged_inputs("bfloat16", g, device, lengths, h, kh, d,
                                  pps=s // 256)]
    q_, kp, vp, bt, _, _, _ = args
    kc = kp[bt.long()].reshape(bs, s, kh, d).transpose(1, 2).contiguous()
    vc = vp[bt.long()].reshape(bs, s, kh, d).transpose(1, 2).contiguous()
    rows["1c"] = {
        "shape": f"{bs} slots x {s}, H{h}/{kh} D{d}",
        "max_abs_err": (out.float() - ref.float()).abs().max().item(),
        "ms": time_ms(pops.paged_attention, copies, reps=10, rounds=3),
        "plain_ms": time_ms(paged_attention_ref, copies, reps=2, rounds=3),
        "library_ms": time_ms(
            lambda qq, kk, vv: F.scaled_dot_product_attention(
                qq, kk, vv, enable_gqa=True),
            [(q_[:, :, None, :], kc, vc)], reps=10, rounds=3),
        "library": "SDPA over the gathered context",
        **dict(zip(("bound_ms", "bound_by"),
                   bound(nbytes, flops, "bfloat16")))}
    del copies, args, kc, vc
    torch.cuda.empty_cache()
    for rec in records:
        if rec["name"] == "flash_attention":
            rec["cells_prefill_32k"] = rows["3c"]
        if rec["name"] == "paged_attention":
            rec["cells_decode_32k"] = rows["1c"]
    return {"rows": rows, "held": held}


def _cells_prefill_config(cfg):
    return cfg.with_(attn_q_block=CELL_ATTN_BLOCK,
                     attn_kv_block=CELL_ATTN_BLOCK)


def _cells_traces(pool, cfg) -> dict:
    """The meta traces of (a)'s cells, submitted to ``pool`` (host
    processes: they run while the card runs the cells)."""
    from repro_torch.configs import ShapeConfig
    dec = ShapeConfig("decode_32k", CELL_DECODE[1], CELL_DECODE[0], "decode")
    jobs = {"train": (cfg, ShapeConfig("train_4k", CELL_TRAIN_SEQ,
                                       CELL_TRAIN_ROWS, "train")),
            "prefill": (_cells_prefill_config(cfg),
                        ShapeConfig("prefill_32k", CELL_PREFILL[1],
                                    CELL_PREFILL[0], "prefill")),
            "decode": (cfg, dec),
            "paged": (cfg.with_(decode_attn_impl="paged_pallas"), dec)}
    return {k: pool.submit(_cell_trace, *a) for k, a in jobs.items()}


def _cells_one_rank(records: list, smi: str) -> dict:
    """27 (a): llama3.2-1b's dry-run cells on one rank at full width and
    depth; their meta traces run meanwhile in two host processes."""
    torch = _torch()
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    with ProcessPoolExecutor(2, mp_context=mp.get_context("spawn")) as pool:
        traces = _cells_traces(pool, cfg)
        kern = _cells_kernel_rows(records)
        mesh = make_host_mesh(device="cuda")
        params = LM(cfg, device="cuda").init(SEED)
        out = {"kernels": kern,
               "train": _cells_train(cfg, mesh, params, traces),
               "prefill": _cells_prefill(cfg, mesh, params, traces),
               "decode": _cells_decode(cfg, mesh, params, traces)}
    del params
    torch.cuda.empty_cache()
    tr = out["train"]
    print(f"[27 cells] (a) {smi}: {TRAIN_ARCH} {cfg.num_layers}L bf16 on "
          f"{mesh.describe()}; {' | '.join(kern['held'])}; "
          + "; ".join(f"{k} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
                      f"SDPA {r['library_ms']:.4f}, bound {r['bound_ms']:.4f}"
                      f" ({r['bound_by']}) [{r['shape']}]"
                      for k, r in kern["rows"].items()))
    print(f"[27 cells] (a) train_4k reduced to {tr['rows']} x "
          f"{CELL_TRAIN_SEQ} rows (of 256; the card holds {tr['holds_rows']}"
          f" at {CELL_MEM_SHARE:g} of its memory: {tr['per_row_gb']:.2f} GB "
          f"a row over {tr['fixed_gb']:.2f} GB of weights, state and "
          f"gradients, from the peaks of {CELL_TRAIN_ROWS // 2}- and "
          f"{CELL_TRAIN_ROWS}-row steps, over {tr['static_gb']:.2f} GB "
          f"before a step; run at {tr['rows']} for the phase's time): loss "
          f"{tr['loss']:.6f} vs LM.loss "
          f"{tr['loss_ref']:.6f}; FLOPs of a real step {tr['flops_real']:.6g}"
          f" == the meta trace's; " + _cell_line("train_4k", tr))
    pf = out["prefill"]
    print(f"[27 cells] (a) prefill_32k reduced to {CELL_PREFILL[0]} x "
          f"{CELL_PREFILL[1]} (of 32 rows): logits vs LM.prefill "
          f"{pf['logits_rel_l2_vs_prefill']:.3e}, vs plain (chunked "
          f"attention, plain RMSNorm) {pf['logits_rel_l2_vs_plain']:.3e}; "
          + _cell_line("prefill_32k", pf))
    dc, dp = out["decode"]["contiguous"], out["decode"]["paged"]
    print(f"[27 cells] (a) decode_32k reduced to {CELL_DECODE[0]} x "
          f"{CELL_DECODE[1]} (of 128 rows): contiguous logits vs "
          f"LM.decode_step {dc['logits_rel_l2_vs_decode_step']:.3e}, vs "
          f"plain RMSNorm {dc['logits_rel_l2_vs_plain']:.3e}, FLOPs of a "
          f"real step "
          f"{dc['flops_real']:.6g} == the meta trace's; "
          + _cell_line("contiguous", dc) + f" | paged logits vs "
          f"LM.decode_step {dp['logits_rel_l2_vs_decode_step']:.3e}; not "
          f"held: vs the plain versions (B1, B7) "
          f"{dp['logits_rel_l2_vs_plain']:.3e}, vs the contiguous cell's "
          f"{dp['logits_rel_l2_vs_contiguous']:.3e}; "
          + _cell_line("paged", dp))
    out["wall_s"] = time.perf_counter() - t0
    return out


def _cp_cache(cfg, b: int, s: int, lo: int, hi: int) -> list:
    """Positions [lo, hi) of a (b, s) contiguous cache of random K / V,
    each layer from its own generator (every rank and the single rank
    draw the same values)."""
    torch = _torch()
    from repro_torch.models.layers import dtype_of
    a = cfg.attention
    shape = (b, s, a.num_kv_heads, a.head_dim)
    dt = dtype_of(cfg.dtype)
    out = []
    for layer in range(cfg.num_layers):
        g = torch.Generator(device="cuda").manual_seed(SEED * 1000 + layer)
        node = {}
        for name in ("k", "v"):
            whole = torch.randn(shape, generator=g, device="cuda").to(dt)
            node[name] = whole[:, lo:hi].clone()
            del whole
        out.append({"blk0": {"kv": node}})
    return out


def _cp_inputs(cfg) -> tuple:
    torch = _torch()
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    toks = torch.randint(0, cfg.vocab_size, (CP_STEPS, CP_BATCH),
                         generator=g, device="cuda").int()
    pos = torch.tensor(CP_POS, device="cuda").int()
    return toks, pos


def _cp_configs():
    from repro_torch.configs import get_config
    cfg = get_config(CP_ARCH).with_(decode_attn_impl="cp")
    return {"bf16": cfg,
            "f32": cfg.with_(dtype="float32", num_layers=CP_F32_LAYERS)}


def _cp_steps(step, cfg) -> dict:
    """CP_STEPS decode steps of ``step(token, pos)``: logits, walls."""
    toks, pos = _cp_inputs(cfg)
    logits, walls = [], []
    for i in range(CP_STEPS):
        out, w = _cell_walls(lambda: step(toks[i], pos + i), 1)
        logits.append(out.float().cpu().numpy())
        walls += w
    return {"logits": logits, "walls": walls}


def _cp_rank(rank: int) -> dict:
    """One of the four ranks of 27 (b): the decode cell with cp, this
    rank's quarter of the cache's sequence."""
    torch = _torch()
    from repro_torch.configs import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import shard_params
    missing = [n for n in build.SOURCES if not build.lib_path(n).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels {missing} not built")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    mesh = make_host_mesh(model=CP_RANKS, device="cuda")
    n = CP_SEQ // CP_RANKS
    lo = mesh.model_rank * n
    out = {"mesh": mesh.describe()}
    kept = {}
    for key, cfg in _cp_configs().items():
        cell = build_cell(cfg, ShapeConfig("decode_32k", CP_SEQ, CP_BATCH,
                                           "decode"), mesh)
        whole = LM(cfg, device="cuda").init(SEED)
        params = shard_params(whole, cell.in_shardings[0], mesh)
        kept[key] = params
        del whole
        torch.cuda.empty_cache()
        cache = _cp_cache(cfg, CP_BATCH, CP_SEQ, lo, lo + n)
        before = mesh.stats.copy()
        r = _cp_steps(lambda t, p: cell.fn(params, t, cache, p)[0], cfg)
        calls = mesh.stats.since(before)
        r["calls"] = {k: v / CP_STEPS for k, v in calls.count_by_op.items()
                      if v}
        r["bytes"] = {k: v / CP_STEPS for k, v in calls.bytes_by_op.items()
                      if v}
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[key] = r
        del params, cache
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    # phase 28 on the same ranks and the same pieces of the weights, then
    # phase 29 on the same ranks (qwen2's pieces freed first)
    out["p28"] = _whole_rank(mesh, kept)
    kept.clear()
    gc.collect()
    torch.cuda.empty_cache()
    out["p29"] = _ssm_rank(mesh)
    return out


def _cp_one_rank() -> dict:
    """The single rank of 27 (b): ``LM.decode_step`` over the whole
    cache, the same weights, tokens and positions; and its witness: the
    same steps under a tensor-parallel scope of one rank, so that each
    layer takes the context-parallel step over one shard (fp32
    probabilities into the V product, where the eager decode rounds them
    to bf16) and the row-split linears their fp32 partial rounded once
    (where one rank rounds cuBLAS's bf16 product): a rank's arithmetic
    without the split, which leaves only the fp32 sums' order."""
    torch = _torch()
    from repro_torch.models.model import LM
    out = {}
    for key, cfg in _cp_configs().items():
        lm = LM(cfg.with_(decode_attn_impl="eager"), device="cuda")
        params = lm.prepare(lm.init(SEED))
        cache = _cp_cache(cfg, CP_BATCH, CP_SEQ, 0, CP_SEQ)
        torch.cuda.reset_peak_memory_stats()
        out[key] = _cp_steps(
            lambda t, p: lm.decode_step(params, t, cache, p)[0], cfg)
        out[key]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rank_math = LM(cfg, device="cuda")          # decode_attn_impl="cp"
        out[key]["witness"] = _as_one_rank(lambda: _cp_steps(
            lambda t, p: rank_math.decode_step(params, t, cache, p)[0],
            cfg)["logits"])
        del cache
        torch.cuda.empty_cache()
        # phase 28's single rank, on the same weights (without the
        # serving copy of the head)
        params.pop("head_f32")
        out[key]["p28"] = _whole_one_rank(cfg, params,
                                          train=key == "bf16")
        del params
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 28: head counts the model axis does not divide, in prefill and
# training (the whole-heads arm), on 27 (b)'s four ranks


def _wh_tokens(cfg):
    """(a)'s prompts and (b)'s batch, from SEED (the ranks and the single
    rank draw the same)."""
    torch = _torch()
    g = torch.Generator(device="cuda").manual_seed(SEED + 40)
    toks = torch.randint(0, cfg.vocab_size, (WH_ROWS, WH_SEQ + 1),
                         generator=g, device="cuda")
    mask = (torch.rand((WH_ROWS, WH_SEQ), generator=g, device="cuda")
            < 0.9).float()
    return toks[:, :-1].int(), {"tokens": toks[:, :-1].int(),
                                "labels": toks[:, 1:].int(), "mask": mask}


def _wh_shape(mode: str):
    from repro_torch.configs import ShapeConfig
    name = "prefill_32k" if mode == "prefill" else "train_4k"
    return ShapeConfig(name, WH_SEQ, WH_ROWS, mode)


def _wh_calls(mesh, before) -> dict:
    calls = mesh.stats.since(before)
    return {k: (calls.count_by_op[k], calls.bytes_by_op[k])
            for k in sorted(calls.count_by_op) if calls.count_by_op[k]}


def _wh_held(fn) -> tuple:
    """``fn()`` with every B3 and B7 call also computed by its plain
    version on the same inputs and held element by element (B3 against
    the plain attention in fp32 on the bf16 operands at the bf16 bar, as
    phase 4 holds it; B7 within one bf16 ulp, as phase 12); the forward
    goes on with the kernel's output.  Returns (fn's result, {kernel:
    calls held}, the worst share of a limit)."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    calls = {"flash_attention": 0, "rmsnorm": 0}
    worst = [0.0]
    b3, b7 = fops.flash_attention, rops.rmsnorm

    def flash(q, k, v, causal=True, window=None):
        out = b3(q, k, v, causal=causal, window=window)
        ref = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                            window=window)
        _, w = check_close_share(
            f"B3 call {calls['flash_attention']} {tuple(q.shape)}", out,
            ref, v.float().pow(2).mean().sqrt().item(), "bfloat16")
        worst[0] = max(worst[0], w)
        calls["flash_attention"] += 1
        return out

    def norm(x, scale, eps=1e-5):
        out = b7(x, scale, eps)
        worst[0] = max(worst[0], _within_one_ulp(
            f"B7 call {calls['rmsnorm']} {tuple(x.shape)}", out,
            rmsnorm_ref(x, scale, eps).cpu()))
        calls["rmsnorm"] += 1
        return out

    fops.flash_attention, rops.rmsnorm = flash, norm
    try:
        return fn(), calls, worst[0]
    finally:
        fops.flash_attention, rops.rmsnorm = b3, b7


def _wh_prefill(cfg, params, mesh) -> dict:
    """(a) on one rank of ``mesh`` (or the single rank, ``mesh`` of one):
    ``launch.steps``' prefill cell of ``cfg`` at 4 x 512 on this rank's
    pieces.  bf16: the launches and collectives of one counted prefill
    (every B3 / B7 call held), then WH_REPS timed runs.  Returns the last
    token's logits."""
    torch = _torch()
    from repro_torch.launch.steps import build_cell
    cell = build_cell(cfg, _wh_shape("prefill"), mesh)
    tokens, _ = _wh_tokens(cfg)

    def run():
        return cell.fn(params, tokens, cell.lm.init_cache(WH_ROWS,
                                                          WH_SEQ))[0]
    out = {}
    if cfg.dtype == "bfloat16":
        before = mesh.stats.copy()
        _reset_launches()
        logits, held, worst = _wh_held(run)
        torch.cuda.synchronize()
        out.update(launches={k: v for k, v in _read_launches().items() if v},
                   held=held, held_worst=worst, calls=_wh_calls(mesh, before))
        _, out["walls"] = _cell_walls(run, WH_REPS)
    else:
        logits = run()
    out["logits"] = logits.float().cpu().numpy()
    return out


def _wh_train(cfg, params, mesh, steps: int = WH_TRAIN_STEPS) -> dict:
    """(b) on one rank of ``mesh`` (or the single rank): ``launch.steps``'
    train cell of ``cfg`` at 4 x 512, ``steps`` steps of the same batch
    (the parameters and AdamW's state updated in place): each step's
    loss and wall, the peak, and the collectives a step."""
    torch = _torch()
    from repro_torch.launch.steps import build_cell
    from repro_torch.optim.adamw import init_adamw
    cell = build_cell(cfg, _wh_shape("train"), mesh)
    _, batch = _wh_tokens(cfg)
    opt = init_adamw(params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    before = mesh.stats.copy()
    losses, walls = [], []
    for _ in range(steps):
        (_, _, metrics), w = _cell_walls(
            lambda: cell.fn(params, opt, batch), 1)
        losses.append(float(metrics["loss"]))
        walls += w
    calls = _wh_calls(mesh, before)
    return {"losses": losses, "walls": walls,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "calls": {k: (n / steps, b / steps)
                      for k, (n, b) in calls.items()},
            "launches": _no_launches("(b) a training rank")}


def _wh_grads(cfg, params, mesh, rank: int) -> dict:
    """(b)'s float32 arm: the first batch's gradient of this rank's pieces
    (``train.loop.sharded_grads`` on the train cell's placements),
    gathered whole on every rank; rank 0 holds every leaf to one rank's
    ``loss_and_grads`` on the whole weights, and the loss."""
    torch = _torch()
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import gather_leaf
    from repro_torch.train.loop import loss_and_grads, sharded_grads
    from repro_torch.tree import leaves_with_path, tree_map
    cell = build_cell(cfg, _wh_shape("train"), mesh)
    _, batch = _wh_tokens(cfg)
    before = mesh.stats.copy()
    pieces, metrics = sharded_grads(cell.lm, params, batch, mesh,
                                    cell.in_shardings[0], local_batch=True)
    calls = _wh_calls(mesh, before)
    whole = tree_map(lambda g, s: None if g is None
                     else gather_leaf(g, s, mesh), pieces,
                     cell.in_shardings[0])
    del pieces
    if rank != 0:
        return {"calls": calls}
    lm = LM(cfg, device="cuda")
    loss, _, want = loss_and_grads(lm, lm.init(SEED), batch)
    want = dict(leaves_with_path(want))
    errs = {}
    for path, g in leaves_with_path(whole):
        if g is None:
            continue
        w = want[path].float()
        den = float(w.norm())
        errs[path] = float((g.float() - w).norm()) / den if den \
            else float(g.norm())
    worst = max(errs, key=errs.get)
    return {"calls": calls, "leaves": len(errs), "worst_leaf": worst,
            "worst_rel_l2": errs[worst], "loss": float(metrics["loss"]),
            "one_loss": float(loss)}


def _whole_rank(mesh, params: dict) -> dict:
    """Phase 28 on one of 27 (b)'s four ranks, on the pieces of 27 (b)'s
    weights (``params``: "bf16" at full depth, "f32" at CP_F32_LAYERS
    layers): (a) the prefill cell, (b) the train cell (last: it updates
    the weights in place) and the float32 gradient."""
    torch = _torch()
    t0 = time.perf_counter()
    cfgs = _cp_configs()
    out = {"a": _wh_prefill(cfgs["bf16"], params["bf16"], mesh),
           "a_f32": _wh_prefill(cfgs["f32"], params["f32"], mesh)}
    out["b_f32"] = _wh_grads(cfgs["f32"], params["f32"], mesh,
                             mesh.model_rank)
    out["b"] = _wh_train(cfgs["bf16"], params["bf16"], mesh)
    del params
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def _whole_one_rank(cfg, params, *, train: bool) -> dict:
    """Phase 28's single rank in this process, on 27 (b)'s weights: (a)'s
    prefill cell, and for bf16 (b)'s train cell (last: it updates
    ``params`` in place)."""
    from repro_torch.launch.mesh import make_host_mesh
    one = make_host_mesh(device="cuda")
    out = {"a": _wh_prefill(cfg, params, one)}
    if train:
        out["b"] = _wh_train(cfg, params, one)
    return out


def _wh_kernel_row(records: list) -> dict:
    """B3 at a phase 28 rank's shape (4 x 512 causal, every one of
    qwen2-1.5b's 12 heads over 2, D 128; row 3 is 8 x 512): held, timed
    beside the plain version, SDPA and the bound."""
    torch = _torch()
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    b, s, (h, kh, d) = WH_ROWS, WH_SEQ, (12, 2, 128)
    q, k, v = _flash_inputs(b, s, torch.bfloat16, g, "cuda", h, kh, d)
    out = fops.flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    torch.cuda.synchronize()
    line = check_close(f"B3 {b} x {s} H{h}/{kh} D{d} causal", out, ref, 1.0)
    copies = [_flash_inputs(b, s, torch.bfloat16, g, "cuda", h, kh, d)
              for _ in range(8)]
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4.0 * b * h * d * flash_pairs(s, s, True, None)
    row = {"shape": f"{b} x {s}, H{h}/{kh} D{d}, causal",
           "max_abs_err": (out.float() - ref.float()).abs().max().item(),
           "ms": time_ms(lambda a, b_, c: fops.flash_attention(a, b_, c),
                         copies),
           "plain_ms": time_ms(lambda a, b_, c: attention_ref(a, b_, c),
                               copies, reps=5, rounds=3),
           "library_ms": time_ms(
               lambda a, b_, c: F.scaled_dot_product_attention(
                   a.transpose(1, 2), b_.transpose(1, 2),
                   c.transpose(1, 2), is_causal=True, enable_gqa=True),
               copies),
           **dict(zip(("bound_ms", "bound_by"),
                      bound(nbytes, flops, "bfloat16")))}
    del copies
    torch.cuda.empty_cache()
    return {"row": row, "line": line}


# ---------------------------------------------------------------------------
# Phase 29: RWKV-6 blocks over a rank's heads and Mamba blocks over its
# channels (ROADMAP A8.6, C.5), on 27 (b)'s four ranks


SSM_ARCH = "rwkv6-1.6b"
SSM_ROWS, SSM_SEQ = 4, 512      # (a) prefill, (b) train, (c) the mixer
SSM_DECODE = 8                  # (a), (c): decode steps after the prefill
SSM_TRAIN_STEPS = 2             # (b)
SSM_REPS = 1                    # (a): timed prefill after the counted one
SSM_F32_LAYERS = 2
SSM_LOGIT_REL_L2 = 2e-2         # (a), (c) bf16 a row vs one rank's
SSM_F32_REL_L2 = 1e-5           # (c) float32 output and state
#: (a) float32 logits: ROADMAP C, trap 6 (the gate is rounded to bf16
#: before wout, so a rounding-level change upstream moves what follows by
#: up to a bf16 ulp), and B8's products are TF32 on the card
SSM_F32_LOGIT_REL_L2 = 1e-2
#: (a) float32 states: within SSM_F32_STATE_FACTOR x the TF32 witness
#: (one rank's B8 against its plain fp32 WKV) or SSM_F32_REL_L2, the
#: larger: a rank's other summation order re-rolls B8's TF32 roundings,
#: and trap 6 carries a flip into the next layer's x_prev
SSM_F32_STATE_FACTOR = 4.0
SSM_FLOOR_FACTOR = 3.0          # (b) float32 gradients: trap 9
#: (a): a rank's collectives a bf16 prefill and a decode step of 4 rows:
#: the last token's logits gathered (16,384 fp32 a row; x_prev is whole
#: on every rank, so no gather a layer); 24 x (wout, down) + the
#: embedding's sum, each an fp32 partial of 4 x T x 2,048 (PERF.md §6)
SSM_PREDICTED = {
    "prefill": {"all-gather/model": (1, 262_144.0),
                "all-reduce/model": (49, 822_083_584.0)},
    "decode": {"all-gather/model": (1, 262_144.0),
               "all-reduce/model": (49, 1_605_632.0)}}
#: (a): a rank's launches a prefill (B8 a layer over the rank's 8 heads)
#: and a decode step (none: the one-token WKV is plain torch, as in the
#: reference); rwkv6-1.6b's norms are LayerNorms, plain in both packages,
#: so B7 (RMSNorm) launches none
SSM_LAUNCHES = {"prefill": {"wkv6": 24}, "decode": {}}
#: (c): one jamba Mamba mixer (d 8,192, d_inner 16,384: 4,096 channels a
#: rank): a rank's collectives a call, predicted in PERF.md §6 before the
#: first run: in_proj's column piece gathered (4 x T x 8,192 bf16),
#: x_proj's (4 x T x 544) and out_proj's (4 x T x 8,192) fp32 partials
MIX_PREDICTED = {
    "prefill": {"all-gather/model": (1, 33_554_432.0),
                "all-reduce/model": (2, 71_565_312.0)},
    "decode": {"all-gather/model": (1, 65_536.0),
               "all-reduce/model": (2, 139_776.0)}}


def _ssm_configs():
    from repro_torch.configs import get_config
    cfg = get_config(SSM_ARCH)
    return {"bf16": cfg,
            "f32": cfg.with_(dtype="float32", num_layers=SSM_F32_LAYERS)}


def _ssm_shape(mode: str):
    from repro_torch.configs import ShapeConfig
    if mode == "decode":
        return ShapeConfig("decode_32k", SSM_SEQ + SSM_DECODE, SSM_ROWS,
                           "decode")
    return _wh_shape(mode)


def _ssm_inputs(cfg) -> tuple:
    """(a)'s prompts (the rows of (b)'s batch) and decode tokens, from
    SEED (the ranks and the single rank draw the same)."""
    torch = _torch()
    tokens, _ = _wh_tokens(cfg)
    g = torch.Generator(device="cuda").manual_seed(SEED + 50)
    nxt = torch.randint(0, cfg.vocab_size, (SSM_DECODE, SSM_ROWS),
                        generator=g, device="cuda").int()
    return tokens, nxt


def _ssm_states(cache) -> list:
    """Every recurrent state leaf of a cache, on the host."""
    return [{blk: {k: v.float().cpu() for k, v in node["state"].items()}
             for blk, node in group.items()} for group in cache]


def _ssm_pieces(cfg, mesh) -> dict:
    """The whole model from SEED on the card, cut to this rank's pieces
    of the prefill cell's placements."""
    torch = _torch()
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import shard_params
    cell = build_cell(cfg, _ssm_shape("prefill"), mesh)
    whole = LM(cfg, device="cuda").init(SEED)
    params = shard_params(whole, cell.in_shardings[0], mesh)
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    return params


def _ssm_serve(cfg, params, mesh, *, counted: bool) -> dict:
    """(a) on one rank of ``mesh`` (or the single rank, ``mesh`` of one):
    ``launch.steps``' prefill cell of ``cfg`` at 4 x 512 on this rank's
    pieces, then SSM_DECODE steps of the decode cell.  ``counted``: every
    B8 call of the prefill held (phase 13's ``_wkv6_calls_vs_plain``), and
    each call's collectives and launches.  The logits of the last prompt token and of
    each step on the host; a float32 run also its states; bf16 the walls
    of SSM_REPS more prefills and of each step."""
    torch = _torch()
    from repro_torch.launch.steps import build_cell
    pre = build_cell(cfg, _ssm_shape("prefill"), mesh)
    dec = build_cell(cfg, _ssm_shape("decode"), mesh)
    tokens, nxt = _ssm_inputs(cfg)
    bf16 = cfg.dtype == "bfloat16"

    def prefill():
        return pre.fn(params, tokens,
                      pre.lm.init_cache(SSM_ROWS, SSM_SEQ + SSM_DECODE))
    out = {"calls": [], "launches": []}
    before = mesh.stats.copy()
    _reset_launches()
    if counted and bf16:
        (logits, cache), n, out["held_worst"] = _wkv6_calls_vs_plain(
            prefill)
        out["held"] = {"wkv6": n}
    else:
        logits, cache = prefill()
    torch.cuda.synchronize()
    out["launches"].append({k: v for k, v in _read_launches().items() if v})
    out["calls"].append(_wh_calls(mesh, before))
    out["logits"] = [logits.float().cpu().numpy()]
    out["states"] = [] if bf16 else [_ssm_states(cache)]
    out["step_walls"] = []
    for i in range(SSM_DECODE):
        pos = torch.full((SSM_ROWS,), SSM_SEQ + i, dtype=torch.int32,
                         device="cuda")
        before = mesh.stats.copy()
        _reset_launches()
        (logits, cache), w = _cell_walls(
            lambda: dec.fn(params, nxt[i], cache, pos), 1)
        out["launches"].append({k: v for k, v in _read_launches().items()
                                if v})
        out["calls"].append(_wh_calls(mesh, before))
        out["logits"].append(logits.float().cpu().numpy())
        out["step_walls"] += w
        if not bf16:
            out["states"].append(_ssm_states(cache))
    del cache
    if bf16:
        _, out["prefill_walls"] = _cell_walls(lambda: prefill()[0],
                                              SSM_REPS)
    return out


def _one_mesh():
    """A mesh of one rank that needs no process group (a rank's one-rank
    arithmetic inside a world)."""
    torch = _torch()
    from repro_torch.launch.mesh import Mesh
    return Mesh(shape={"data": 1, "model": 1},
                coords={"data": 0, "model": 0}, device=torch.device("cuda"))


def _as_one_rank(fn):
    """``fn()`` with every ``LM`` forward under a tensor-parallel scope of
    one rank: a rank's arithmetic (row-split linears as fp32 partials
    rounded once) without the split (ROADMAP C, trap 10's witness)."""
    from repro_torch.models import model as model_mod
    scope, one = model_mod.tensor_parallel, _one_mesh()
    model_mod.tensor_parallel = lambda mesh, impl="kv_shard": scope(one,
                                                                     impl)
    try:
        return fn()
    finally:
        model_mod.tensor_parallel = scope


def _ssm_grads(cfg, params, mesh, rank: int) -> dict:
    """(b)'s float32 arm: the first batch's gradient of this rank's pieces
    (``train.loop.sharded_grads`` on the train cell's placements),
    gathered whole on every rank.  Rank 0 holds every leaf to one rank's
    ``loss_and_grads`` on the whole weights within 1e-4, or
    SSM_FLOOR_FACTOR x the larger of two summation-order floors
    measured on one rank (trap 9): the gradient as the mask-weighted mean
    of two half batches', and under one rank's tensor-parallel
    arithmetic (RWKV-6 rounds its gate to bf16 before ``wout``, trap 6,
    so an fp32 ulp there can move a gradient by more than 1e-4)."""
    torch = _torch()
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.model import LM
    from repro_torch.sharding.rules import gather_leaf
    from repro_torch.train.loop import loss_and_grads, sharded_grads
    from repro_torch.tree import leaves_with_path, tree_map
    cell = build_cell(cfg, _wh_shape("train"), mesh)
    _, batch = _wh_tokens(cfg)
    before = mesh.stats.copy()
    pieces, metrics = sharded_grads(cell.lm, params, batch, mesh,
                                    cell.in_shardings[0], local_batch=True)
    calls = _wh_calls(mesh, before)
    whole = tree_map(lambda g, s: None if g is None
                     else gather_leaf(g, s, mesh), pieces,
                     cell.in_shardings[0])
    del pieces
    if rank != 0:
        return {"calls": calls}
    lm = LM(cfg, device="cuda")
    p1 = lm.init(SEED)
    loss, _, want = loss_and_grads(lm, p1, batch)
    n = batch["mask"].sum(1)
    half = SSM_ROWS // 2
    halves = [loss_and_grads(lm, p1, {k: v[i * half:(i + 1) * half]
                                      for k, v in batch.items()})[2]
              for i in range(2)]
    w0, w1 = n[:half].sum() / n.sum(), n[half:].sum() / n.sum()
    again = dict(leaves_with_path(tree_map(
        lambda a, b: None if a is None else w0 * a.float() + w1 * b.float(),
        *halves)))
    witness = dict(leaves_with_path(_as_one_rank(
        lambda: loss_and_grads(lm, p1, batch)[2])))
    del halves, p1
    want = dict(leaves_with_path(want))

    def rel(g, w):
        den = float(w.norm())
        return float((g.float() - w).norm()) / den if den \
            else float(g.float().norm())
    errs, limits = {}, {}
    for path, g in leaves_with_path(whole):
        if g is None:
            continue
        w = want[path].float()
        errs[path] = rel(g, w)
        limits[path] = max(WH_F32_GRAD_REL_L2, SSM_FLOOR_FACTOR * max(
            rel(again[path], w), rel(witness[path], w)))
    share = {p: errs[p] / limits[p] for p in errs}
    worst = max(share, key=share.get)
    return {"calls": calls, "leaves": len(errs), "worst_leaf": worst,
            "worst_rel_l2": errs[worst], "worst_limit": limits[worst],
            "worst_share": share[worst],
            "worst_any": max(errs.values()),
            "above_1e-4": sum(e > WH_F32_GRAD_REL_L2 for e in errs.values()),
            "loss": float(metrics["loss"]), "one_loss": float(loss)}


def _mix_inputs(dt) -> tuple:
    """(c)'s jamba mixer from SEED (every rank draws the same whole one),
    its prompt (4 x 512) and decode steps' tokens, in ``dt``."""
    torch = _torch()
    from repro_torch.models import ssm
    cfg = _jamba_config()
    s, dm = cfg.ssm, cfg.d_model
    g = torch.Generator(device="cuda").manual_seed(SEED + 223)
    p = ssm.init_mamba(g, dm, s, dt, torch.device("cuda"))
    x = torch.randn((SSM_ROWS, SSM_SEQ, dm), generator=g,
                    device="cuda").to(dt)
    xt = torch.randn((SSM_DECODE, SSM_ROWS, 1, dm), generator=g,
                     device="cuda").to(dt)
    return s, p, x, xt


def _mix_run(p, s, x, xt, state, mesh=None) -> dict:
    """A prefill of ``x`` then a decode step a token of ``xt``: outputs
    and states (and, with ``mesh``, under its tensor-parallel scope: each
    call's collectives and wall)."""
    torch = _torch()
    from repro_torch.models import ssm
    from repro_torch.sharding.collectives import tensor_parallel
    out = {"y": [], "states": [], "calls": [], "walls": []}
    with torch.no_grad(), tensor_parallel(mesh):
        for i in range(1 + SSM_DECODE):
            before = mesh.stats.copy() if mesh is not None else None
            fn = ssm.mamba_forward if i == 0 else ssm.mamba_decode
            (y, state), w = _cell_walls(
                lambda: fn(p, x if i == 0 else xt[i - 1], s, state), 1)
            out["y"].append(y.float())
            out["states"].append({k: v.float() for k, v in state.items()})
            out["walls"] += w
            if mesh is not None:
                out["calls"].append(_wh_calls(mesh, before))
    return out


def _mix_rank(mesh) -> dict:
    """(c) on one rank: jamba's Mamba mixer at full width over the rank's
    4,096 channels, a 4 x 512 prefill and SSM_DECODE decode steps, in
    bf16 and float32; held here against the whole mixer on one rank (and
    bf16 against that rank's witness, its one-rank arithmetic under a
    scope of one): outputs whole, states the rank's slice."""
    torch = _torch()
    from repro_torch.models import ssm
    from repro_torch.sharding.rules import make_param_specs, shard_params
    out = {}
    for key, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        s, p, x, xt = _mix_inputs(dt)
        tree = {"blk": {"mamba": p}}
        local = shard_params(tree, make_param_specs(tree, mesh),
                             mesh)["blk"]["mamba"]
        b, dm = SSM_ROWS, x.shape[-1]
        mine = _mix_run(local, s, x, xt,
                        ssm.init_mamba_state(b, dm, s, "cuda", mesh.model),
                        mesh)
        one = _mix_run(p, s, x, xt, ssm.init_mamba_state(b, dm, s, "cuda"))
        runs = {"rank": mine}
        if key == "bf16":
            runs["witness"] = _mix_run(
                p, s, x, xt, ssm.init_mamba_state(b, dm, s, "cuda"),
                _one_mesh())
        n = mine["states"][0]["ssm"].shape[1]
        lo = mesh.model_rank * n
        # each run against one rank: outputs a row (token), states the
        # rank's channels, relative L2
        errs = {name: {"y": 0.0, "state": 0.0} for name in runs}
        for name, run in runs.items():
            for i in range(1 + SSM_DECODE):
                y, want = run["y"][i], one["y"][i]
                if not torch.isfinite(y).all() or y.shape != want.shape:
                    raise AssertionError(f"[29] (c) {key} {name} call {i}: "
                                         "output not finite or of shape "
                                         f"{tuple(want.shape)}")
                errs[name]["y"] = max(errs[name]["y"], float(
                    ((y - want).flatten(0, -2).norm(dim=-1)
                     / want.flatten(0, -2).norm(dim=-1)).max()))
                for k, v in run["states"][i].items():
                    w = one["states"][i][k]
                    if v.shape != w.shape:
                        w = w.narrow(-1 if k == "conv" else 1, lo, n)
                    errs[name]["state"] = max(errs[name]["state"], float(
                        (v - w).norm() / w.norm()))
        out[key] = {"errs": errs, "calls": mine["calls"],
                    "walls": mine["walls"], "one_walls": one["walls"]}
        del p, local, x, xt, mine, one, runs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ssm_rank(mesh) -> dict:
    """Phase 29 on one of 27 (b)'s four ranks (qwen2's pieces freed): (a)
    rwkv6-1.6b's prefill and decode cells over the rank's 8 heads, (b)
    its train cell and float32 gradient, (c) jamba's Mamba mixer over the
    rank's channels."""
    torch = _torch()
    t0 = time.perf_counter()
    cfgs = _ssm_configs()
    out = {}
    params = _ssm_pieces(cfgs["f32"], mesh)
    out["a_f32"] = _ssm_serve(cfgs["f32"], params, mesh, counted=False)
    out["b_f32"] = _ssm_grads(cfgs["f32"], params, mesh, mesh.model_rank)
    del params
    params = _ssm_pieces(cfgs["bf16"], mesh)
    out["a"] = _ssm_serve(cfgs["bf16"], params, mesh, counted=True)
    out["b"] = _wh_train(cfgs["bf16"], params, mesh, SSM_TRAIN_STEPS)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["c"] = _mix_rank(mesh)
    out["wall_s"] = time.perf_counter() - t0
    return out


def _ssm_one_rank() -> dict:
    """Phase 29's single rank in this process: (a)'s cells on the whole
    rwkv6-1.6b (bf16 also under one rank's tensor-parallel arithmetic:
    the witness of rounding, trap 10) and at 2 layers in float32 (also
    with the plain fp32 WKV in place of B8: the witness of B8's TF32
    rounding), and (b)'s bf16 train cell."""
    torch = _torch()
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import LM
    one = make_host_mesh(device="cuda")
    out = {}
    for key, cfg in _ssm_configs().items():
        params = LM(cfg, device="cuda").init(SEED)
        out[key] = {"a": _ssm_serve(cfg, params, one, counted=False)}
        if key == "f32":
            # B8 rounds its products' operands to TF32: how far that alone
            # moves the float32 states (one rank, the plain fp32 WKV)
            out[key]["plain_states"] = _swap_plain(lambda: _ssm_serve(
                cfg, params, one, counted=False), ("wkv",))["states"]
        if key == "bf16":
            out[key]["witness"] = _as_one_rank(lambda: _ssm_serve(
                cfg, params, one, counted=False))["logits"]
            out[key]["b"] = _wh_train(cfg, params, one, SSM_TRAIN_STEPS)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _ssm_check(one: dict, ranks: list, smi: str) -> dict:
    """Phase 29's bars over the four ranks' results against the single
    rank's; raises on any failure."""
    import numpy as np
    o_bf, o_f32 = one["bf16"], one["f32"]
    wit = max(_rel_l2_rows(a, b) for a, b in zip(o_bf["witness"],
                                                 o_bf["a"]["logits"]))
    bar = max(SSM_LOGIT_REL_L2, 2 * wit)

    def state_dists(got_all, want_all, piece: int = -1):
        """Relative L2 of each state leaf of each call (``piece``: the
        rank whose heads ``got_all`` holds; its x_prev is whole)."""
        for step, (mine, want) in enumerate(zip(got_all, want_all)):
            for g, wg in zip(mine, want):
                for blk, st in g.items():
                    for k, v in st.items():
                        w = wg[blk][k]
                        if piece >= 0 and v.shape != w.shape:
                            n = v.shape[1]          # wkv's heads
                            w = w.narrow(1, piece * n, n)
                        yield step, f"{blk}/{k}", float((v - w).norm()
                                                        / w.norm())
    # B8 multiplies in TF32 (10-bit mantissas) in float32 configs too, so
    # an fp32 ulp of its input (a column split's other summation order)
    # moves a state by what TF32 rounding does, and the bf16 gate turns
    # that into a bf16 ulp downstream (trap 6): the float32 states are
    # held to SSM_F32_STATE_FACTOR x the distance TF32 alone puts between
    # one rank's B8 and its plain fp32 WKV
    tf32 = max(d for _, _, d in state_dists(o_f32["plain_states"],
                                            o_f32["a"]["states"]))
    state_bar = max(SSM_F32_REL_L2, SSM_F32_STATE_FACTOR * tf32)
    errs = {"bf16": 0.0, "bf16_vs_witness": 0.0, "f32": 0.0,
            "f32_state": 0.0, "loss": 0.0}
    for i, r in enumerate(ranks):
        w = r["p29"]
        for key, got_all, want_all, lim in (
                ("bf16", w["a"]["logits"], o_bf["a"]["logits"], bar),
                ("bf16_vs_witness", w["a"]["logits"], o_bf["witness"], bar),
                ("f32", w["a_f32"]["logits"], o_f32["a"]["logits"],
                 SSM_F32_LOGIT_REL_L2)):
            for step, (got, want) in enumerate(zip(got_all, want_all)):
                if not np.isfinite(got).all() or got.shape != want.shape:
                    raise AssertionError(f"[29] (a) {key} rank {i} call "
                                         f"{step}: logits not finite or of "
                                         f"shape {want.shape}")
                e = _rel_l2_rows(got, want)
                errs[key] = max(errs[key], e)
                if not e <= lim:
                    raise AssertionError(f"[29] (a) {key} rank {i} call "
                                         f"{step}: logits {e:.3e} > {lim:.3e}")
        # float32 states: the rank's heads of wkv and the whole x_prev
        for step, leaf, e in state_dists(w["a_f32"]["states"],
                                         o_f32["a"]["states"], i):
            errs["f32_state"] = max(errs["f32_state"], e)
            if not e <= state_bar:
                raise AssertionError(f"[29] (a) float32 rank {i} call "
                                     f"{step} {leaf}: {e:.3e} > "
                                     f"{state_bar:.3e}")
        a = w["a"]
        want_l = [SSM_LAUNCHES["prefill"]] + [SSM_LAUNCHES["decode"]] \
            * SSM_DECODE
        if a["launches"] != want_l \
                or a["held"] != SSM_LAUNCHES["prefill"]:
            raise AssertionError(f"[29] (a) rank {i}: launches "
                                 f"{a['launches']}, held {a['held']} != "
                                 f"{want_l}")
        want_c = [SSM_PREDICTED["prefill"]] + [SSM_PREDICTED["decode"]] \
            * SSM_DECODE
        if a["calls"] != want_c:
            raise AssertionError(f"[29] (a) rank {i}: collectives "
                                 f"{a['calls'][:2]} != the prediction "
                                 f"{SSM_PREDICTED}")
        for step, (x, y) in enumerate(zip(w["b"]["losses"],
                                          o_bf["b"]["losses"])):
            e = abs(x - y) / abs(y)
            errs["loss"] = max(errs["loss"], e)
            if not (np.isfinite(x) and e <= WH_LOSS_RTOL):
                raise AssertionError(f"[29] (b) rank {i} step {step + 1}: "
                                     f"loss {x} vs one rank's {y}")
        c = w["c"]
        for key in ("bf16", "f32"):
            ce = c[key]["errs"]
            # bf16: the larger of the bar and twice the witness's distance
            # (one rank's own arithmetic under a scope of one, trap 10)
            lim = (max(SSM_LOGIT_REL_L2, 2 * max(ce["witness"].values()))
                   if key == "bf16" else SSM_F32_REL_L2)
            if not max(ce["rank"].values()) <= lim:
                raise AssertionError(f"[29] (c) {key} rank {i}: output / "
                                     f"state vs one rank's {ce['rank']} > "
                                     f"{lim:.3e}")
            counts = [{k: n for k, (n, _) in calls.items()}
                      for calls in c[key]["calls"]]
            if counts != [{"all-gather/model": 1, "all-reduce/model": 2}] \
                    * (1 + SSM_DECODE):
                raise AssertionError(f"[29] (c) {key} rank {i}: "
                                     f"collectives {counts}")
        if c["bf16"]["calls"] != [MIX_PREDICTED["prefill"]] \
                + [MIX_PREDICTED["decode"]] * SSM_DECODE:
            raise AssertionError(f"[29] (c) rank {i}: collectives "
                                 f"{c['bf16']['calls'][:2]} != the "
                                 f"prediction {MIX_PREDICTED}")
    g = ranks[0]["p29"]["b_f32"]
    if not (g["worst_share"] <= 1.0 and abs(g["loss"] - g["one_loss"])
            <= WH_F32_LOSS_RTOL * abs(g["one_loss"])):
        raise AssertionError(f"[29] (b) float32: gradient of "
                             f"{g['worst_leaf']} {g['worst_rel_l2']:.3e} "
                             f"(limit {g['worst_limit']:.3e}), loss "
                             f"{g['loss']} vs {g['one_loss']}")
    r0 = ranks[0]["p29"]
    walls = [r["p29"]["wall_s"] for r in ranks]
    out = {"errs": errs, "witness": wit, "bar": bar, "tf32_witness": tf32,
           "state_bar": state_bar,
           "a_calls": r0["a"]["calls"][:2],
           "a_launches": r0["a"]["launches"][:2],
           "a_held_worst": max(r["p29"]["a"]["held_worst"] for r in ranks),
           "a_prefill_walls": [r["p29"]["a"]["prefill_walls"]
                               for r in ranks],
           "a_step_walls": [r["p29"]["a"]["step_walls"] for r in ranks],
           "a_one_prefill_walls": o_bf["a"]["prefill_walls"],
           "a_one_step_walls": o_bf["a"]["step_walls"],
           "b": [{k: r["p29"]["b"][k] for k in ("losses", "walls",
                                                "peak_gb", "calls")}
                 for r in ranks],
           "b_one": {k: o_bf["b"][k] for k in ("losses", "walls",
                                              "peak_gb")},
           "b_f32": g,
           "c": [{k: {kk: r["p29"]["c"][k][kk]
                      for kk in ("errs", "walls", "one_walls")}
                  for k in ("bf16", "f32")} for r in ranks],
           "c_calls": r0["c"]["bf16"]["calls"][:2],
           "rank_wall_s": walls}
    cfg = _ssm_configs()["bf16"]
    print(f"[29 ssm_tp] (a) {smi}: {SSM_ARCH} {cfg.num_layers}L bf16 over "
          f"{ranks[0]['mesh']} (32 WKV heads of 64: 8 a rank), "
          f"launch.steps' prefill cell {SSM_ROWS} x {SSM_SEQ} then "
          f"{SSM_DECODE} decode steps: logits vs one rank's LM.prefill / "
          f"decode_step {errs['bf16']:.3e} a row, vs one rank with a "
          f"rank's arithmetic {errs['bf16_vs_witness']:.3e}, that witness "
          f"vs one rank {wit:.3e} (limit {bar:.3e}: the larger of "
          f"{SSM_LOGIT_REL_L2} and 2x the witness); float32 "
          f"{SSM_F32_LAYERS}L logits {errs['f32']:.3e} (limit "
          f"{SSM_F32_LOGIT_REL_L2}), states {errs['f32_state']:.3e} (limit "
          f"{state_bar:.3e}: {SSM_F32_STATE_FACTOR:g}x one rank's B8 "
          f"against its plain fp32 WKV, {tf32:.3e}, B8's TF32 products); "
          f"launches a prefill a rank "
          f"{r0['a']['launches'][0]} (every call held, worst "
          f"{out['a_held_worst']:.2f} of a limit; its LayerNorms launch no "
          f"B7), a decode step {r0['a']['launches'][1]}; collectives a prefill a rank "
          f"{r0['a']['calls'][0]}, a decode step {r0['a']['calls'][1]} (= "
          f"the prediction); prefill wall "
          + "; ".join(f"rank {i} {[round(x, 2) for x in r['p29']['a']['prefill_walls']]}"
                      f" ms" for i, r in enumerate(ranks))
          + f"; one rank {[round(x, 2) for x in o_bf['a']['prefill_walls']]}"
          f" ms; decode step wall median a rank "
          f"{[round(statistics.median(r['p29']['a']['step_walls']), 2) for r in ranks]}"
          f" ms, one rank "
          f"{statistics.median(o_bf['a']['step_walls']):.2f} ms")
    print(f"[29 ssm_tp] (b) {smi}: the train cell {SSM_ROWS} x {SSM_SEQ}, "
          f"{SSM_TRAIN_STEPS} steps: losses a rank "
          f"{[[round(x, 5) for x in r['p29']['b']['losses']] for r in ranks]}"
          f" vs one rank's {[round(x, 5) for x in o_bf['b']['losses']]} "
          f"(worst {errs['loss']:.3e}, limit {WH_LOSS_RTOL}); step wall "
          + "; ".join(f"rank {i} {[round(x, 1) for x in r['p29']['b']['walls']]}"
                      f" ms, peak {r['p29']['b']['peak_gb']:.2f} GB"
                      for i, r in enumerate(ranks))
          + f"; one rank {[round(x, 1) for x in o_bf['b']['walls']]} ms, "
          f"peak {o_bf['b']['peak_gb']:.2f} GB; collectives a step a rank "
          f"{r0['b']['calls']}; kernel launches 0 (B8 has no backward: "
          f"training runs the plain chunked WKV); float32 "
          f"{SSM_F32_LAYERS}L: {g['leaves']} gradient leaves gathered "
          f"whole, worst share of its limit {g['worst_share']:.3f} "
          f"({g['worst_leaf']} {g['worst_rel_l2']:.3e} of "
          f"{g['worst_limit']:.3e}: 1e-4 or {SSM_FLOOR_FACTOR:g}x the "
          f"one-rank summation-order floor), worst leaf anywhere "
          f"{g['worst_any']:.3e}, {g['above_1e-4']} leaves above 1e-4, "
          f"loss {g['loss']:.7f} vs {g['one_loss']:.7f}, collectives "
          f"{g['calls']}; phase wall a rank {[round(x, 1) for x in walls]} s")
    c0 = r0["c"]
    print(f"[29 ssm_tp] (c) {smi}: jamba's Mamba mixer (d 8192, d_inner "
          f"16384: 4096 channels a rank, N 16) under the four ranks' scope, "
          f"{SSM_ROWS} x {SSM_SEQ} prefill then {SSM_DECODE} decode steps: "
          f"bf16 output / state vs one rank's "
          f"{max(max(r['p29']['c']['bf16']['errs']['rank'].values()) for r in ranks):.3e}"
          f" (the witness vs one rank {c0['bf16']['errs']['witness']}), "
          f"float32 "
          f"{max(max(r['p29']['c']['f32']['errs']['rank'].values()) for r in ranks):.3e}"
          f" (limit {SSM_F32_REL_L2}); collectives a prefill "
          f"{c0['bf16']['calls'][0]}, a decode step {c0['bf16']['calls'][1]}"
          f" (= the prediction); wall a prefill / median decode step: rank "
          f"0 {c0['bf16']['walls'][0]:.2f} / "
          f"{statistics.median(c0['bf16']['walls'][1:]):.2f} ms, one rank "
          f"{c0['bf16']['one_walls'][0]:.2f} / "
          f"{statistics.median(c0['bf16']['one_walls'][1:]):.2f} ms")
    return out


def _ssm_kernel_row(records: list) -> dict:
    """B8 at a phase 29 rank's shape (4 x 512, 8 heads of 64, bf16 r / k /
    v from a zero state; row 8 is 1 x 2,048 over 32 heads): held, timed
    beside the plain version and the bound."""
    torch = _torch()
    from repro_torch.kernels.wkv6 import ops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 51)
    heads = WKV_H // CP_RANKS

    def inputs():
        r, k, v, lw, u, s0 = _wkv6_inputs(g, "cuda", SSM_ROWS, SSM_SEQ,
                                          torch.bfloat16, 0.0)
        return (r[:, :, :heads].contiguous(), k[:, :, :heads].contiguous(),
                v[:, :, :heads].contiguous(), lw[:, :, :heads].contiguous(),
                u[:heads].contiguous(), s0[:, :heads].contiguous())
    args = inputs()
    o, s_fin = ops.wkv6(*args)
    r, k, v, lw, u, s0 = (x.float() for x in args)
    o_ref, s_ref = wkv6_chunked_ref(r, k, v, lw, u, s0)
    torch.cuda.synchronize()
    worst = max(_check_rms("B8 4 x 512 H8 o", o, o_ref, WKV_ATOL),
                _check_rms("B8 4 x 512 H8 s_final", s_fin, s_ref, WKV_ATOL))
    copies = [inputs() for _ in range(8)]
    nbytes, n_ops = wkv6_bytes_ops(copies[0])
    row = {"shape": f"{SSM_ROWS} x {SSM_SEQ}, H{heads} D{WKV_D}, bf16",
           "max_abs_err": (o.float() - o_ref).abs().max().item(),
           "worst_share": worst,
           "ms": time_ms(ops.wkv6, copies, reps=10),
           "plain_ms": time_ms(lambda r, k, v, lw, u, s0: wkv6_chunked_ref(
               r.float(), k.float(), v.float(), lw, u, s0), copies[:2],
               reps=3, rounds=3),
           "library_ms": None,
           **dict(zip(("bound_ms", "bound_by"),
                      bound(nbytes, n_ops, "tfloat32")))}
    del copies
    torch.cuda.empty_cache()
    return row


def _pipe_rank(rank: int) -> dict:
    """One of the two stages of 27 (c): llama3.2-1b's layers 8 s .. 8 s +
    7 at full width, 4 microbatches of 2 x 512 through the GPipe
    schedule."""
    torch = _torch()
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.pipeline import pipeline_forward
    from repro_torch.tree import tree_map
    missing = [n for n in build.SOURCES if not build.lib_path(n).exists()]
    if missing:
        raise RuntimeError(f"rank {rank}: kernels {missing} not built")
    t0 = time.perf_counter()
    mesh = make_host_mesh(stage=PIPE_RANKS, device="cuda")
    cfg, x, layers = _pipe_model()
    per = cfg.num_layers // PIPE_RANKS
    s = mesh.stage_rank
    mine = {"layers": tree_map(lambda t: t[None],
                               layers[s * per:(s + 1) * per])}
    del layers
    torch.cuda.empty_cache()
    stage_fn = _pipe_stage_fn(cfg.with_(num_layers=per))
    before = mesh.stats.copy()
    _reset_launches()
    with torch.no_grad():
        y, walls = _cell_walls(
            lambda: pipeline_forward(stage_fn, mine, x, mesh), 1)
    calls = mesh.stats.since(before)
    return {"mesh": mesh.describe(), "y": y.cpu(), "wall_ms": walls[0],
            "launches": _read_launches(),
            "calls": {k: v for k, v in calls.count_by_op.items() if v},
            "bytes": {k: v for k, v in calls.bytes_by_op.items() if v},
            "wall_s": time.perf_counter() - t0}


def _pipe_model() -> tuple:
    """(config, the microbatches' embeddings (M, 2, 512, d), the layer
    list) of llama3.2-1b from SEED."""
    torch = _torch()
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg, device="cuda")
    params = lm.init(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 32)
    toks = torch.randint(0, cfg.vocab_size, (PIPE_MICRO * PIPE_MB[0],
                                             PIPE_MB[1]),
                         generator=g, device="cuda")
    with torch.no_grad():
        x = lm._embed(params, toks).reshape(PIPE_MICRO, *PIPE_MB, -1)
    return cfg, x, params["layers"]


def _pipe_stage_fn(cfg):
    from repro_torch.models.transformer import stack_forward

    def stage_fn(p, x):
        return stack_forward(p["layers"], x, cfg, mode="prefill")[0]
    return stage_fn


def _pipe_one_rank() -> dict:
    """The single rank of 27 (c): the 16 layers in order on each
    microbatch."""
    torch = _torch()
    cfg, x, layers = _pipe_model()
    stage_fn = _pipe_stage_fn(cfg)
    with torch.no_grad():
        y, walls = _cell_walls(lambda: torch.stack(
            [stage_fn({"layers": layers}, x[i]) for i in range(x.shape[0])]),
            1)
    del layers
    torch.cuda.empty_cache()
    return {"y": y.cpu(), "wall_ms": walls[0], "mb_bytes":
            x[0].numel() * x.element_size()}


def _cp_calls(r: dict) -> dict:
    return {k: (r["bf16"]["calls"][k], r["bf16"]["bytes"][k])
            for k in r["bf16"]["calls"]}


def _whole_check(one: dict, ranks: list, smi: str) -> dict:
    """Phase 28's bars over the four ranks' results against the single
    rank's; raises on any failure."""
    import numpy as np
    o_bf, o_f32 = one["bf16"]["p28"], one["f32"]["p28"]
    errs = {"bf16": 0.0, "f32": 0.0, "loss": 0.0}
    for i, r in enumerate(ranks):
        w = r["p28"]
        for key, got, want, bar in (
                ("bf16", w["a"]["logits"], o_bf["a"]["logits"],
                 WH_LOGIT_REL_L2),
                ("f32", w["a_f32"]["logits"], o_f32["a"]["logits"],
                 WH_F32_REL_L2)):
            if not np.isfinite(got).all() or got.shape != want.shape:
                raise AssertionError(f"[28] (a) {key} rank {i}: logits not "
                                     f"finite or of shape {want.shape}")
            e = _rel_l2_rows(got, want)
            errs[key] = max(errs[key], e)
            if not e <= bar:
                raise AssertionError(f"[28] (a) {key} rank {i}: logits "
                                     f"{e:.3e} > {bar} of one rank's")
        a = w["a"]
        if a["launches"] != WH_LAUNCHES or a["held"] != WH_LAUNCHES:
            raise AssertionError(f"[28] (a) rank {i}: launches "
                                 f"{a['launches']}, held {a['held']} != "
                                 f"{WH_LAUNCHES}")
        if a["calls"] != WH_PREDICTED:
            raise AssertionError(f"[28] (a) rank {i}: collectives "
                                 f"{a['calls']} != the prediction "
                                 f"{WH_PREDICTED}")
        for step, (x, y) in enumerate(zip(w["b"]["losses"],
                                          o_bf["b"]["losses"])):
            e = abs(x - y) / abs(y)
            errs["loss"] = max(errs["loss"], e)
            if not (np.isfinite(x) and e <= WH_LOSS_RTOL):
                raise AssertionError(f"[28] (b) rank {i} step {step + 1}: "
                                     f"loss {x} vs one rank's {y}")
    g = ranks[0]["p28"]["b_f32"]
    if not (g["worst_rel_l2"] <= WH_F32_GRAD_REL_L2
            and abs(g["loss"] - g["one_loss"])
            <= WH_F32_LOSS_RTOL * abs(g["one_loss"])):
        raise AssertionError(f"[28] (b) float32: gradient of "
                             f"{g['worst_leaf']} {g['worst_rel_l2']:.3e} "
                             f"(limit {WH_F32_GRAD_REL_L2}), loss "
                             f"{g['loss']} vs {g['one_loss']}")
    r0 = ranks[0]["p28"]
    walls = [r["p28"]["wall_s"] for r in ranks]
    out = {"errs": errs, "a_calls": r0["a"]["calls"],
           "a_launches": r0["a"]["launches"],
           "a_walls": [r["p28"]["a"]["walls"] for r in ranks],
           "a_one_walls": o_bf["a"]["walls"],
           "b": [{k: r["p28"]["b"][k] for k in ("losses", "walls",
                                                "peak_gb", "calls")}
                 for r in ranks],
           "b_one": {k: o_bf["b"][k] for k in ("losses", "walls",
                                              "peak_gb")},
           "b_f32": g, "b_f32_calls": g["calls"], "rank_wall_s": walls}
    print(f"[28 whole_heads] (a) {smi}: {CP_ARCH} "
          f"{_cp_configs()['bf16'].num_layers}L bf16, launch.steps' prefill "
          f"cell {WH_ROWS} x {WH_SEQ} on {ranks[0]['mesh']} (12 query "
          f"heads over 2 kv heads, every head on every rank): logits vs one "
          f"rank's LM.prefill {errs['bf16']:.3e} a row (limit "
          f"{WH_LOGIT_REL_L2}); float32 {CP_F32_LAYERS}L {errs['f32']:.3e} "
          f"(limit {WH_F32_REL_L2}); launches a prefill a rank "
          f"{r0['a']['launches']}, every call held ({r0['a']['held']}, "
          f"worst {max(r['p28']['a']['held_worst'] for r in ranks):.2f} of "
          f"a limit); collectives a prefill a rank {r0['a']['calls']} (= "
          f"the prediction); wall a prefill "
          + "; ".join(f"rank {i} {[round(x, 2) for x in r['p28']['a']['walls']]}"
                      f" ms" for i, r in enumerate(ranks))
          + f"; one rank {[round(x, 2) for x in o_bf['a']['walls']]} ms")
    print(f"[28 whole_heads] (b) {smi}: the train cell {WH_ROWS} x {WH_SEQ},"
          f" {WH_TRAIN_STEPS} steps: losses a rank "
          f"{[[round(x, 5) for x in r['p28']['b']['losses']] for r in ranks]}"
          f" vs one rank's {[round(x, 5) for x in o_bf['b']['losses']]} "
          f"(worst {errs['loss']:.3e}, limit {WH_LOSS_RTOL}); step wall "
          + "; ".join(f"rank {i} {[round(x, 1) for x in r['p28']['b']['walls']]}"
                      f" ms, peak {r['p28']['b']['peak_gb']:.2f} GB"
                      for i, r in enumerate(ranks))
          + f"; one rank {[round(x, 1) for x in o_bf['b']['walls']]} ms, "
          f"peak {o_bf['b']['peak_gb']:.2f} GB; collectives a step a rank "
          f"{r0['b']['calls']} (the reduce-scatters are the gathers' "
          f"backward); float32 {CP_F32_LAYERS}L: {g['leaves']} gradient "
          f"leaves gathered whole, worst {g['worst_leaf']} "
          f"{g['worst_rel_l2']:.3e} (limit {WH_F32_GRAD_REL_L2}), loss "
          f"{g['loss']:.7f} vs {g['one_loss']:.7f}, collectives "
          f"{g['calls']}; phase wall a rank {[round(x, 1) for x in walls]} s")
    return out


def _cp_and_pipe(smi: str) -> dict:
    """27 (b) and (c), each world against the single rank in this
    process."""
    import numpy as np
    torch = _torch()
    from repro_torch.launch.mesh import spawn_world
    one = _cp_one_rank()
    one29 = _ssm_one_rank()
    ranks = spawn_world(_cp_rank, CP_RANKS, device="cuda")
    out = {"one": {k: {"walls": v["walls"], "peak_gb": v["peak_gb"]}
                   for k, v in one.items()}, "ranks": []}
    errs, wit = {}, {}
    for key, limit in (("bf16", LOGIT_REL_L2), ("f32", CP_F32_REL_L2)):
        # against one rank's eager decode; and against the witness, one
        # rank running the same attention math (a rank's path without
        # the split), which bounds what the split itself changes
        errs[key] = max(_rel_l2_all(a, b) for r in ranks for a, b in
                        zip(r[key]["logits"], one[key]["logits"]))
        wit[key] = {"vs_witness": max(
            _rel_l2_all(a, b) for r in ranks for a, b in
            zip(r[key]["logits"], one[key]["witness"])),
            "witness_vs_eager": max(_rel_l2_all(a, b) for a, b in zip(
                one[key]["witness"], one[key]["logits"]))}
        # a change of rounding alone moves random-weight bf16 logits by
        # about what the split does (ROADMAP C, trap 10): the bar is the
        # larger of the limit and twice that witness's distance
        bar = max(limit, 2 * wit[key]["witness_vs_eager"])
        wit[key]["bar"] = bar
        for name, got in (("one rank with a rank's arithmetic",
                           wit[key]["vs_witness"]),
                          ("one rank's eager decode", errs[key])):
            if not got <= bar:
                raise AssertionError(
                    f"(b) {key} logits of 4 ranks vs {name}: {got:.3e} > "
                    f"{bar:.3e} (the larger of {limit} and 2x the "
                    f"witness's {wit[key]['witness_vs_eager']:.3e})")
    for r in ranks:
        got = {k: (r["bf16"]["calls"].get(k), r["bf16"]["bytes"].get(k))
               for k in set(r["bf16"]["calls"]) | set(CP_PREDICTED)}
        if got != CP_PREDICTED:
            raise AssertionError(f"(b) collectives a step {got} != the "
                                 f"prediction {CP_PREDICTED}")
        out["ranks"].append({k: {"walls": r[k]["walls"],
                                 "peak_gb": r[k]["peak_gb"]}
                             for k in ("bf16", "f32")})
    out["logits_rel_l2"] = errs
    out["witness"] = wit
    r0 = ranks[0]
    print(f"[27 cells] (b) {smi}: {CP_ARCH} {_cp_configs()['bf16'].num_layers}"
          f"L bf16, decode cell with cp on {r0['mesh']}, contiguous cache "
          f"{CP_BATCH} x {CP_SEQ} ({CP_SEQ // CP_RANKS} positions a rank), "
          f"{CP_STEPS} steps from positions {list(CP_POS)}: logits vs one "
          f"rank's eager LM.decode_step over the whole cache "
          f"{errs['bf16']:.3e}, vs one rank with a rank's arithmetic (the "
          f"witness) {wit['bf16']['vs_witness']:.3e}, the witness vs the "
          f"eager decode {wit['bf16']['witness_vs_eager']:.3e} (limit "
          f"{wit['bf16']['bar']:.3e}: the larger of {LOGIT_REL_L2} and 2x "
          f"that); float32 {CP_F32_LAYERS}L {errs['f32']:.3e} / "
          f"{wit['f32']['vs_witness']:.3e} / "
          f"{wit['f32']['witness_vs_eager']:.3e} (limit "
          f"{wit['f32']['bar']:.3e}); collectives a step "
          f"a rank {_cp_calls(r0)} (= the prediction); step wall a rank "
          + "; ".join(f"rank {i} {[round(w, 2) for w in r['bf16']['walls']]}"
                      f" ms, peak {r['bf16']['peak_gb']:.2f} GB"
                      for i, r in enumerate(ranks))
          + f"; one rank {[round(w, 2) for w in one['bf16']['walls']]} ms, "
          f"peak {one['bf16']['peak_gb']:.2f} GB; rank walls "
          f"{[round(r['wall_s'], 1) for r in ranks]} s")
    out["p28"] = _whole_check(one, ranks, smi)
    out["p29"] = _ssm_check(one29, ranks, smi)
    del one, one29, ranks
    # (c)
    one = _pipe_one_rank()
    stages = spawn_world(_pipe_rank, PIPE_RANKS, device="cuda")
    mb = one["mb_bytes"]
    ticks = PIPE_RANKS + PIPE_MICRO - 1
    want_calls = {"collective-permute/stage": ticks, "all-reduce/stage": 1}
    want_bytes = {"collective-permute/stage": float(ticks * mb),
                  "all-reduce/stage": float(PIPE_MICRO * mb)}
    errs = []
    for st in stages:
        if st["calls"] != want_calls or st["bytes"] != want_bytes:
            raise AssertionError(f"(c) collectives {st['calls']} "
                                 f"{st['bytes']} != {want_calls} "
                                 f"{want_bytes}")
        errs.append(_rel_l2_all(st["y"].float().numpy(),
                                one["y"].float().numpy()))
        if not (np.isfinite(st["y"].float().numpy()).all()
                and errs[-1] <= LOGIT_REL_L2):
            raise AssertionError(f"(c) pipeline outputs vs one rank's 16 "
                                 f"layers: {errs[-1]:.3e}")
    layers_a_stage = 16 // PIPE_RANKS
    want_l = {"flash_attention": layers_a_stage * PIPE_MICRO,
              "rmsnorm": 2 * layers_a_stage * PIPE_MICRO}
    for st in stages:
        got = {k: st["launches"][k] for k in want_l}
        if got != want_l:
            raise AssertionError(f"(c) a stage's launches {got} != {want_l}")
    out["pipe"] = {"errs": errs, "walls_ms": [st["wall_ms"] for st in stages],
                   "one_wall_ms": one["wall_ms"], "calls": want_calls,
                   "bytes": want_bytes, "launches": want_l}
    print(f"[27 cells] (c) {smi}: GPipe, {TRAIN_ARCH} 16L bf16 as "
          f"{PIPE_RANKS} stages of {layers_a_stage} on {stages[0]['mesh']}, "
          f"{PIPE_MICRO} microbatches of {PIPE_MB[0]} x {PIPE_MB[1]}: outputs "
          f"vs one rank's 16 layers in order {max(errs):.3e} (limit "
          f"{LOGIT_REL_L2}); a stage's collectives {want_calls}, bytes "
          f"{want_bytes} (= {ticks} ticks x {mb} B + the final sum); "
          f"launches a stage {want_l}; wall "
          f"{[round(w, 2) for w in out['pipe']['walls_ms']]} ms a stage, one "
          f"rank {one['wall_ms']:.2f} ms")
    torch.cuda.empty_cache()
    return out


def phase_cells(records: list, smi: str) -> dict:
    """Phase 27: (a) llama3.2-1b's dry-run cells on one rank, (b) the
    context-parallel decode on four ranks sharing the card, (c) a GPipe
    pipeline of two stages; phases 28 (heads the model axis does not
    divide) and 29 (RWKV-6 over a rank's heads, Mamba over its channels)
    run on (b)'s ranks."""
    t0 = time.perf_counter()
    out = {"a": _cells_one_rank(records, smi)}
    out.update(_cp_and_pipe(smi))
    out["phase_wall_s"] = time.perf_counter() - t0
    print(f"[27 cells] phase {out['phase_wall_s']:.1f}s ((a) "
          f"{out['a']['wall_s']:.1f}s)")
    # phase 28 ran on (b)'s ranks; its kernel row at a rank's B3 shape
    t0 = time.perf_counter()
    k = _wh_kernel_row(records)
    p28 = out["p28"]
    for rec in records:
        if rec["name"] in p28["a_launches"]:
            rec["whole_heads_prefill"] = {
                "launches_a_rank": p28["a_launches"][rec["name"]],
                "ranks": CP_RANKS}
        if rec["name"] == "flash_attention":
            rec["whole_heads_prefill"].update(k["row"])
    r = k["row"]
    print(f"[28 whole_heads] {smi}: {k['line']}; B3 at a rank's shape "
          f"{r['shape']} {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, SDPA "
          f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
          f"({r['bound_by']}); phase 28 wall a rank "
          f"{[round(x, 1) for x in p28['rank_wall_s']]} s "
          f"(+{time.perf_counter() - t0:.1f} s here)")
    # phase 29 ran on (b)'s ranks too; B8's row at a rank's shape (8t)
    t0 = time.perf_counter()
    row = _ssm_kernel_row(records)
    p29 = out["p29"]
    for rec in records:
        if rec["name"] == "wkv6":
            rec["tp_prefill"] = {"launches_a_rank": p29["a_launches"][0][
                "wkv6"], "ranks": CP_RANKS, **row}
    print(f"[29 ssm_tp] {smi}: B8 at a rank's shape {row['shape']} held "
          f"(worst element {row['worst_share']:.3f} of its limit, max abs "
          f"err {row['max_abs_err']:.3e}): {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
          f"({row['bound_by']}, TF32 rate), no library call; phase 29 wall "
          f"a rank {[round(x, 1) for x in p29['rank_wall_s']]} s "
          f"(+{time.perf_counter() - t0:.1f} s here)")
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
    cost = phase_cost(records)
    search = phase_search(records, cost["calibration"])
    moe = phase_moe(records)
    train = phase_train(records, dev["smi"])
    encdec = phase_encdec(records, dev["smi"])
    jamba = phase_jamba(records, dev["smi"])
    tp = phase_tp(records, e2e, dev["smi"])
    train_tp = phase_train_tp(dev["smi"])
    tp_moe = phase_tp_moe(records, dev["smi"])
    train_tp_peft = phase_train_tp_peft(dev["smi"])
    cells = phase_cells(records, dev["smi"])
    out_dir = ROOT / "chiprun_out"
    if out_dir.is_dir():
        (out_dir / "chip_smoke_e2e.json").write_text(json.dumps(
            {"e2e": e2e, "sched": sched, "qsched": qsched, "fp8": fp8,
             "rwkv": rwkv, "spec": spec, "eager": eager, "resil": resil,
             "cost": cost, "search": search, "moe": moe, "train": train,
             "encdec": encdec, "jamba": jamba, "tp": tp,
             "train_tp": train_tp, "tp_moe": tp_moe,
             "train_tp_peft": train_tp_peft, "cells": _without_arrays(cells),
             "kernels": records},
            indent=1))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
