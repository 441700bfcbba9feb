"""Dry-run of the port: roofline terms of (arch × shape × mesh) cells,
on the CPU, with no card and no world.

For every cell: build the cell (``launch.steps.build_cell``) on one
rank's view of the reference's production mesh (16 × 16, or 2 × 16 × 16
with ``--multi-pod``: ``launch.mesh.abstract_mesh``), run that rank's
step on meta tensors under the FLOP and byte counters, read its
collectives from the port's collective layer, and write the roofline
terms at the H100's peaks (``launch.roofline``) as a JSON artifact under
``experiments/dryrun_torch/``.  The port's stack is a list of groups, so
one full-depth trace counts every layer (the reference compiles 1- and
2-group unrolled variants and extrapolates).

A decode cell asks for the context-parallel decode (``decode_attn_impl=
"cp"``) where the config's eager decode of an unquantized contiguous
cache meets a model axis that does not divide its kv heads: the port
refuses that layout for the eager step (ROADMAP A8.8), and the
reference's own remedy for it is the context-parallel combine
(``serve/decode_attn.py``).  The artifact records it.  ``--set
decode_attn_impl=...`` overrides.

A cell ends "ok" (traced), "skipped" (the reference's long_500k policy),
"refused" (the port does not shard the layout yet: a ``ValueError``
naming its ROADMAP item, from ``sharding.tp``) or "error" (anything
else); the command exits 1 only for errors.  ``run_cell(trace=False)``
stops a cell once it is built (its checks, abstract inputs and
placements): "built" in place of "ok", in well under a second a cell.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k [--multi-pod] [--set attn_q_block=2048] [--tag x]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.specs import cell_supported
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.roofline import (analytic_hbm_bytes, h100_peaks,
                                         model_flops_for)
from repro_torch.launch.steps import auto_fsdp, build_cell

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"


def production_mesh(multi_pod: bool):
    """Rank 0's view of the reference's production mesh."""
    shape = {"data": 16, "model": 16}
    if multi_pod:
        shape = {"pod": 2, **shape}
    return abstract_mesh(shape)


def _parse_override(kv: str):
    k, v = kv.split("=", 1)
    for conv in (int, float):
        try:
            return k, conv(v)
        except ValueError:
            pass
    if v in ("True", "False", "true", "false"):
        return k, v.lower() == "true"
    return k, v


def _apply_overrides(cfg, overrides: dict):
    """Supports dotted sub-config keys, e.g.
    --set attention.head_pad_multiple=16 or --set moe.pad_experts=48."""
    flat = {k: v for k, v in overrides.items() if "." not in k}
    nested: dict = {}
    for k, v in overrides.items():
        if "." in k:
            top, sub = k.split(".", 1)
            nested.setdefault(top, {})[sub] = v
    for top, subs in nested.items():
        cur = getattr(cfg, top)
        flat[top] = dataclasses.replace(cur, **subs)
    return cfg.with_(**flat)


def _decode_impl(cfg, shape, mesh, overrides: dict):
    """(config, why) with the context-parallel decode where the eager one
    meets kv heads the model axis does not divide (see the module
    docstring); ``why`` is "" where nothing changed."""
    from repro_torch.kvcache import normalize_dtype
    a, model = cfg.attention, mesh.shape.get("model", 1)
    if (shape.mode != "decode" or "decode_attn_impl" in overrides
            or cfg.decode_attn_impl != "eager" or a is None
            or a.kind == "mla" or model == 1
            or normalize_dtype(cfg.kv_cache_dtype) != "bfloat16"
            or a.kv_heads_effective() % model == 0):
        return cfg, ""
    return cfg.with_(decode_attn_impl="cp"), (
        f"{a.kv_heads_effective()} kv heads on a model axis of {model}: "
        "the eager decode's layout is refused (ROADMAP A8.8); the cache's "
        "sequence is split over the model axis instead")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict, fsdp: str, tag: str, out_dir: pathlib.Path,
             microbatches: int = 1, quiet: bool = False,
             trace: bool = True) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag
                                                     else "")
    out_path = out_dir / f"{cell_id}.json"
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    # the chunked attention's block grid, as the reference sets it (the
    # block size moves no FLOPs; it bounds the trace's op count)
    blk = max(1024, shape.seq_len // 8) if shape.mode != "decode" else 1024
    cfg = cfg.with_(attn_q_block=blk, attn_kv_block=blk)
    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "overrides": overrides,
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
    }
    ok, why = cell_supported(cfg, shape)
    if not ok:
        result["status"] = "skipped"
        result["why"] = why
        out_dir.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
        if not quiet:
            print(f"[dryrun] {cell_id}: SKIP ({why})")
        return result

    mesh = production_mesh(multi_pod)
    use_fsdp = {"on": True, "off": False}.get(fsdp) \
        if fsdp in ("on", "off") else auto_fsdp(cfg, mesh, shape.mode)
    cfg, cp_why = _decode_impl(cfg, shape, mesh, overrides)
    result["microbatches"] = microbatches
    result["decode_attn_impl"] = cfg.decode_attn_impl
    if cp_why:
        result["decode_attn_impl_why"] = cp_why
    hw = h100_peaks()
    try:
        t0 = time.time()
        cell = build_cell(cfg, shape, mesh, fsdp=use_fsdp,
                          microbatches=microbatches)
        if not trace:
            result.update(status="built", fsdp=bool(use_fsdp))
            if not quiet:
                print(f"[dryrun] {cell_id}: BUILT (not traced)")
            out_dir.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(result, indent=1))
            return result
        terms = cell.trace(model_flops_for(cfg, shape))
        t_trace = time.time() - t0
        result.update({
            "status": "ok",
            "fsdp": bool(use_fsdp),
            "n_chips": int(mesh.world),
            "mesh_view": mesh.describe(),
            "peaks": hw,
            "trace_s": round(t_trace, 1),
            "roofline": terms.to_dict(),
            "bottleneck": terms.bottleneck,
            "t_max_s": terms.t_max,
            "roofline_fraction": terms.roofline_fraction,
            "memory": terms.memory_per_device,
            "analytic_hbm_bytes": analytic_hbm_bytes(
                cfg, shape, n_chips=mesh.world,
                model_axis=mesh.shape["model"]),
        })
        if not quiet:
            m = terms
            live = m.memory_per_device["live_bytes"] / 2**30
            print(f"[dryrun] {cell_id}: OK  comp={m.t_compute*1e3:.2f}ms "
                  f"mem={m.t_memory*1e3:.2f}ms coll={m.t_collective*1e3:.2f}ms"
                  f" -> {m.bottleneck} | useful={m.useful_ratio:.2f} "
                  f"frac={m.roofline_fraction:.3f} live={live:.2f}GiB "
                  f"(trace {t_trace:.0f}s)"
                  + (f" [decode_attn_impl=cp: {cp_why}]" if cp_why else ""))
    except Exception as e:  # noqa: BLE001 - record the failure mode
        refused = isinstance(e, ValueError) and "ROADMAP A8." in str(e)
        result["status"] = "refused" if refused else "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        if not quiet:
            print(f"[dryrun] {cell_id}: {result['status'].upper()} "
                  f"{result['error'][:200]}")
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None,
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) on the chosen mesh(es)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="ModelConfig override, e.g. --set remat_policy=dots")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    overrides = dict(_parse_override(kv) for kv in args.overrides)
    archs = list(ARCH_IDS) if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    out_dir = pathlib.Path(args.out)
    n_ok = n_skip = n_refused = n_err = 0
    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, multi_pod=multi,
                             overrides=overrides, fsdp=args.fsdp,
                             tag=args.tag, out_dir=out_dir,
                             microbatches=args.microbatches)
                n_ok += r["status"] == "ok"
                n_skip += r["status"] == "skipped"
                n_refused += r["status"] == "refused"
                n_err += r["status"] == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_refused} "
          f"refused, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
