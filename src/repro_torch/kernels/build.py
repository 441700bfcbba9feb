"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing is compiled at import: the first launch of a kernel (or an
explicit :func:`build`) compiles it.  Libraries land in ``build/kernels/``
at the repository root, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: kernel library name -> source file under csrc/
SOURCES = {"paged_attention": "paged_attention.cu",
           "flash_attention": "flash_attention.cu"}

#: torch dtype -> dtype code of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: C signatures of the exported entry points (all return an int status)
SIGNATURES = {
    "paged_attention": ("paged_attention_decode",
                        [_P] * 11 + [_I] * 8 + [_F, _I, _I, _P]),
    "flash_attention": ("flash_attention_fwd",
                        [_P] * 4 + [_I] * 8 + [_F, _I, _P]),
}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``."""
    for cand in (Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
                 / "bin" / "nvcc", Path("/usr/local/cuda/bin/nvcc")):
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError("nvcc not found: the CUDA kernels build only "
                                "where the CUDA toolkit is installed")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernel libraries (default: all) that are not
    built yet, one ``nvcc`` process per source, all started together.
    Returns ``{name: {"seconds": wall, "log": compiler output}}`` for the
    libraries compiled by this call; raises if any compile fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    result, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        result[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The loaded library's entry point for kernel ``name`` (built first
    if needed), with its C signature declared."""
    build([name])
    lib = ctypes.CDLL(str(lib_path(name)))
    fn_name, argtypes = SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    err = lib.repro_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def check_status(name: str, rc: int, err_fn) -> None:
    """Raise for a non-zero status returned by a kernel entry point."""
    if rc == -1:
        raise ValueError(f"{name}: shape or dtype not supported by the kernel")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed: "
                           f"{err_fn(rc).decode()} (code {rc})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
