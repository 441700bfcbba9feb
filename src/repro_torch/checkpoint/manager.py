"""Fault-tolerant checkpointing: the port's copy of
``repro/checkpoint/manager.py``.

Layout per step::

    <dir>/step_000000100.tmp/       (written first)
        shard_00000.bin             (arrays back to back, ~256 MB a shard)
        ...
    <dir>/step_000000100/           (atomic rename once every shard landed)
        MANIFEST.json               (written LAST = the commit record:
                                     each array's shape, dtype, shard,
                                     offset and size, each shard's sha256,
                                     the data-pipeline state, the step)

Guarantees, as the reference's:
  * atomicity — a crash mid-write leaves only ``.tmp`` directories
    (ignored, collected); a step without a manifest is skipped on restore;
  * integrity — each shard's sha256 is checked on load, and with no step
    asked for a corrupt or partial step falls back to the newest valid
    one (counted in ``load_failures`` and warned about);
  * keep-N — only the newest ``keep`` steps stay;
  * async — ``save_async`` copies its snapshot to host memory before it
    returns and writes it on a thread.  The port's optimizer updates
    parameters and state in place, so the copy is what makes the
    snapshot the step's.

The manifest is JSON (the reference's is msgpack), and a shard is the
arrays' raw bytes (the reference's is an npz): a full-width llama3.2-1b
run saves 12.4 GB a step, and shards are written, hashed and read on a
pool of threads (hashing and file I/O release the interpreter lock).
numpy has no bf16 or fp8, so those tensors are stored as ``uint16`` /
``uint8`` views with their dtype named in the manifest and viewed back on
load.  Keys are the tree paths of ``repro_torch.tree``
(``params/layers/0/blk0/attn/wq/w``, ``opt/mu/...``, ``opt/step``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_map

MANIFEST = "MANIFEST.json"
_SHARD_BYTES = 256 << 20
_WORKERS = 8            # shard writers / readers
#: dtypes numpy lacks -> the integer view they are stored as
_VIEWS = {torch.bfloat16: (torch.uint16, "bfloat16"),
          torch.float8_e4m3fn: (torch.uint8, "float8_e4m3fn"),
          torch.float8_e5m2: (torch.uint8, "float8_e5m2")}
_BY_NAME = {name: dt for dt, (_, name) in _VIEWS.items()}


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (never a view of it) and its dtype name."""
    t = t.detach()
    if t.dtype in _VIEWS:
        view, name = _VIEWS[t.dtype]
        return t.view(view).to("cpu", copy=True).numpy(), name
    return t.to("cpu", copy=True).numpy(), str(t.dtype).removeprefix("torch.")


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(_BY_NAME[dtype_name]) if dtype_name in _BY_NAME else t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.load_failures = 0     # corrupt / partial steps skipped

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state=None, data_state=None):
        self.wait()
        self._write(step, self._snapshot(params, opt_state),
                    None if data_state is None else data_state.to_dict())

    def save_async(self, step: int, params, opt_state=None,
                   data_state=None):
        """Copy the state to host memory now, write it on a thread."""
        self.wait()
        snap = self._snapshot(params, opt_state)
        ds = None if data_state is None else data_state.to_dict()
        self._thread = threading.Thread(target=self._write_guarded,
                                        args=(step, snap, ds), daemon=True)
        self._thread.start()

    def wait(self):
        """Join the pending write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    @staticmethod
    def _snapshot(params, opt_state) -> dict:
        tree = {"params": params}
        if opt_state is not None:
            tree["opt"] = {"step": torch.tensor(opt_state.step,
                                                dtype=torch.int32),
                           "mu": opt_state.mu, "nu": opt_state.nu}
        return {k: _to_numpy(v) for k, v in leaves_with_path(tree)}

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:   # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, snap: dict, data_state):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "data_state": data_state, "arrays": {},
                    "shards": []}
        shards, cur, cur_bytes = [], [], 0
        for k, (a, dtype_name) in snap.items():
            manifest["arrays"][k] = {"shape": list(a.shape),
                                     "dtype": dtype_name,
                                     "np_dtype": a.dtype.str,
                                     "shard": len(shards),
                                     "offset": cur_bytes,
                                     "nbytes": a.nbytes}
            cur.append(a)
            cur_bytes += a.nbytes
            if cur_bytes >= _SHARD_BYTES:
                shards.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            shards.append(cur)

        def write_shard(i):
            h = hashlib.sha256()
            fn = f"shard_{i:05d}.bin"
            with open(os.path.join(tmp, fn), "wb") as f:
                for a in shards[i]:
                    b = memoryview(np.ascontiguousarray(a)).cast("B")
                    h.update(b)
                    f.write(b)
            return {"file": fn, "sha256": h.hexdigest()}

        with ThreadPoolExecutor(_WORKERS) as pool:
            manifest["shards"] = list(pool.map(write_shard,
                                               range(len(shards))))
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)            # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
        for d in os.listdir(self.dir):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.dir, d, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: Optional[int] = None, *, like=None):
        """Load a checkpoint -> ``{"step", "data_state", "arrays"}`` (``arrays``: key -> CPU tensor in its saved dtype),
        plus ``"tree"`` when ``like`` (a tree of tensors) is given: the
        arrays under ``params/`` in ``like``'s structure, dtypes and
        devices.  With ``step=None`` a corrupt or partial step is
        skipped and the newest valid one wins; None when there is
        none."""
        self.wait()
        candidates = [step] if step is not None \
            else list(reversed(self.all_steps()))
        last_err = None
        for s in candidates:
            try:
                return self._restore_step(s, like=like)
            except (OSError, ValueError, KeyError) as e:
                last_err = e
                self.load_failures += 1
                if step is not None:
                    raise
                warnings.warn(f"checkpoint step {s} failed to load "
                              f"({e!r}); falling back to an older step")
        if last_err is not None:
            warnings.warn(f"no valid checkpoint found: {last_err}")
        return None

    def _restore_step(self, step: int, *, like=None):
        root = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(root, MANIFEST)) as f:
            manifest = json.load(f)

        def read_shard(sh):
            path = os.path.join(root, sh["file"])
            buf = bytearray(os.path.getsize(path))
            with open(path, "rb") as f:
                f.readinto(buf)
            if _sha(buf) != sh["sha256"]:
                raise IOError(f"checksum mismatch in {sh['file']} @ {root}")
            return buf

        with ThreadPoolExecutor(_WORKERS) as pool:
            bufs = list(pool.map(read_shard, manifest["shards"]))
        arrays: dict = {}
        for k, meta in manifest["arrays"].items():
            buf = bufs[meta["shard"]]
            if meta["offset"] + meta["nbytes"] > len(buf):
                raise ValueError(f"{k}: past the end of its shard")
            a = np.frombuffer(buf, dtype=np.dtype(meta["np_dtype"]),
                              count=int(np.prod(meta["shape"], dtype=np.int64)),
                              offset=meta["offset"]).reshape(meta["shape"])
            arrays[k] = _from_numpy(a, meta["dtype"])
        result = {"step": manifest["step"],
                  "data_state": manifest["data_state"], "arrays": arrays}
        if like is not None:
            result["tree"] = self._unflatten_like(arrays, like)
        return result

    @staticmethod
    def _unflatten_like(arrays: dict, like):
        """``like``'s tree with each leaf replaced by the array at its path
        (under ``params/``, or bare), in the leaf's dtype and on its
        device; shapes must agree."""
        paths = dict(leaves_with_path(like))
        out = {}
        for path, proto in paths.items():
            k = "params/" + path if "params/" + path in arrays else path
            a = arrays[k]
            if tuple(a.shape) != tuple(proto.shape):
                raise ValueError(f"{k}: checkpoint {tuple(a.shape)} vs "
                                 f"model {tuple(proto.shape)}")
            out[path] = a.to(device=proto.device, dtype=proto.dtype)
        it = iter(out.values())
        return tree_map(lambda _: next(it), like)
