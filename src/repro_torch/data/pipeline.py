"""Deterministic, resumable, per-host-sharded data pipeline: the port's
copy of ``repro/data/pipeline.py`` (numpy only; the same generator calls
in the same order, so the batches are bit-equal to the reference's).

Two sources behind one iterator protocol:
  * ``SyntheticLMData`` — seeded synthetic token streams (a mixture of
    order-1 Markov chains, so a model has structure to learn; used by the
    training CLI, the tests and the search's proxy evaluator).
  * ``PackedFileData``  — length-packed binary token files (one uint32
    array per shard), memory-mapped, for real corpora.

State is ``(seed, step)`` only: any host count regenerates the same
global batch order (host h of H takes rows [h·B/H, (h+1)·B/H) of the
global batch), which makes a restart exact.  Batches are numpy int32
``{"tokens", "labels"}``; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class SyntheticLMData:
    """Mixture of k order-1 Markov chains over the vocab; each sequence
    samples a chain, so there is real structure to learn (loss < log V)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, n_chains: int = 8,
                 host_index: int = 0, host_count: int = 1):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {host_count} hosts")
        self.vocab = vocab_size
        self.seq = seq_len
        self.gb = global_batch
        self.local_b = global_batch // host_count
        self.host = host_index
        self.state = DataState(seed=seed, step=0)
        rng = np.random.default_rng(seed + 7777)
        v = min(vocab_size, 64)  # transition table over a small vocab slice
        self._v = v
        self._trans = rng.dirichlet(np.ones(v) * 0.05, size=(n_chains, v))
        self._chains = n_chains

    def _gen_rows(self, rng: np.random.Generator, n: int) -> np.ndarray:
        out = np.empty((n, self.seq + 1), np.int32)
        chain = rng.integers(0, self._chains, n)
        tok = rng.integers(0, self._v, n)
        for t in range(self.seq + 1):
            out[:, t] = tok
            # vectorized markov step
            probs = self._trans[chain, tok]
            cum = np.cumsum(probs, axis=1)
            u = rng.random((n, 1))
            tok = (u < cum).argmax(axis=1)
        return out

    def next_batch(self) -> dict:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) % (2**63))
        rows = self._gen_rows(rng, self.gb)
        lo = self.host * self.local_b
        local = rows[lo: lo + self.local_b]
        # new DataState (never mutate in place: the object may already be
        # referenced by an in-flight async checkpoint snapshot)
        self.state = DataState(self.state.seed, self.state.step + 1)
        return {"tokens": local[:, :-1], "labels": local[:, 1:]}

    def restore(self, state: DataState):
        self.state = dataclasses.replace(state)


class PackedFileData:
    """Packed-token binary shards: tokens.<i>.bin of uint32.  Sequences are
    sampled by deterministic offsets from (seed, step)."""

    def __init__(self, path: str, seq_len: int, global_batch: int, *,
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        self.files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".bin"))
        if not self.files:
            raise FileNotFoundError(f"no .bin shards under {path}")
        self.arrays = [np.memmap(f, dtype=np.uint32, mode="r")
                       for f in self.files]
        self.sizes = np.array([a.size for a in self.arrays])
        self.seq = seq_len
        self.gb = global_batch
        self.local_b = global_batch // host_count
        self.host = host_index
        self.state = DataState(seed=seed, step=0)

    def next_batch(self) -> dict:
        rng = np.random.default_rng(
            (self.state.seed * 1_000_003 + self.state.step) % (2**63))
        shard_ids = rng.integers(0, len(self.arrays), self.gb)
        out = np.empty((self.gb, self.seq + 1), np.int32)
        for i, sid in enumerate(shard_ids):
            a = self.arrays[sid]
            off = rng.integers(0, max(a.size - self.seq - 1, 1))
            out[i] = a[off: off + self.seq + 1]
        lo = self.host * self.local_b
        local = out[lo: lo + self.local_b]
        self.state = DataState(self.state.seed, self.state.step + 1)
        return {"tokens": local[:, :-1], "labels": local[:, 1:]}

    def restore(self, state: DataState):
        self.state = dataclasses.replace(state)


def make_pipeline(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticLMData(**kw)
    if kind == "packed":
        return PackedFileData(**kw)
    raise ValueError(kind)
