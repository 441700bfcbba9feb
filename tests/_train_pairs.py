"""Helpers of the training parity tests (``test_torch_train_*``,
``test_torch_optim.py``, ``test_torch_peft.py``): the same smoke model on
both sides (the reference's ``LM.init`` pytree bridged to torch), the
same numpy batches, and tree comparisons in the reference's layout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.model import LM as JLM
from repro_torch import configs as tconfigs
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models.model import LM as TLM


@pytest.fixture
def one_intraop_thread():
    """Run a test's CPU torch ops on one intra-op thread: the smoke
    models' tensors are too small to gain from more (a quickstart's 12
    training steps take 0.5 s on one thread, 3.2 s on eight), and the
    suite's other workers share the cores.  The previous count is
    restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(arch: str, dtype: str, kw: tuple):
    jcfg = jconfigs.get_smoke_config(arch).with_(dtype=dtype, **dict(kw))
    tcfg = tconfigs.get_smoke_config(arch).with_(dtype=dtype, **dict(kw))
    jlm = JLM(jcfg)
    return jlm, TLM(tcfg, device="cpu"), jax.jit(jlm.init)(
        jax.random.PRNGKey(0))


def pair(arch: str, dtype: str = "float32", **kw):
    """(JAX LM, port LM on the CPU, JAX params, port params) of the smoke
    config of ``arch``, with ``kw`` replaced on both configs.  The port's
    tree is a fresh copy on every call (its optimizer updates in
    place)."""
    jlm, tlm, jp = _models(arch, dtype, tuple(sorted(kw.items())))
    return jlm, tlm, jp, to_torch(jp, tlm.cfg)


def to_torch(jtree, tcfg):
    """A reference parameter tree -> the port's, on the CPU."""
    return params_from_numpy(jax.tree.map(np.asarray, jtree), tcfg, "cpu")


def batch(vocab: int, b: int = 2, s: int = 128, seed: int = 0,
          mask: bool = False) -> dict:
    """Numpy tokens / labels (and a 0/1 mask) of shape (b, s)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if mask:
        out["mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


def jbatch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def tbatch(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in b.items()}


def flat(tree, prefix=""):
    """{path: numpy array (float32 for floats)} of a reference-layout
    numpy / JAX tree, ``None`` leaves and JAX's ``float0`` left out."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    if tree is None:
        return out
    a = np.asarray(tree)
    if a.dtype == jax.dtypes.float0:
        return out
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    out[prefix] = a
    return out


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def assert_trees_close(t_tree, j_tree, tcfg, tol: float, what: str = ""):
    """The port's tree (params or grads) equals the reference's leaf by
    leaf within ``tol`` relative L2, in the reference's layout; both have
    the same float leaves."""
    got, want = flat(params_to_numpy(t_tree, tcfg)), flat(j_tree)
    assert got.keys() == want.keys(), (what, got.keys() ^ want.keys())
    worst = {k: rel_l2(got[k], want[k]) for k in want
             if want[k].dtype.kind == "f"}
    bad = {k: v for k, v in worst.items() if not v <= tol}
    assert not bad, (what, bad)
    for k in want:
        if want[k].dtype.kind != "f":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return max(worst.values())
