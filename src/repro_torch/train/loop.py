"""Training loop: the step factory and the fault-tolerant ``Trainer``, the
port's copy of ``repro/train/loop.py``.

``make_train_step`` builds the update:
    gradients of ``LM.loss`` (microbatches accumulated in fp32) ->
    [compression with error feedback] -> global-norm clip -> AdamW (masked
    for PEFT).

Gradients are taken for every float leaf, frozen base weights included,
as the reference differentiates the whole tree: the clip's global norm
counts them.  Integer leaves (int8 / int4 bases) get none (``None``,
the reference's ``float0``), and AdamW skips them.

``Trainer`` owns checkpointing (async, atomic), resume from the latest
valid step, the straggler watchdog, and the loop.  Unlike the reference,
whose step is an asynchronous dispatch, a step's wall time ends once its
loss is read on the host: one device sync a step, so the watchdog sees
device time.

Under a mesh (``make_train_step(mesh=, specs=)``, ``Trainer(mesh=)``;
``launch.mesh``) each rank holds its pieces of the parameters, the
gradients and the AdamW moments, placed by ``sharding.rules``
(``make_param_specs``: tensor parallel over ``"model"``, and with
``fsdp=True`` large leaves split over ``"data"``), and computes the
reference's single-device step:
  * every rank takes its rows of each global microbatch (``batch_spec``);
    its loss is its share of the global mean (``LM.loss(data=)``);
  * the leaves that ``"data"`` splits are gathered whole once a step
    (``collectives.gather_from``, the whole tree at once; gathering each
    layer on use is a later optimisation) and their gradients come back
    reduce-scattered through its backward; the gradients of leaves
    whole over ``"data"`` are summed over the data axis (one fp32
    all-reduce);
  * the model axis needs no gradient reduction: the f / g pairs of the
    forward give each rank its slice's gradient, and replicated leaves
    (norms, row-split biases) equal gradients on every model rank;
  * compression works on whole leaves and the clip's norm counts every
    element once (``optim``'s ``mesh=`` arguments).
The reference's ``Trainer`` takes ``param_shardings`` and leaves its
parameters unplaced (GSPMD keeps the semantics); the port places them by
the rules, as the reference's FSDP train cell does.
"""
from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataState
from repro_torch.launch.roofline import CollectiveStats
from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                     clip_by_global_norm, decay_mask,
                                     init_adamw)
from repro_torch.optim.compress import compress_grads, init_error_feedback
from repro_torch.sharding.collectives import (all_reduce, barrier,
                                              gather_from)
from repro_torch.sharding.rules import (batch_spec, gather_leaf, local_leaf,
                                        make_param_specs, shard_params,
                                        split_axes)
from repro_torch.sharding.tp import check_trainable
from repro_torch.tree import leaves, leaves_with_path, tree_map


# ---------------------------------------------------------------------------
# Step factory


def _is_float(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


def loss_and_grads(lm, params, batch):
    """``(loss, metrics, grads)`` of ``lm.loss`` at ``params``: ``grads``
    mirrors the tree, each float leaf's gradient in its dtype (zeros for
    a leaf the loss does not read, as JAX gives), ``None`` at integer
    leaves."""
    leaves = []

    def track(p):
        if not _is_float(p):
            return p
        t = p.detach().requires_grad_()
        leaves.append(t)
        return t

    with torch.enable_grad():
        live = tree_map(track, params)
        loss, metrics = lm.loss(live, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, gs))
    grads = tree_map(lambda p: next(it) if _is_float(p) else None, params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _data_dim(spec) -> "int | None":
    """The dim a placement splits over ``"data"``, if any."""
    for dim, entry in enumerate(spec):
        if entry == "data":
            return dim
    return None


def fsdp_leaf(piece, spec, mesh):
    """A leaf whole over the data axis: this rank's ``piece`` gathered
    (``collectives.gather_from``, counted as ``all-gather/data``) where
    its placement ``spec`` splits it over ``"data"``, else ``piece``.
    The training step and the dry-run's serving cells gather through
    it."""
    dim = _data_dim(spec) if isinstance(piece, torch.Tensor) else None
    return piece if dim is None else gather_from(piece, dim, mesh, "data")


def _rank_rows(batch: dict, mesh, num_microbatches: int) -> dict:
    """This rank's rows of each microbatch of the global ``batch``: rows
    of global microbatch i, so that the microbatches group the rows as
    one rank's do."""
    b = next(iter(batch.values())).shape[0] // num_microbatches
    if batch_spec(mesh, b)[0] is None:
        raise ValueError(f"a microbatch of {b} rows does not split over a "
                         f"data axis of {mesh.data}")
    per = b // mesh.data
    lo = mesh.data_rank * per
    idx = torch.cat([torch.arange(i * b + lo, i * b + lo + per)
                     for i in range(num_microbatches)])
    return {k: v[idx.to(v.device)] for k, v in batch.items()}


def sharded_grads(lm, params, batch, mesh, specs,
                  num_microbatches: int = 1, local_batch: bool = False):
    """``(grads, metrics)`` of one rank of ``mesh``: ``params`` its pieces
    (placed by ``specs``), ``batch`` the global batch, or with
    ``local_batch`` this rank's rows of it already (a dry-run cell's
    argument, its microbatches consecutive runs of those rows).
    ``grads`` are the pieces of the single-device gradient (microbatches
    averaged, fp32 where they are accumulated), ``metrics`` the global
    ones, equal on every rank."""
    if mesh.data > 1 and not local_batch:
        batch = _rank_rows(batch, mesh, num_microbatches)
    tracked, whole_over_data = [], []

    def track(p, spec):
        if not _is_float(p):
            return p
        t = p.detach().requires_grad_()
        whole_over_data.append(_data_dim(spec) is None)
        tracked.append(t)
        return fsdp_leaf(t, spec, mesh)

    with torch.enable_grad():
        live = tree_map(track, params, specs)
    b = next(iter(batch.values())).shape[0] // num_microbatches
    acc, per_mb = None, []
    for i in range(num_microbatches):
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        with torch.enable_grad():
            loss, metrics = lm.loss(live, mb, data=mesh)
            gs = torch.autograd.grad(loss, tracked, allow_unused=True)
        gs = [torch.zeros_like(t) if g is None else g
              for t, g in zip(tracked, gs)]
        per_mb.append({k: v.detach() for k, v in metrics.items()})
        if num_microbatches == 1:
            acc = gs
        elif acc is None:
            acc = [g.float() for g in gs]
        else:
            for a, g in zip(acc, gs):
                a.add_(g)
    if mesh.data > 1:
        # the leaves whole over "data": one flat fp32 sum over the axis
        idx = [j for j, w in enumerate(whole_over_data) if w]
        if idx:
            flat = all_reduce(torch.cat([acc[j].float().reshape(-1)
                                         for j in idx]), "sum", mesh, "data")
            for j, piece in zip(idx, torch.split(
                    flat, [acc[j].numel() for j in idx])):
                acc[j] = piece.view_as(acc[j]).to(acc[j].dtype)
    if num_microbatches > 1:
        acc = [a / num_microbatches for a in acc]
    keys = list(per_mb[0])
    vals = torch.stack([torch.stack([m[k] for m in per_mb]).mean(0)
                        for k in keys])
    if mesh.data > 1:
        vals = all_reduce(vals, "sum", mesh, "data")
    it = iter(acc)
    grads = tree_map(lambda p: next(it) if _is_float(p) else None, params)
    return grads, dict(zip(keys, vals))


def make_train_step(lm, *, lr, mask=None, max_grad_norm: float = 1.0,
                    num_microbatches: int = 1, compress: str = "none",
                    weight_decay: float = 0.1, mesh=None, specs=None,
                    local_batch: bool = False):
    """-> ``step(params, opt_state, batch, err_fb) -> (params, opt_state,
    err_fb, metrics)``.  ``batch`` is a dict of (B, S) tensors on the
    model's device; the parameters and the optimizer state are updated in
    place.  Weight decay reaches the leaves the reference decays, and
    compression takes its top-k and scales over the leaves the reference
    has (its layout: ``stacked=cfg.scan_layers``).

    ``mesh`` (a world of more than one rank): ``lm`` is this rank's LM
    (``cfg.model_parallel`` the mesh's model axis), the parameters, state
    and error feedback are this rank's pieces placed by ``specs`` (every
    rank's tree and placements alike), ``batch`` is the global batch, and
    the step is the single-device step (:func:`sharded_grads`;
    ``local_batch``: ``batch`` holds this rank's rows only).
    ``step.compute_grads(params, batch) -> (grads, metrics)`` is the
    step's gradient alone, before compression and the clip."""
    stacked = lm.cfg.scan_layers
    if mesh is not None and mesh.world == 1:
        mesh = None

    def compute_grads(params, batch):
        if mesh is not None:
            return sharded_grads(lm, params, batch, mesh, specs,
                                 num_microbatches, local_batch)
        if num_microbatches == 1:
            _, metrics, grads = loss_and_grads(lm, params, batch)
            return grads, metrics
        b = next(iter(batch.values())).shape[0] // num_microbatches
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device)
                       if _is_float(p) else None, params)
        per_mb = []
        for i in range(num_microbatches):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            _, metrics, g = loss_and_grads(lm, params, mb)
            tree_map(lambda a, gg: None if a is None else a.add_(gg), acc, g)
            per_mb.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean(0)
                   for k in per_mb[0]}
        grads = tree_map(lambda a: None if a is None
                         else a / num_microbatches, acc)
        return grads, metrics

    def step(params, opt_state: AdamWState, batch, err_fb):
        grads, metrics = compute_grads(params, batch)
        if compress != "none":
            grads, err_fb, ratio = compress_grads(grads, err_fb,
                                                  scheme=compress,
                                                  stacked=stacked,
                                                  mesh=mesh, specs=specs)
            metrics = dict(metrics, compress_ratio=torch.tensor(ratio))
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, mesh=mesh,
                                           specs=specs)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, mask=mask,
            weight_decay=weight_decay,
            decay=decay_mask(params, stacked=stacked))
        return params, opt_state, err_fb, dict(metrics, grad_norm=gnorm)

    step.compute_grads = compute_grads
    return step


# ---------------------------------------------------------------------------
# Straggler watchdog


@dataclass
class StragglerWatchdog:
    """EMA-based step-time anomaly detector.

    On a fleet, ``action`` would tell the controller to evict or replace
    the slow host; here it records events so behaviour is testable.
    """
    threshold: float = 3.0
    ema_decay: float = 0.9
    warmup_steps: int = 5
    ema: Optional[float] = None
    seen: int = 0
    events: list = field(default_factory=list)
    action: Optional[Callable[[int, float, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        self.seen += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = (self.seen > self.warmup_steps
                        and dt > self.threshold * self.ema)
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
            if self.action:
                self.action(step, dt, self.ema)
        else:
            # the EMA tracks healthy steps only (stragglers would poison it)
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return is_straggler


# ---------------------------------------------------------------------------
# Trainer


class Trainer:
    """``mesh`` (a world of more than one rank; ``launch.mesh``) makes this
    one rank of a sharded trainer: ``lm`` becomes this rank's LM (its
    config marked with the mesh's model axis, refused by
    ``sharding.tp.check_trainable`` where training does not shard it),
    and the parameters, gradients and AdamW moments are its pieces,
    placed by ``param_specs`` (default ``make_param_specs(params, mesh)``:
    tensor parallel, whole over ``"data"``; pass ``make_param_specs(...,
    fsdp=True)`` for FSDP).  Every rank runs ``lm.init(seed)`` whole and
    keeps its pieces; the pipeline is the global one on every rank.
    Checkpoints are written whole, in the single-rank layout, by rank 0
    (every rank gathers), and resume on any world.
    ``step_collectives`` sums the collectives of the steps run (kind /
    axis -> calls, bytes), ``to_dict(steps=steps_run)`` a step's."""

    def __init__(self, lm, pipeline, *, lr, ckpt_dir: Optional[str] = None,
                 mesh=None, param_specs=None, mask=None,
                 num_microbatches: int = 1, compress: str = "none",
                 ckpt_every: int = 100, keep: int = 3,
                 max_grad_norm: float = 1.0, log_every: int = 10,
                 log_fn=print):
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if self.mesh is not None:
            lm = type(lm)(lm.cfg.with_(model_parallel=mesh.model),
                          device=lm.device, mesh=mesh)
        self.lm = lm
        self.pipe = pipeline
        self.mask = mask
        self.compress = compress
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self._lr = lr
        self._max_grad_norm = max_grad_norm
        self._num_microbatches = num_microbatches
        self._param_specs = param_specs
        self.specs = None
        self.watchdog = StragglerWatchdog()
        self.mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
        self.step_collectives = CollectiveStats()
        self.steps_run = 0
        self.step_times: list = []
        self._step_fn = None
        self.params = None
        self.opt_state = None
        self.err_fb = None
        self.step = 0

    # ------------------------------------------------------------------
    def _leafwise(self, fn, tree):
        """``fn(leaf, placement)`` over the tensors of a state tree shaped
        like the parameters (not the zero-size placeholders)."""
        return tree_map(lambda t, s: fn(t, s) if isinstance(
            t, torch.Tensor) and t.numel() and t.dim() == len(s) else t,
            tree, self.specs)

    def _place(self, params, opt_state: AdamWState, mask,
               num_microbatches: int, lr, specs=None) -> None:
        """Take whole parameters and optimizer state: under a mesh, check
        and place them and keep this rank's pieces; build the step and
        the error feedback."""
        if self.mesh is not None:
            check_trainable(self.lm.cfg, params)
            self.specs = specs if specs is not None \
                else make_param_specs(params, self.mesh)
            params = shard_params(params, self.specs, self.mesh)
            cut = functools.partial(self._leafwise, lambda t, s: local_leaf(
                t, s, self.mesh))
            opt_state = AdamWState(step=opt_state.step,
                                   mu=cut(opt_state.mu), nu=cut(opt_state.nu))
        self.params, self.opt_state, self.mask = params, opt_state, mask
        # error feedback for every float leaf when compressing; unused
        # (the optimizer's zero-size placeholders) otherwise
        self.err_fb = (init_error_feedback(params)
                       if self.compress != "none"
                       else init_adamw(params, mask).mu)
        self._step_fn = make_train_step(
            self.lm, lr=lr, mask=mask, num_microbatches=num_microbatches,
            compress=self.compress, max_grad_norm=self._max_grad_norm,
            mesh=self.mesh, specs=self.specs)

    def init_or_resume(self, seed=0):
        """Resume from the newest valid checkpoint (parameters, AdamW
        state, step and data state), else ``lm.init(seed)`` with fresh
        optimizer state; under a mesh every rank reads the whole tree and
        keeps its pieces."""
        restored = self.mgr.restore() if self.mgr else None
        whole = self.lm.init(seed)
        if restored is not None:
            arrays = restored["arrays"]
            params = CheckpointManager._unflatten_like(arrays, whole)
            opt = self._restore_opt(arrays, restored["step"], params)
            self.step = restored["step"]
            if restored["data_state"]:
                self.pipe.restore(DataState.from_dict(restored["data_state"]))
            self.log(f"[trainer] resumed from step {self.step}")
        else:
            params, opt = whole, init_adamw(whole, self.mask)
        self._place(params, opt, self.mask, self._num_microbatches,
                    self._lr, self._param_specs)
        return self.params

    def set_params(self, params, *, mask=None, num_microbatches: int = 1,
                   lr=None, param_specs=None):
        """Swap in transformed parameters (quantized / with adapters; whole
        under a mesh, placed by ``param_specs`` or the default rules): the
        optimizer state, error feedback, trainable mask and step are
        rebuilt for the new tree.  Returns this rank's tree."""
        self._num_microbatches = num_microbatches
        self._place(params, init_adamw(params, mask), mask, num_microbatches,
                    lr if lr is not None else self._lr, param_specs)
        return self.params

    def _restore_opt(self, arrays, step: int, params) -> AdamWState:
        base = init_adamw(params, self.mask)

        def pick(prefix, like):
            out = {p: arrays[prefix + p].to(device=t.device, dtype=t.dtype)
                   if prefix + p in arrays else t
                   for p, t in leaves_with_path(like)}
            it = iter(out.values())
            return tree_map(lambda _: next(it), like)
        saved = arrays.get("opt/step")
        return AdamWState(step=int(saved) if saved is not None else step,
                          mu=pick("opt/mu/", base.mu),
                          nu=pick("opt/nu/", base.nu))

    def whole_state(self):
        """(whole parameters, whole AdamW state): this rank's own under no
        mesh; gathered from every rank's pieces under one (collectives on
        every rank)."""
        if self.mesh is None:
            return self.params, self.opt_state
        join = functools.partial(self._leafwise, lambda t, s: gather_leaf(
            t, s, self.mesh))
        return join(self.params), AdamWState(step=self.opt_state.step,
                                             mu=join(self.opt_state.mu),
                                             nu=join(self.opt_state.nu))

    def param_count(self) -> int:
        """Elements of the whole parameter tree (from this rank's pieces
        and their placements: no collective)."""
        if self.mesh is None:
            return sum(t.numel() for t in leaves(self.params)
                       if isinstance(t, torch.Tensor))
        return sum(t.numel() * math.prod(self.mesh.shape[a]
                                         for a in split_axes(s))
                   for t, s in zip(leaves(self.params), leaves(self.specs))
                   if isinstance(t, torch.Tensor))

    def _save(self, asynchronous: bool) -> None:
        """Checkpoint the whole state; rank 0 writes, every rank
        gathers."""
        params, opt = self.whole_state()
        if self.mesh is not None and self.mesh.rank != 0:
            return
        save = self.mgr.save_async if asynchronous else self.mgr.save
        save(self.step, params, opt, self.pipe.state)

    # ------------------------------------------------------------------
    def _device_batch(self) -> dict:
        dev = self.lm.device
        return {k: torch.from_numpy(v).to(dev, dtype=torch.long)
                for k, v in self.pipe.next_batch().items()}

    def run(self, num_steps: int):
        """Train until ``self.step == num_steps``; checkpoint every
        ``ckpt_every`` steps (async) and at the end.  Returns the history:
        ``{"step", "dt", **metrics}`` every ``log_every`` steps and at the
        last."""
        if self.params is None:
            raise RuntimeError("call init_or_resume first")
        history = []
        saved = None
        while self.step < num_steps:
            t0 = time.perf_counter()
            before = None if self.mesh is None else self.mesh.stats.copy()
            batch = self._device_batch()
            self.params, self.opt_state, self.err_fb, metrics = \
                self._step_fn(self.params, self.opt_state, batch,
                              self.err_fb)
            self.step += 1
            loss = float(metrics["loss"])       # the step's one sync
            dt = time.perf_counter() - t0
            if before is not None:
                self.step_collectives.merge(self.mesh.stats.since(before))
            self.steps_run += 1
            self.step_times.append(dt)
            self.watchdog.observe(self.step, dt)
            if self.step % self.log_every == 0 or self.step == num_steps:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": self.step, "dt": dt, **m})
                self.log(f"[step {self.step}] loss={loss:.4f} "
                         f"ce={m.get('ce_loss', 0):.4f} dt={dt*1e3:.0f}ms")
            if self.mgr and self.step % self.ckpt_every == 0:
                self._save(asynchronous=True)
                saved = self.step
        if self.mgr:
            if saved == self.step:
                self.mgr.wait()
            else:
                self._save(asynchronous=False)
            if self.mesh is not None:
                barrier(self.mesh)      # rank 0's write is on disk
        return history
