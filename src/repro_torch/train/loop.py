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
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataState
from repro_torch.optim.adamw import (AdamWState, adamw_update,
                                     clip_by_global_norm, decay_mask,
                                     init_adamw)
from repro_torch.optim.compress import compress_grads, init_error_feedback
from repro_torch.tree import leaves_with_path, tree_map


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


def make_train_step(lm, *, lr, mask=None, max_grad_norm: float = 1.0,
                    num_microbatches: int = 1, compress: str = "none",
                    weight_decay: float = 0.1):
    """-> ``step(params, opt_state, batch, err_fb) -> (params, opt_state,
    err_fb, metrics)``.  ``batch`` is a dict of (B, S) tensors on the
    model's device; the parameters and the optimizer state are updated in
    place.  Weight decay reaches the leaves the reference decays, and
    compression takes its top-k and scales over the leaves the reference
    has (its layout: ``stacked=cfg.scan_layers``)."""
    stacked = lm.cfg.scan_layers

    def compute_grads(params, batch):
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
                                                  stacked=stacked)
            metrics = dict(metrics, compress_ratio=torch.tensor(ratio))
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, mask=mask,
            weight_decay=weight_decay,
            decay=decay_mask(params, stacked=stacked))
        return params, opt_state, err_fb, dict(metrics, grad_norm=gnorm)

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
    def __init__(self, lm, pipeline, *, lr, ckpt_dir: Optional[str] = None,
                 mask=None, num_microbatches: int = 1, compress: str = "none",
                 ckpt_every: int = 100, keep: int = 3,
                 max_grad_norm: float = 1.0, log_every: int = 10,
                 log_fn=print):
        self.lm = lm
        self.pipe = pipeline
        self.mask = mask
        self.compress = compress
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.log = log_fn
        self._lr = lr
        self._max_grad_norm = max_grad_norm
        self.watchdog = StragglerWatchdog()
        self.mgr = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None
        self._step_fn = make_train_step(
            lm, lr=lr, mask=mask, num_microbatches=num_microbatches,
            compress=compress, max_grad_norm=max_grad_norm)
        self.params = None
        self.opt_state = None
        self.err_fb = None
        self.step = 0

    # ------------------------------------------------------------------
    def _init_err_fb(self):
        # error feedback for every float leaf when compressing; unused
        # (the optimizer's zero-size placeholders) otherwise
        self.err_fb = (init_error_feedback(self.params)
                       if self.compress != "none"
                       else init_adamw(self.params, self.mask).mu)

    def init_or_resume(self, seed=0):
        """Resume from the newest valid checkpoint (parameters, AdamW
        state, step and data state), else ``lm.init(seed)`` with fresh
        optimizer state."""
        restored = self.mgr.restore() if self.mgr else None
        if restored is not None:
            arrays = restored["arrays"]
            self.params = CheckpointManager._unflatten_like(
                arrays, self.lm.init(seed))
            self.opt_state = self._restore_opt(arrays, restored["step"])
            self.step = restored["step"]
            if restored["data_state"]:
                self.pipe.restore(DataState.from_dict(restored["data_state"]))
            self.log(f"[trainer] resumed from step {self.step}")
        else:
            self.params = self.lm.init(seed)
            self.opt_state = init_adamw(self.params, self.mask)
        self._init_err_fb()
        return self.params

    def set_params(self, params, *, mask=None, num_microbatches: int = 1,
                   lr=None):
        """Swap in transformed parameters (quantized / with adapters): the
        optimizer state, error feedback, trainable mask and step are
        rebuilt for the new tree."""
        self.params = params
        self.mask = mask
        self.opt_state = init_adamw(params, mask)
        self._init_err_fb()
        self._step_fn = make_train_step(
            self.lm, lr=lr if lr is not None else self._lr, mask=mask,
            num_microbatches=num_microbatches, compress=self.compress,
            max_grad_norm=self._max_grad_norm)
        return params

    def _restore_opt(self, arrays, step: int) -> AdamWState:
        base = init_adamw(self.params, self.mask)

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
            batch = self._device_batch()
            self.params, self.opt_state, self.err_fb, metrics = \
                self._step_fn(self.params, self.opt_state, batch,
                              self.err_fb)
            self.step += 1
            loss = float(metrics["loss"])       # the step's one sync
            dt = time.perf_counter() - t0
            self.watchdog.observe(self.step, dt)
            if self.step % self.log_every == 0 or self.step == num_steps:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": self.step, "dt": dt, **m})
                self.log(f"[step {self.step}] loss={loss:.4f} "
                         f"ce={m.get('ce_loss', 0):.4f} dt={dt*1e3:.0f}ms")
            if self.mgr and self.step % self.ckpt_every == 0:
                self.mgr.save_async(self.step, self.params, self.opt_state,
                                    self.pipe.state)
                saved = self.step
        if self.mgr:
            if saved == self.step:
                self.mgr.wait()
            else:
                self.mgr.save(self.step, self.params, self.opt_state,
                              self.pipe.state)
        return history
