"""Public model API: init / prefill / decode_step.

``LM`` holds the config and the device; parameters are explicit nested
dicts of tensors in the reference's layout (``repro/models/model.py``),
with the layer stack as a list of groups.  Entry points run on the card
(``cuda``) unless the caller asks for ``device="cpu"``; with no GPU and no
explicit device they raise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dtype_of, embedding_apply,
                                       init_embedding, init_linear,
                                       init_norm, norm_apply)
from repro_torch.models.transformer import (init_stack, init_stack_cache,
                                            stack_forward)


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: the caller's, else the GPU.
    Raises when no device is given and CUDA is not available — an entry
    point never carries on on the CPU unless asked to."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")


class LM:
    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def init(self, seed: Union[int, torch.Generator] = 0) -> dict:
        """Random parameters from a seed (or a generator on this LM's
        device).  Embedding and head are drawn at the real vocab size and
        zero-padded to ``padded_vocab``, as in the reference."""
        cfg, dev = self.cfg, self.device
        gen = seed
        if not isinstance(seed, torch.Generator):
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        v_pad = cfg.padded_vocab - cfg.vocab_size
        embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, self.dtype,
                               dev)
        if v_pad:
            embed["w"] = torch.nn.functional.pad(embed["w"], (0, 0, 0, v_pad))
        params: Dict[str, Any] = {
            "embed": embed,
            "layers": init_stack(gen, cfg, self.dtype, dev),
            "final_norm": init_norm(cfg.norm, cfg.d_model, self.dtype, dev),
        }
        if not cfg.tie_embeddings:
            head = init_linear(gen, cfg.d_model, cfg.vocab_size,
                               dtype=self.dtype, device=dev)
            if v_pad:
                head["w"] = torch.nn.functional.pad(head["w"], (0, v_pad))
            params["lm_head"] = head
        return params

    # ------------------------------------------------------------------
    def head_f32(self, params: dict) -> torch.Tensor:
        """The LM head as an fp32 (V_pad, d) matrix: logits are
        ``x.float() @ head.T``.  For a tied head that is an fp32 copy of
        the embedding (0.93 GB at qwen2-1.5b width), so serving makes it
        once with :meth:`prepare` instead of on every step."""
        if "head_f32" in params:
            return params["head_f32"]
        if self.cfg.tie_embeddings:
            return params["embed"]["w"].float()
        return params["lm_head"]["w"].float().T

    def prepare(self, params: dict) -> dict:
        """Serving copy of ``params`` carrying the fp32 head, made once."""
        return {**params, "head_f32": self.head_f32(params).contiguous()}

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        logits = x.float() @ self.head_f32(params).T
        return self._mask_pad_logits(logits)

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """-1e30 the padded vocab columns (vocab_pad_multiple)."""
        v = self.cfg.vocab_size
        if logits.shape[-1] == v:
            return logits
        ids = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(ids < v, logits,
                           torch.tensor(-1e30, device=logits.device))

    def backbone(self, params, tokens, *, mode="prefill", cache=None,
                 pos=None):
        cfg = self.cfg
        x = embedding_apply(params["embed"], tokens).to(self.dtype)
        x, new_cache = stack_forward(params["layers"], x, cfg, mode=mode,
                                     cache=cache, pos=pos)
        x = norm_apply(cfg.norm, params["final_norm"], x, cfg.norm_eps)
        return x, new_cache

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *,
                   kv_dtype: Optional[str] = None) -> list:
        """Contiguous prefill cache; ``kv_dtype`` overrides the config
        (the paged engine's bf16 staging cache)."""
        return init_stack_cache(self.cfg, batch, max_len, kv_dtype=kv_dtype,
                                device=self.device)

    def init_paged_cache(self, n_slots: int, n_pages: int,
                         pages_per_slot: int, *, page_size: int = 256
                         ) -> list:
        """Paged decode cache: per-layer page pools and one block table
        shared by every layer."""
        return init_stack_cache(self.cfg, n_slots, 0, paged=True,
                                n_pages=n_pages,
                                pages_per_slot=pages_per_slot,
                                page_size=page_size, device=self.device)

    @torch.no_grad()
    def logits(self, params, tokens) -> torch.Tensor:
        x, _ = self.backbone(params, tokens, mode="prefill")
        return self._logits(params, x)

    @torch.no_grad()
    def prefill(self, params, tokens, cache, *, lengths=None):
        """Full-context pass filling the cache (in place); returns
        last-token logits.  ``lengths`` (B,) takes each row's logits at
        position ``lengths[b]-1`` (right-padded batched admission)."""
        x, cache = self.backbone(params, tokens, mode="prefill", cache=cache)
        if lengths is None:
            last = x[:, -1]
        else:
            # clamp explicitly, as the reference does: a torch gather
            # raises where XLA would clamp
            idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
            last = x[torch.arange(x.shape[0], device=x.device), idx]
        return self._logits(params, last), cache

    @torch.no_grad()
    def decode_step(self, params, token, cache, pos):
        """token: (S,) int; pos: (S,) write positions -> (logits (S,V),
        cache updated in place)."""
        x, cache = self.backbone(params, token[:, None], mode="decode",
                                 cache=cache, pos=pos)
        return self._logits(params, x[:, 0]), cache
