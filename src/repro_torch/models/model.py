"""Public model API: init / loss / prefill / prefill_paged / verify_paged
/ decode_step.

``LM`` holds the config and the device; parameters are explicit nested
dicts of tensors in the reference's layout (``repro/models/model.py``),
with the layer stack as a list of groups.  Entry points run on the card
(``cuda``) unless the caller asks for ``device="cpu"``; with no GPU and no
explicit device they raise.  ``loss`` is the training forward: the
reference's training math in plain torch under autograd on every device
(``train=True`` through the stack), and a chunked cross-entropy that
never holds the whole (B, S, vocab) logits.  Encoder-decoder (whisper)
and VLM models take their source as ``modality_input`` (B, T_src, d): the
stub frontends' frame or patch embeddings (``configs.specs.modality_spec``)
in ``loss``, ``logits`` and ``prefill``; decode reads the source's K / V
from the cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (dtype_of, embedding_apply,
                                       init_embedding, init_linear,
                                       init_norm, norm_apply)
from repro_torch.models.transformer import (encoder_forward, init_encoder,
                                            init_stack, init_stack_cache,
                                            stack_forward)
from repro_torch.sharding import tp
from repro_torch.sharding.collectives import tensor_parallel


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
    """``mesh`` (a ``repro_torch.launch.mesh.Mesh`` whose model axis is
    ``cfg.model_parallel``) makes this LM one rank of a tensor-parallel
    model: its parameters are the rank's slice
    (``sharding.rules.shard_params``), every serving forward runs under
    the mesh (``sharding.tp``) and the logits are gathered whole.  The
    training forward refuses a mesh."""

    def __init__(self, cfg: ModelConfig, device=None, mesh=None):
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.device = resolve_device(device)
        m = 1 if mesh is None else mesh.model
        if m != cfg.model_parallel:
            raise ValueError(f"LM: cfg.model_parallel={cfg.model_parallel} "
                             f"but the mesh's model axis is {m}")
        self.mesh = mesh if m > 1 else None

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
        if cfg.encoder is not None:
            params["encoder"] = init_encoder(gen, cfg, self.dtype, dev)
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
        logits = tp.logits_whole(logits, self.cfg.padded_vocab, self.mesh)
        return self._mask_pad_logits(logits)

    def _mask_pad_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """-1e30 the padded vocab columns (vocab_pad_multiple)."""
        v = self.cfg.vocab_size
        if logits.shape[-1] == v:
            return logits
        ids = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(ids < v, logits,
                           torch.tensor(-1e30, device=logits.device))

    def _encode_source(self, params, modality_input, train=False):
        """The cross-attention source of a stub frontend's embeddings
        (B, T_src, d): the encoder's output (whisper), or the patch
        embeddings themselves (VLM)."""
        if self.cfg.encoder is not None:
            return encoder_forward(params["encoder"], modality_input,
                                   self.cfg, train=train)
        return modality_input

    def backbone(self, params, tokens, *, mode="prefill", cache=None,
                 pos=None, train=False, modality_input=None):
        """-> (final-normed states, cache, aux).  ``train=True`` is the
        training forward (see ``group_forward``); ``aux`` holds the MoE
        layers' losses and dropped fractions, summed over the stack.
        ``modality_input`` is encoded once outside decode."""
        cfg = self.cfg
        if train and self.mesh is not None:
            raise NotImplementedError(
                "training under a model axis > 1 is not ported yet "
                "(ROADMAP A8.2: sharded training with FSDP)")
        with tensor_parallel(self.mesh, cfg.tp_attn_impl):
            x = self._embed(params, tokens)
            cross_src = None
            if modality_input is not None and mode != "decode":
                cross_src = self._encode_source(params, modality_input,
                                                train)
            x, new_cache, aux = stack_forward(params["layers"], x, cfg,
                                              mode=mode, cache=cache,
                                              pos=pos, train=train,
                                              cross_src=cross_src)
            x = norm_apply(cfg.norm, params["final_norm"], x, cfg.norm_eps,
                           train=train)
        return x, new_cache, aux

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        w = params["embed"]["w"]
        if self.mesh is not None and w.shape[0] != self.cfg.padded_vocab:
            return tp.embed(w, tokens, self.mesh).to(self.dtype)
        return embedding_apply(params["embed"], tokens).to(self.dtype)

    # ------------------------------------------------------------------
    def _head_w(self, params: dict) -> torch.Tensor:
        """The live (d, V_pad) head of the parameters: the embedding's
        transpose when tied.  The loss reads it, never ``head_f32`` (a
        serving copy that goes stale once a step has run)."""
        if self.cfg.tie_embeddings:
            return params["embed"]["w"].T
        return params["lm_head"]["w"]

    def loss(self, params: dict,
             batch: dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {tokens (B,S), labels (B,S), [mask (B,S)],
        [modality_input]} on this LM's device -> (scalar loss, metrics).
        The training forward (no kernel launches; differentiable), then
        :func:`chunked_cross_entropy` against the live head; every aux key
        ending in ``_loss`` (the MoE layers' load-balance and z losses) is
        added to the loss, as in the reference."""
        cfg = self.cfg
        x, _, aux = self.backbone(
            params, batch["tokens"], train=True,
            modality_input=batch.get("modality_input"))
        ce, acc = chunked_cross_entropy(x, self._head_w(params),
                                        batch["labels"],
                                        mask=batch.get("mask"),
                                        chunk=cfg.ce_chunk,
                                        n_valid=cfg.vocab_size)
        loss = ce
        metrics = {"ce_loss": ce, "accuracy": acc}
        for k, v in aux.items():
            metrics[k] = v
            if k.endswith("_loss"):
                loss = loss + v
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *,
                   kv_dtype: Optional[str] = None) -> list:
        """Contiguous cache (attention blocks; bf16, or int8 / fp8 with
        per-position scales, from ``cfg.kv_cache_dtype``) and recurrent
        states (RWKV-6 and Mamba blocks; a hybrid group holds both kinds);
        ``kv_dtype`` overrides the config (the paged engine's bf16 staging
        cache)."""
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
    def logits(self, params, tokens, *, modality_input=None) -> torch.Tensor:
        x, _, _ = self.backbone(params, tokens, mode="prefill",
                                modality_input=modality_input)
        return self._logits(params, x)

    @torch.no_grad()
    def prefill(self, params, tokens, cache, *, modality_input=None,
                lengths=None):
        """Full-context pass filling the cache (in place; a
        cross-attention block's source K / V are new tensors of the
        returned cache); returns last-token logits.  ``lengths`` (B,)
        takes each row's logits at position ``lengths[b]-1`` (right-padded
        batched admission)."""
        x, cache, _ = self.backbone(params, tokens, mode="prefill",
                                    cache=cache,
                                    modality_input=modality_input)
        if lengths is None:
            return self._logits(params, x[:, -1]), cache
        return self._logits(params, self._last(x, lengths)), cache

    @staticmethod
    def _last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Row b's hidden state at position ``lengths[b] - 1``, clamped
        explicitly as the reference does (a torch gather raises where XLA
        would clamp; a length-0 pad row takes position 0)."""
        idx = torch.clamp(lengths.long() - 1, 0, x.shape[1] - 1)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    @torch.no_grad()
    def prefill_paged(self, params, tokens, cache, slot_ids, starts, lengths,
                      max_pages: Optional[int] = None):
        """Chunked prefill continuation straight into the paged cache:
        ``tokens`` (B,c) right-padded chunks land at absolute positions
        ``starts[b] + [0, lengths[b])`` of slot ``slot_ids[b]`` (in place);
        each chunk's queries attend the slot's cached prefix plus the chunk
        itself (``attention_prefill_paged``).  Returns the logits at each
        row's last chunk token and the cache.  ``max_pages`` narrows the
        block table to the batch's prefix span."""
        pos = (slot_ids, starts, lengths) if max_pages is None \
            else (slot_ids, starts, lengths, max_pages)
        x, cache, _ = self.backbone(params, tokens, mode="prefill",
                                    cache=cache, pos=pos)
        return self._logits(params, self._last(x, lengths)), cache

    @torch.no_grad()
    def verify_paged(self, params, tokens, cache, stage, lengths, widths,
                     max_pages: Optional[int] = None):
        """Speculative verify (``repro_torch.spec``): score ``tokens``
        (S, W), the last accepted token followed by drafts, right-padded,
        in one forward.  Row s's chunk sits at logical positions
        ``lengths[s] + [0, widths[s])`` of its slot; queries attend the
        slot's paged prefix plus the chunk causally
        (``attention_verify_paged``).  The chunk's K/V is written into
        ``stage`` (an (S, W) bf16 cache from :meth:`init_cache`), not the
        pools, which are only read.  Returns the logits at all W positions
        ((S, W, V)) and the filled stage cache.  ``max_pages`` narrows the
        block table to the batch's deepest prefix."""
        pos = (lengths, widths) if max_pages is None \
            else (lengths, widths, max_pages)
        x, out, _ = self.backbone(params, tokens, mode="verify",
                                  cache=_zip_verify_cache(cache, stage),
                                  pos=pos)
        return self._logits(params, x), _unzip_stage(out)

    @torch.no_grad()
    def decode_step(self, params, token, cache, pos):
        """token: (S,) int; pos: (S,) write positions (or one position for
        every row) -> (logits (S,V), cache).  The cache is paged or
        contiguous (the eager Engine's or a draft LM's) and updated in
        place; RWKV-6 and Mamba blocks return new state tensors and ignore
        ``pos``."""
        x, cache, _ = self.backbone(params, token[:, None], mode="decode",
                                    cache=cache, pos=pos)
        return self._logits(params, x[:, 0]), cache


# ---------------------------------------------------------------------------
# Speculative-verify cache plumbing (repro_torch.spec)


def _zip_verify_cache(paged: list, stage: list) -> list:
    """Pair a paged cache with a contiguous staging cache of the same
    block structure into the per-block ``{"kv": <paged node>, "stage":
    <contiguous node>}`` that ``mode="verify"`` reads."""
    return [{blk: {"kv": pg[blk]["kv"], "stage": sg[blk]["kv"]}
             for blk in pg} for pg, sg in zip(paged, stage)]


def _unzip_stage(out: list) -> list:
    """The verify output's staging nodes, renamed back to ``kv`` so that
    the result mirrors an :meth:`LM.init_cache` cache (what
    ``commit_spec_cache`` walks)."""
    return [{blk: {"kv": node["stage"]} for blk, node in group.items()}
            for group in out]


# ---------------------------------------------------------------------------
# Chunked cross-entropy


def _chunk_ce(x_c, labels_c, mask_c, head_w, n_valid: Optional[int]):
    """One S-chunk: fp32 logits against the fp32 head (padded vocab
    columns at -1e30), the summed masked CE and the summed masked hits
    (argmax, ties to the lower id as in JAX)."""
    logits = x_c.float() @ head_w.float()
    v_total = logits.shape[-1]
    if n_valid is not None and n_valid < v_total:
        ids = torch.arange(v_total, device=logits.device)
        logits = torch.where(ids < n_valid, logits,
                             torch.tensor(-1e30, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    ce = (lse - lab) * mask_c
    hit = (torch.argmax(logits, -1) == labels_c).float() * mask_c
    return ce.sum(), hit.sum()


def chunked_cross_entropy(x: torch.Tensor, head_w: torch.Tensor,
                          labels: torch.Tensor, *,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = 1024, n_valid: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE and accuracy over (B,S,d) final states without
    materializing the (B,S,V) logits: S is cut into chunks of ``chunk``
    (one chunk when it does not divide S, as in the reference), each
    checkpointed, so backward recomputes one chunk's logits at a time.
    ``mask`` (B,S) weights positions; the denominator is its sum (at least
    1)."""
    b, s, _ = x.shape
    c = min(chunk, s)
    if s % c:
        c = s                                    # fallback: single chunk
    mask = (torch.ones((b, s), device=x.device) if mask is None
            else mask.float())
    labels = labels.long()
    tot = torch.zeros((), device=x.device)
    hits = torch.zeros((), device=x.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        ce, hit = checkpoint(_chunk_ce, x[:, sl], labels[:, sl], mask[:, sl],
                             head_w, n_valid, use_reentrant=False)
        tot, hits = tot + ce, hits + hit
    denom = torch.clamp(mask.sum(), min=1.0)
    return tot / denom, hits / denom
