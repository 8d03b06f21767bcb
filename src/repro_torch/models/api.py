"""Unified model API: one bundle per architecture family (counterpart of
``repro.models.api``): dense, moe, vlm, ssm, hybrid and audio.

For each of them:
  * ``init_params(generator)``                    (on the generator's device)
  * ``loss(params, batch)``                       (training forward)
  * ``prefill(params, batch)``                    (build decode state)
  * ``decode_step(params, state, tokens, len)``   (one new token; the KV
    caches, SSM states or both, updated in place)

Batch layout: ``{tokens (B, S), targets (B, S)}`` integer tensors, a vlm's
``patches (B, P, D)`` beside them (its ``targets`` cover the text only),
and for ``prefill`` an optional ``max_len`` (the transformer's caches;
ssm, hybrid and audio ignore it, as the reference does). The audio family
(whisper) adds ``frames (B, T, D)``, the stub conv frontend's output, to
``loss`` and ``prefill``; its decode state is ``(enc_out, caches)``.
``cache_len`` is a Python int; ``decode_step`` takes tokens only.

``input_specs(shape)`` / ``state_specs(shape)`` give a ``ShapeCfg``'s
batch and decode state as ``device="meta"`` tensors (no allocation) with
the reference's shapes and dtypes: tokens and targets int32, a vlm's
patches and whisper's frames in the config's dtype, KV caches ``(L, B,
S, n_kv, hd)`` in the config's dtype. ``launch/dryrun`` places them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.layers import mask_padded_vocab, xent_loss


@dataclasses.dataclass
class ModelAPI:
    cfg: ArchConfig
    init_params: Callable                # (generator) -> params
    loss: Callable                       # (params, batch) -> (loss, aux)
    prefill: Callable                    # (params, batch) -> (logits, state)
    decode_step: Callable                # (params, state, tokens, cache_len)
    input_specs: Optional[Callable] = None   # (ShapeCfg) -> batch specs
    state_specs: Optional[Callable] = None   # (ShapeCfg) -> state specs


I32 = torch.int32


def _sds(shape, dtype) -> torch.Tensor:
    """A shape and dtype, allocated nowhere (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_specs(shape: ShapeCfg, seq: int) -> Dict[str, torch.Tensor]:
    """tokens and, for a train shape, targets: ``(B, seq)``, or ``(B,
    1)`` for a decode shape."""
    B = shape.global_batch
    if shape.kind == "train":
        return {"tokens": _sds((B, seq), I32), "targets": _sds((B, seq), I32)}
    if shape.kind == "prefill":
        return {"tokens": _sds((B, seq), I32)}
    return {"tokens": _sds((B, 1), I32)}


def _ssm_state_specs(cfg: ArchConfig, B: int) -> Tuple[torch.Tensor, ...]:
    """The conv and SSM states ``(L, B, d_conv - 1, convd)`` in the
    config's dtype and ``(L, B, H, head_dim, N)`` in float32."""
    _, H, convd, N = ssm.dims(cfg)
    return (_sds((cfg.n_layers, B, cfg.ssm.d_conv - 1, convd),
                 cfg.torch_dtype),
            _sds((cfg.n_layers, B, H, cfg.ssm.head_dim, N), torch.float32))


def _kv_specs(cfg: ArchConfig, n: int, B: int, S: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    sh = (n, B, S, cfg.n_kv_heads, cfg.hd)
    return _sds(sh, cfg.torch_dtype), _sds(sh, cfg.torch_dtype)


def build_model(cfg: ArchConfig) -> ModelAPI:
    if cfg.family in ("dense", "moe", "vlm"):
        return _build_transformer(cfg)
    if cfg.family == "ssm":
        return _build_ssm(cfg)
    if cfg.family == "hybrid":
        return _build_hybrid(cfg)
    if cfg.family == "audio":
        return _build_encdec(cfg)
    raise ValueError(cfg.family)


def _build_transformer(cfg: ArchConfig) -> ModelAPI:
    Pn = cfg.n_patches if cfg.family == "vlm" else 0

    def loss(params, batch):
        logits, _, aux = transformer.forward(
            params, cfg, batch["tokens"], embeds=batch.get("patches"))
        txt = logits[:, Pn:, :]
        return xent_loss(txt, batch["targets"], cfg.vocab) + aux, aux

    @torch.no_grad()
    def prefill(params, batch):
        """The last position's logits, *unmasked* as in the reference, and
        the caches (``max_len`` long, default the prompt's length with a
        vlm's patches)."""
        B, S = batch["tokens"].shape
        caches = transformer.init_caches(
            cfg, B, batch.get("max_len", S + Pn), device=params.embed.device)
        logits, caches, _ = transformer.forward(
            params, cfg, batch["tokens"], caches=caches, cache_len=0,
            embeds=batch.get("patches"))
        return logits[:, -1], caches

    @torch.no_grad()
    def decode_step(params, state, tokens, cache_len: int):
        """Logits of the last new token with the padded vocab masked, and
        the caches (updated in place)."""
        logits, state, _ = transformer.forward(
            params, cfg, tokens, caches=state, cache_len=cache_len)
        return mask_padded_vocab(logits[:, -1], cfg.vocab), state

    def input_specs(shape: ShapeCfg):
        d = _token_specs(shape, shape.seq_len - Pn)
        if cfg.family == "vlm" and shape.kind != "decode":
            d["patches"] = _sds((shape.global_batch, Pn, cfg.d_model),
                                cfg.torch_dtype)
        return d

    def state_specs(shape: ShapeCfg):
        return _kv_specs(cfg, cfg.n_layers, shape.global_batch,
                         shape.seq_len)

    return ModelAPI(cfg, lambda gen: transformer.init_params(gen, cfg),
                    loss, prefill, decode_step, input_specs, state_specs)


def _build_ssm(cfg: ArchConfig) -> ModelAPI:
    def loss(params, batch):
        logits, _, aux = ssm.lm_forward(params, cfg, batch["tokens"])
        return xent_loss(logits, batch["targets"], cfg.vocab) + aux, aux

    @torch.no_grad()
    def prefill(params, batch):
        """The chunked forward's last logits (unmasked) and *zeroed*
        states, as the reference returns them: the prompt's states are
        not handed to decode."""
        logits, _, _ = ssm.lm_forward(params, cfg, batch["tokens"])
        return logits[:, -1], ssm.init_lm_states(
            cfg, batch["tokens"].shape[0], device=params.embed.device)

    @torch.no_grad()
    def decode_step(params, state, tokens, cache_len: int):
        logits, state, _ = ssm.lm_forward(params, cfg, tokens, states=state)
        return mask_padded_vocab(logits[:, -1], cfg.vocab), state

    def state_specs(shape: ShapeCfg):
        return _ssm_state_specs(cfg, shape.global_batch)

    return ModelAPI(cfg, lambda gen: ssm.init_lm(gen, cfg), loss, prefill,
                    decode_step, lambda shape: _token_specs(shape,
                                                            shape.seq_len),
                    state_specs)


def _build_hybrid(cfg: ArchConfig) -> ModelAPI:
    def loss(params, batch):
        logits, _, aux = hybrid.forward(params, cfg, batch["tokens"])
        return xent_loss(logits, batch["targets"], cfg.vocab) + aux, aux

    @torch.no_grad()
    def prefill(params, batch):
        """The forward's last logits (unmasked), zeroed states and zeroed
        caches ``S + 8`` long, as the reference returns them (``max_len``
        is ignored)."""
        B, S = batch["tokens"].shape
        logits, _, _ = hybrid.forward(params, cfg, batch["tokens"])
        return logits[:, -1], hybrid.init_decode_state(
            cfg, B, S + 8, device=params.embed.device)

    @torch.no_grad()
    def decode_step(params, state, tokens, cache_len: int):
        states, caches = state
        logits, state, _ = hybrid.forward(params, cfg, tokens, states=states,
                                          caches=caches, cache_len=cache_len)
        return mask_padded_vocab(logits[:, -1], cfg.vocab), state

    def state_specs(shape: ShapeCfg):
        B = shape.global_batch
        return (_ssm_state_specs(cfg, B),
                _kv_specs(cfg, hybrid.n_shared_sites(cfg), B, shape.seq_len))

    return ModelAPI(cfg, lambda gen: hybrid.init_params(gen, cfg), loss,
                    prefill, decode_step,
                    lambda shape: _token_specs(shape, shape.seq_len),
                    state_specs)


def _build_encdec(cfg: ArchConfig) -> ModelAPI:
    def loss(params, batch):
        enc_out = encdec.encode(params, cfg, batch["frames"])
        logits, _, aux = encdec.decode(params, cfg, batch["tokens"], enc_out)
        return xent_loss(logits, batch["targets"], cfg.vocab) + aux, aux

    @torch.no_grad()
    def prefill(params, batch):
        """The encoder's output, caches *exactly S long* (``max_len`` is
        ignored, as in the reference), the prompt decoded at position 0,
        and the last logits unmasked. A ``decode_step`` on that state
        writes past the caches and raises, where the reference clamps the
        write onto position S - 1."""
        B, S = batch["tokens"].shape
        enc_out = encdec.encode(params, cfg, batch["frames"])
        caches = encdec.init_caches(cfg, B, S, device=params.embed.device)
        logits, caches, _ = encdec.decode(params, cfg, batch["tokens"],
                                          enc_out, caches, 0)
        return logits[:, -1], (enc_out, caches)

    @torch.no_grad()
    def decode_step(params, state, tokens, cache_len: int):
        enc_out, caches = state
        logits, caches, _ = encdec.decode(params, cfg, tokens, enc_out,
                                          caches, cache_len)
        return mask_padded_vocab(logits[:, -1], cfg.vocab), (enc_out, caches)

    T = cfg.encdec.enc_len

    def input_specs(shape: ShapeCfg):
        d = _token_specs(shape, shape.seq_len)
        if shape.kind != "decode":
            d["frames"] = _sds((shape.global_batch, T, cfg.d_model),
                               cfg.torch_dtype)
        return d

    def state_specs(shape: ShapeCfg):
        B = shape.global_batch
        return (_sds((B, T, cfg.d_model), cfg.torch_dtype),
                _kv_specs(cfg, cfg.n_layers, B, shape.seq_len))

    return ModelAPI(cfg, lambda gen: encdec.init_params(gen, cfg), loss,
                    prefill, decode_step, input_specs, state_specs)
