"""Model API (port of the transformer and BigLSTM branches of
``repro/models/api.py``).

``build_model(cfg, device=, capacity_factor=1.25)`` returns a ``ModelApi``
whose members are plain functions over the parameter dict; the serving
engine and the train step consume models only through it.  The dense, MoE
and RWKV decoders go through ``models/transformer.py`` (RWKV's cache holds
its recurrent state); BigLSTM has a loss and no serving path (as in JAX);
GNMT and the cnn family raise NotImplementedError.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA where
there is none raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lstm as lstm_mod
from repro_torch.models import transformer as tf_mod


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and no card is
    visible (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() "
                           f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def masked_nll_sum(logits, labels):
    """Summed token NLL in f32 (labels < 0 masked)."""
    logits = logits.float()
    mask = labels >= 0
    labels = labels.clamp(min=0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def cross_entropy(logits, labels, n_valid_vocab: int):
    """Mean token NLL in f32; labels < 0 are masked out."""
    mask = labels >= 0
    return masked_nll_sum(logits, labels) / mask.sum().clamp(min=1)


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    device: torch.device
    init: Callable                    # seed -> params
    loss_fn: Callable                 # (params, batch, pctx) -> (loss, metrics)
    prefill: Optional[Callable]       # (params, batch, pctx, capacity, window) -> (logits, cache)
    decode_fn: Optional[Callable]     # (params, cache, batch, pctx, window) -> (logits, cache)


def build_model(cfg: ModelConfig, *, device="cuda", capacity_factor=1.25) -> ModelApi:
    """``capacity_factor`` bounds the tokens per expert of an MoE model in
    train and prefill (None: no drop); decode never drops."""
    dev = resolve_device(device)
    if cfg.family == "rnn":
        return _build_lstm(cfg, dev)
    tf_mod.check_supported(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tf_mod.model_init(gen, cfg, device=dev)

    def loss_fn(params, batch, pctx=None):
        fwd_batch = {k: v for k, v in batch.items() if k != "labels"}
        logits, aux = tf_mod.forward(cfg, params, fwd_batch, mode="train", pctx=pctx,
                                     capacity_factor=capacity_factor)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        # aux: the blocks' router_aux_loss-weighted load-balance losses
        return loss + aux, {"loss": loss, "aux": aux}

    def prefill(params, batch, pctx=None, capacity: int = 0, window=None):
        fwd_batch = {k: v for k, v in batch.items() if k != "labels"}
        logits, cache, _ = tf_mod.forward(cfg, params, fwd_batch, mode="prefill",
                                          window_override=window, pctx=pctx,
                                          cache_capacity=capacity,
                                          capacity_factor=capacity_factor)
        return logits, cache

    def decode_fn(params, cache, batch, pctx=None, window=None):
        return tf_mod.decode_step(cfg, params, cache, batch,
                                  window_override=window, pctx=pctx)

    return ModelApi(cfg, dev, init, loss_fn, prefill, decode_fn)


def _build_lstm(cfg: ModelConfig, dev: torch.device) -> ModelApi:
    lstm_mod.check_supported(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return lstm_mod.biglstm_init(gen, cfg, device=dev)

    def loss_fn(params, batch, pctx=None):
        logits = lstm_mod.biglstm_forward(cfg, params, batch, pctx=pctx)
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        return loss, {"loss": loss}

    return ModelApi(cfg, dev, init, loss_fn, None, None)


def supports_pipeline(cfg: ModelConfig) -> bool:
    """Archs whose layer stack a pipeline runtime can partition: BigLSTM's
    residual LSTM stack and homogeneous decoder-only transformers.  GNMT's
    encoder/decoder split and the CNN block graph need stage functions the
    runtime does not model (the planner still *costs* pipeline-MP for GNMT;
    the launcher then takes the best supported plan).  The runtime is
    ROADMAP.md Queue 1 item 6."""
    if cfg.name == "biglstm":
        return True
    if cfg.family == "cnn" or cfg.name == "gnmt":
        return False
    return not (cfg.encoder_layers or cfg.n_prefix_embeds or cfg.is_moe)
