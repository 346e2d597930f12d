"""Config system: architecture configs, input shapes, and the registry.

A field-for-field copy of the JAX package's ``repro/configs/base.py`` (the
port imports nothing of ``repro``); ``tests/test_torch_configs.py`` holds the
two equal.  Every assigned architecture gets one ``configs/<id>.py`` exporting
``CONFIG``; the registry maps ``--arch <id>`` to it.  ``reduced()`` yields the
CPU smoke-test variant (2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# The model axis of the production mesh; dims not divisible by this are
# replicated (see parallel/sharding.py) and vocabs are padded to a multiple of
# VOCAB_PAD_TO so the output projection always shards.
MODEL_AXIS_SIZE = 16
VOCAB_PAD_TO = 256


def pad_vocab(v: int, multiple: int = VOCAB_PAD_TO) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  One instance per assigned arch."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | cnn | rnn
    n_layers: int
    d_model: int
    n_heads: int                     # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                 # citation: paper/model-card

    # --- attention ---
    head_dim: int = 0                # derived if 0
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 => full attention (arch as published)
    long_context_window: int = 8192  # window used for the long_500k variant
    attn_logit_softcap: float = 0.0

    # --- MLP ---
    mlp_kind: str = "swiglu"         # swiglu | gelu | sqrelu
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                # per-expert hidden size (d_ff used if 0)
    n_shared_experts: int = 0
    router_aux_loss: float = 0.01

    # --- SSM / hybrid (mamba-style) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- RWKV ---
    rwkv: bool = False

    # --- encoder-decoder / multimodal stub frontend ---
    encoder_layers: int = 0          # >0 => enc-dec (whisper)
    encoder_seq: int = 0             # frames/patches produced by the stub frontend
    frontend: str = ""               # "audio-conv-stub" | "vit-patch-stub" | ""
    n_prefix_embeds: int = 0         # VLM: patch embeds prepended to the text sequence

    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def n_params(self) -> int:
        """Approximate parameter count (used by the analytical model)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        if self.rwkv:
            per_layer = 4 * d * d + 3 * d * self.d_ff  # time-mix + channel-mix
        else:
            hd = self.head_dim
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
            if self.is_moe:
                mlp_mult = 3 if self.mlp_kind == "swiglu" else 2
                mlp = self.n_experts * mlp_mult * d * self.expert_d_ff
                mlp += d * self.n_experts  # router
                mlp += self.n_shared_experts * mlp_mult * d * self.expert_d_ff
            else:
                mlp_mult = 3 if self.mlp_kind == "swiglu" else 2
                mlp = mlp_mult * d * self.d_ff
            ssm = 0
            if self.ssm_state:
                di = self.ssm_expand * d
                ssm = 2 * d * di + di * self.ssm_conv + di * (2 * self.ssm_state + 1) + di * d
            per_layer = (attn if self.n_heads else 0) + mlp + ssm
        enc = 0
        if self.encoder_layers:
            hd = self.head_dim
            enc_attn = 4 * d * d
            enc_mlp = 2 * d * self.d_ff
            enc = self.encoder_layers * (enc_attn + enc_mlp)
            per_layer += 2 * d * d + 2 * d * (self.n_kv_heads * hd)  # cross-attn
        return emb + L * per_layer + enc

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.n_params()
        full = self.n_params()
        mlp_mult = 3 if self.mlp_kind == "swiglu" else 2
        all_exp = self.n_layers * self.n_experts * mlp_mult * self.d_model * self.expert_d_ff
        act_exp = self.n_layers * self.experts_per_token * mlp_mult * self.d_model * self.expert_d_ff
        return full - all_exp + act_exp

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family."""
        d = min(self.d_model, 256)
        heads = 0
        kv = 0
        if self.n_heads:
            heads = min(self.n_heads, 4)
            kv = max(1, min(self.n_kv_heads, heads))
            while heads % kv:
                kv -= 1
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=(d // heads if heads else 0),
            d_ff=min(self.d_ff, 512),
            moe_d_ff=min(self.expert_d_ff, 256) if self.is_moe else 0,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.is_moe else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.is_moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            encoder_layers=min(self.encoder_layers, 2) if self.encoder_layers else 0,
            encoder_seq=min(self.encoder_seq, 16) if self.encoder_seq else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 8) if self.n_prefix_embeds else 0,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the assigned (seq_len, global_batch, kind) points."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "internvl2_2b",
    "granite_moe_1b_a400m",
    "kimi_k2_1t_a32b",
    "stablelm_12b",
    "smollm_360m",
    "llama3_2_1b",
    "hymba_1_5b",
    "rwkv6_7b",
    "nemotron_4_340b",
    "whisper_large_v3",
]
PAPER_IDS = ["inception_v3", "gnmt", "biglstm"]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS + PAPER_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + PAPER_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
