"""Whisper large-v3 — enc-dec, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, mlp_kind="gelu",
    encoder_layers=32, encoder_seq=1500, frontend="audio-conv-stub",
    source="enc-dec, conv frontend (stub) [arXiv:2212.04356]",
)
