"""Kimi K2 — trillion-param MoE (paper-table config) [arXiv:2501.kimi2]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, n_experts=384, experts_per_token=8, moe_d_ff=2048,
    n_shared_experts=1,
    source="Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2]",
)
