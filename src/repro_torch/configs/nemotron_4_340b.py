"""Nemotron-4 340B — GQA, squared-ReLU [arXiv:2402.16819]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab_size=256000, mlp_kind="sqrelu",
    source="GQA, squared-ReLU [arXiv:2402.16819]",
)
