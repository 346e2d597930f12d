"""InternVL2-2B language backbone (InternViT frontend stubbed) [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
    vocab_size=92553, source="InternVL2 — InternViT + InternLM2 [arXiv:2404.16821]",
    frontend="vit-patch-stub", n_prefix_embeds=256,
)
