"""Inception-V3 — the paper's CNN evaluation model [Szegedy et al. 2015]."""
from repro_torch.configs.base import ModelConfig

# CNN family: d_model/d_ff unused by the transformer stack; the Inception model
# definition (models/inception.py) reads its own block table.  vocab_size is the
# number of ImageNet classes.
CONFIG = ModelConfig(
    name="inception-v3", family="cnn",
    n_layers=11, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=1000, source="paper eval model [arXiv:1512.00567]",
)
