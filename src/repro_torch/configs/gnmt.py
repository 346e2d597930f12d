"""GNMT — the paper's seq2seq evaluation model [Wu et al. 2016].

4 LSTM layers of size 1024 in encoder and decoder, attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gnmt", family="rnn",
    n_layers=4, d_model=1024, n_heads=1, n_kv_heads=1, d_ff=1024,
    vocab_size=32000, encoder_layers=4,
    source="paper eval model [arXiv:1609.08144], NVIDIA GNMTv2 impl",
)
