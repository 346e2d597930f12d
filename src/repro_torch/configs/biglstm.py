"""BigLSTM — the paper's language-model evaluation [Jozefowicz et al. 2016].

Embedding 1024, 2 LSTM layers hidden 8192 with 1024 projection, softmax."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="biglstm", family="rnn",
    n_layers=2, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=8192,
    vocab_size=793472, source="paper eval model [arXiv:1602.02410]",
)
