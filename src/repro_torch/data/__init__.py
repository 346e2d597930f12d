"""Data pipeline: deterministic synthetic datasets + a device feed."""
from repro_torch.data.pipeline import DataPipeline, to_device
from repro_torch.data.synthetic import (
    MarkovLM,
    SyntheticImageDataset,
    SyntheticSeq2Seq,
    make_lm_dataset,
)

__all__ = ["MarkovLM", "SyntheticImageDataset", "SyntheticSeq2Seq",
           "make_lm_dataset", "DataPipeline", "to_device"]
