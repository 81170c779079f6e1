"""xlstm-125m [ssm]: 12L d_model=768 4H, sLSTM + mLSTM blocks, d_ff=0
(capacity in block up-projections), vocab=50304.
[arXiv:2405.04517; unverified]"""
import dataclasses

from .base import LayerSpec, ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        unit=(LayerSpec(kind="mlstm", ffn="none"),
              LayerSpec(kind="slstm", ffn="none")),
        xlstm=XLSTMConfig(proj_factor=2.0, chunk=64),
        tie_embeddings=True, subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, vocab=512)
