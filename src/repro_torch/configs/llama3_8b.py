"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  [arXiv:2407.21783; unverified]"""
import dataclasses

from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256,
        unit=(LayerSpec(kind="attn", ffn="dense"),),
        rope_theta=500_000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab=512)
