"""seamless-m4t-medium [audio]: encoder-decoder, 12L each, d_model=1024
16H d_ff=4096 vocab=256206.  The speech frontend is a STUB: input_specs()
provides precomputed frame embeddings.  [arXiv:2308.11596; hf]"""
import dataclasses

from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=256206,
        unit=(LayerSpec(kind="attn", ffn="dense"),),
        enc_dec=True, n_enc_layers=12,
        frontend="audio", frontend_dim=1024, frontend_len=1024,
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=512, frontend_dim=32, frontend_len=16)
