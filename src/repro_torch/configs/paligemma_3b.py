"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; SigLIP patch embeddings are a STUB prefix supplied by
input_specs().  [arXiv:2407.07726; hf]"""
import dataclasses

from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab=257216,
        unit=(LayerSpec(kind="attn", ffn="dense"),),
        frontend="vision", frontend_dim=1152, frontend_len=256,
        scale_embed=True, tie_embeddings=True, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=512, frontend_dim=32, frontend_len=8)
