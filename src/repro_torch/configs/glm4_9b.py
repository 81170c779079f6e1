"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552; RoPE over half the head dim.  [hf:THUDM/glm-4-9b; hf]"""
import dataclasses

from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552,
        unit=(LayerSpec(kind="attn", ffn="dense"),),
        rotary_fraction=0.5, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512)
