"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8), MoE 40
experts top-8, per-expert d_ff=512, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses

from .base import LayerSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155,
        unit=(LayerSpec(kind="attn", ffn="moe"),),
        moe=MoEConfig(n_experts=40, top_k=8, d_ff=512),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=48, n_heads=6, n_kv_heads=2,
        d_ff=64, vocab=512, moe=MoEConfig(n_experts=5, top_k=2, d_ff=64))
