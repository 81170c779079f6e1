"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, per-expert d_ff=768.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
import dataclasses

from .base import LayerSpec, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab=151936,
        unit=(LayerSpec(kind="attn", ffn="moe"),),
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
        rope_theta=1e6, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=96, vocab=512, moe=MoEConfig(n_experts=8, top_k=2, d_ff=96))
