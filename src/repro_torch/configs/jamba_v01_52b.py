"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
Mamba:attention 7:1 interleave, MoE 16 experts top-2 on every other layer,
vocab=65536.  [arXiv:2403.19887; hf]"""
import dataclasses

from .base import LayerSpec, MambaConfig, ModelConfig, MoEConfig


def _unit():
    # 8-layer jamba block: attention at index 4, MoE on odd layers
    specs = []
    for i in range(8):
        kind = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(kind=kind, ffn=ffn))
    return tuple(specs)


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536,
        unit=_unit(),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        tie_embeddings=False, subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128))
