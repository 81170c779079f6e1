"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8, head_dim=256)
d_ff=14336 vocab=256000; alternating local/global attention, logit
softcaps.  [arXiv:2408.00118; hf]"""
import dataclasses

from .base import LayerSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=14336, vocab=256000,
        unit=(LayerSpec(kind="attn", attn_type="local", ffn="dense"),
              LayerSpec(kind="attn", attn_type="global", ffn="dense")),
        attn_softcap=50.0, logit_softcap=30.0, sliding_window=4096,
        scale_embed=True, tie_embeddings=True, act="gelu",
    )


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        config(), n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab=512, sliding_window=8)
