"""Model/run configuration schema shared by all assigned architectures.

A copy of the reference's ``repro/configs/base.py`` (data only, no
framework import).  A model is a stack of repeating *units* (tuples of
LayerSpec), so heterogeneous stacks (jamba's 1:7 attention:mamba
interleave, gemma2's local/global alternation, xlstm's sLSTM/mLSTM mix)
share one description.  In the port, ``attn_impl`` picks among the plain
attention versions on a CPU tensor only (``"pallas"``: the plain version
of the hand-written Hopper kernel); on the card every value runs the
kernel (``repro_torch/csrc/flash_attention.cu``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"           # attn | mamba | slstm | mlstm
    attn_type: str = "global"    # global | local (sliding window)
    ffn: str = "dense"           # dense | moe | none


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0     # block up-projection (replaces d_ff)
    chunk: int = 64              # mLSTM chunkwise-parallel chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # moe | dense | ssm | audio | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    unit: Tuple[LayerSpec, ...] = (LayerSpec(),)
    head_dim: int = 0            # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rotary_fraction: float = 1.0   # glm4 rotates half the head dim
    attn_softcap: float = 0.0      # gemma2: 50.0
    logit_softcap: float = 0.0     # gemma2: 30.0
    sliding_window: int = 4096
    attn_impl: str = "chunked"     # ref | chunked | pallas

    # structure
    enc_dec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"         # none | vision | audio (stub embeddings)
    frontend_dim: int = 0          # width of precomputed stub embeddings
    frontend_len: int = 0          # number of prefix embeddings
    tie_embeddings: bool = True
    scale_embed: bool = False      # gemma: embed * sqrt(d_model)
    act: str = "silu"              # silu | gelu
    norm_eps: float = 1e-6

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_dtype: str = "bfloat16"     # bfloat16 | int8 (quantized KV cache)

    # accounting mode: fully unroll every lax.scan so compiled.cost_analysis
    # counts all iterations (XLA prices a while body exactly once; the
    # dry-run extrapolates unit costs from 1- and 2-unit unrolled builds)
    unroll_scans: bool = False
    attn_chunk: int = 1024         # KV chunk for the online-softmax scan
    decode_chunk: int = 2048       # KV chunk when S_q == 1 (peak-temp knob)
    mamba_chunk: int = 256         # selective-scan chunk length

    # capability flags (see DESIGN.md §Arch-applicability)
    subquadratic: bool = False     # may run long_500k
    has_decoder: bool = True       # encoder-only archs skip decode shapes

    def __post_init__(self):
        if self.n_layers % len(self.unit) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"unit length {len(self.unit)}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding table padded to a multiple of 256 so the vocab dim
        shards on any production mesh axis (granite's 49155 and seamless's
        256206 are otherwise unshardable -> logits replicate -> 67+ GiB of
        temp per device).  Pad logits are masked to -inf in unembed()."""
        return -(-self.vocab // 256) * 256

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.unit)

    @property
    def n_params(self) -> int:
        """Approximate parameter count (embeddings + stacked units)."""
        D, H, KV, hd = (self.d_model, self.n_heads, self.n_kv_heads,
                        self.resolved_head_dim)
        embed = self.vocab * D  # embed
        if not self.tie_embeddings:
            embed += self.vocab * D
        total = 0
        for spec in self.unit:
            if spec.kind == "attn":
                total += D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
            elif spec.kind == "mamba":
                m = self.mamba or MambaConfig()
                d_in = m.expand * D
                dt_rank = m.dt_rank or -(-D // 16)
                total += (D * 2 * d_in + d_in * m.d_conv
                          + d_in * (dt_rank + 2 * m.d_state)
                          + dt_rank * d_in + d_in * m.d_state + d_in
                          + d_in * D)
            elif spec.kind in ("slstm", "mlstm"):
                x = self.xlstm or XLSTMConfig()
                d_in = int(x.proj_factor * D)
                total += 2 * D * d_in + 4 * d_in * d_in + d_in * D
            if spec.ffn == "dense":
                total += 3 * D * self.d_ff
            elif spec.ffn == "moe":
                assert self.moe is not None
                total += D * self.moe.n_experts  # router
                total += self.moe.n_experts * 3 * D * self.moe.d_ff
        total = total * self.n_units + embed
        if self.enc_dec:
            # encoder layers (self-attn + dense ffn) + decoder cross-attn
            enc = self.n_enc_layers * (4 * D * (H * hd) + 3 * D * self.d_ff)
            cross = self.n_layers * 4 * D * (H * hd)
            total += enc + cross
        return total

    @property
    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.n_params
        moe_layers = sum(1 for s in self.unit if s.ffn == "moe") * self.n_units
        unused = (self.moe.n_experts - self.moe.top_k) * 3 * \
            self.d_model * self.moe.d_ff
        return self.n_params - moe_layers * unused


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark cell: (arch x input shape)."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                    # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig):
    """The shape cells an architecture actually runs (skips documented
    in DESIGN.md §Arch-applicability)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"]]
    if cfg.has_decoder:
        out.append(SHAPES["decode_32k"])
        if cfg.subquadratic:
            out.append(SHAPES["long_500k"])
    return out
