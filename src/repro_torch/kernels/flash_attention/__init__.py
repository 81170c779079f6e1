"""Forward flash attention: the Hopper kernel, its plain PyTorch version
and the device-dispatching public ops."""
from . import ops, ref
from .kernel import flash_attention_cuda
from .ops import flash_attention, flash_attention_flat, flash_attention_lse

__all__ = ["flash_attention", "flash_attention_cuda", "flash_attention_flat",
           "flash_attention_lse",
           "ops", "ref"]
