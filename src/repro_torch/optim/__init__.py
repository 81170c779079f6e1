"""AdamW for the port's training path (plain functions on dicts of
tensors)."""
from . import adamw
from .adamw import AdamWConfig

__all__ = ["adamw", "AdamWConfig"]
