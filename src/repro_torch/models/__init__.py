"""The LM model stack of the port (dense attention archs, forward only)."""
from .transformer import Model, build_model

__all__ = ["Model", "build_model"]
