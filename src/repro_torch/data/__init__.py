"""The port's data pipeline: the deterministic synthetic token stream."""
from .synthetic import DataConfig, SyntheticStream

__all__ = ["DataConfig", "SyntheticStream"]
