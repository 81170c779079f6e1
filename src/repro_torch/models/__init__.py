"""The LM model stack of the port (dense attention archs): the serving
``Model`` and the training ``TrainModel``."""
from .transformer import Model, TrainModel, build_model

__all__ = ["Model", "TrainModel", "build_model"]
