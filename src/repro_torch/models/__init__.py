"""The LM model stack of the port (dense and MoE attention archs): the
serving ``Model``, the training ``TrainModel`` and the MoE layer
(``repro_torch.models.moe``)."""
from . import moe
from .transformer import Model, TrainModel, build_model

__all__ = ["Model", "TrainModel", "build_model", "moe"]
