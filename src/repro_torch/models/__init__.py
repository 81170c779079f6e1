"""The LM model stack of the port (dense, MoE, xLSTM and hybrid Mamba
archs): the serving ``Model``, the training ``TrainModel``, the MoE layer
(``repro_torch.models.moe``), the xLSTM blocks
(``repro_torch.models.xlstm``) and the Mamba block
(``repro_torch.models.ssm``)."""
from . import moe, ssm, xlstm
from .transformer import Model, TrainModel, build_model

__all__ = ["Model", "TrainModel", "build_model", "moe", "ssm", "xlstm"]
