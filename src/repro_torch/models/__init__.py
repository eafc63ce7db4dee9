"""Models of the port: the paper's MLP and the decoder zoo's attention, mamba and RWKV-6 stack (dense and MoE FFNs)."""
from . import transformer
from .paper_models import accuracy, classifier_loss, init_mlp, mlp_forward

__all__ = ["accuracy", "classifier_loss", "init_mlp", "mlp_forward", "transformer"]
