"""Models of the port (the paper's MLP so far)."""
from .paper_models import accuracy, classifier_loss, init_mlp, mlp_forward

__all__ = ["accuracy", "classifier_loss", "init_mlp", "mlp_forward"]
