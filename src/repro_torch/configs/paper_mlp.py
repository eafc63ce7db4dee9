"""Paper cfg. A/D (Appendix A, Table A1): MLP 784→512→256→128→10, ReLU,
MNIST-like data, full communication network."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="paper-mlp",
    family="paper",
    source="paper Appendix A (cfg A/D)",
    n_layers=4,
    d_model=512,
    d_ff=0,
    vocab_size=0,
    notes="image classifier; see repro_torch.models.paper_models.init_mlp",
)


def reduced() -> ArchConfig:
    return CONFIG  # already CPU-scale
