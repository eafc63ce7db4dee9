"""Paper cfg. C (Appendix A): VGG16 on CIFAR-10-like data, random
4-regular network."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paper-vgg16",
    family="paper",
    source="paper Appendix A (cfg C); arXiv:1409.1556",
    n_layers=16,
    d_model=512,
    d_ff=4096,
    vocab_size=0,
    notes="image classifier; see repro_torch.models.paper_models.init_vgg16 "
    "(width_mult for CPU validation)",
)


def reduced() -> ArchConfig:
    return CONFIG
