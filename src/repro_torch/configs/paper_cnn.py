"""Paper cfg. B (Appendix A): CNN (32/64/64 ch 3×3) + FC 128/64/17,
So2Sat-like data, BA(m=8) network, Zipf α=1.8."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paper-cnn",
    family="paper",
    source="paper Appendix A (cfg B)",
    n_layers=5,
    d_model=64,
    d_ff=0,
    vocab_size=0,
    notes="image classifier; see repro_torch.models.paper_models.init_cnn",
)


def reduced() -> ArchConfig:
    return CONFIG
