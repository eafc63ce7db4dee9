"""Hand-written CUDA kernels of the port (``mix/``: DecAvg mixing, ``flash/``:
attention) and their plain PyTorch versions."""
