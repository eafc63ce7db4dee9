"""Hand-written CUDA kernels of the port (``mix/``: DecAvg mixing, ``flash/``:
attention, ``rwkv/``: the RWKV-6 time-mix) and their plain PyTorch versions."""
