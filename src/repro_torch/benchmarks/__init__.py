"""The paper's figure drivers on the port (counterpart of the repository's
``benchmarks/``): ``common.py`` runs DFL trajectories of the paper's MLP, and
each ``figN_*.py`` reproduces one figure's claim; ``estimates_bench.py``
times the gossip estimation rounds, ``rounds_bench.py`` the round loop and
``kernels_bench.py`` the hand-written kernels and the mixing backends.
Every driver runs as ``python -m repro_torch.benchmarks.<name> [--device
cpu]`` and prints the JAX drivers' ``name,us_per_call,derived`` CSV rows;
``python -m repro_torch.benchmarks.run [names]`` runs several, as the JAX
harness does."""
