"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and behind a wrapper (``ops.py``) that counts its
launches. See ``runtime`` for how they are built and dispatched."""
