"""PyTorch/CUDA port of the VELOC reproduction (the JAX package ``repro`` is
the reference).  Imports ``torch`` only: never ``jax``, never ``repro``."""
