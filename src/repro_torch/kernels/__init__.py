"""Hand-written Hopper kernels (``csrc/``), their wrappers and plain torch
versions."""
