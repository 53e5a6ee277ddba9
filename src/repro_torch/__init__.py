"""PyTorch/CUDA port of the sparse-junction system (see src/repro for the JAX reference)."""
