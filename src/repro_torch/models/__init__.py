"""Client models in PyTorch, with the JAX package's parameter names
and layouts."""
