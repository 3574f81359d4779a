"""Models and the converter from the JAX package's parameters."""
