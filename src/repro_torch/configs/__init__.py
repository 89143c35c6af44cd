"""Model configurations of the LM substrate (a copy of the JAX package's)."""
