"""Static models of the port's programs (the JAX package's `analysis/`)."""
