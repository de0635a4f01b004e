"""The contract auditor and its models (the JAX package's `analysis/`)."""
