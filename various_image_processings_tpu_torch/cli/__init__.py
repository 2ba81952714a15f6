"""Command-line samples (argv-compatible with the JAX package's)."""
