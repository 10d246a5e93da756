"""JAX-free signal-processing configuration."""
