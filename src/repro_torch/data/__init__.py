"""Data generators of the port (numpy; no JAX)."""
