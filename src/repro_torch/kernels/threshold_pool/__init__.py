"""Threshold unit: ``kernel`` (CUDA wrapper), ``ref`` (plain version),
``ops`` (public wrapper)."""
