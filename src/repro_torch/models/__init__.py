"""The LM architectures of the port (counterpart of ``repro.models``):
parameter specs, the building blocks, the decoder and encoder-decoder
assemblies with their caches, and the registry's ``Model``."""
