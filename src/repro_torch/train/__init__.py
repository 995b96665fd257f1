"""Training pieces of the port: ``optimizer`` (AdamW on parameter trees,
for ``core.conversion.fit_ann`` and the LMs) and ``loop`` (the LM
training step and the fault-tolerant loop)."""
