"""Training pieces of the port (``optimizer``: the AdamW that
``core.conversion.fit_ann`` trains with)."""
