"""Device sets the port shards work over (``specs.batch_devices``)."""
