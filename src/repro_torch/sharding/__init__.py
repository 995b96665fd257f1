"""Device sets the port shards work over (``specs.batch_devices``) and
the local half of gradient compression (``compression``)."""
