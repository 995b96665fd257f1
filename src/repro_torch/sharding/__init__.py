"""The mesh layer: logical-axis sharding rules and DTensor placements
(``specs``), the context model code runs in on DTensors (``mesh_mode``),
per-rank bodies and their collectives (``collectives``, ``overlap``,
``pipeline``), gradient compression (``compression``), and the devices a
CSNN batch is split over (``specs.batch_devices``)."""
