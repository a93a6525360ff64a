"""Per-architecture configs of the port (data, as in ``repro/configs``)."""
