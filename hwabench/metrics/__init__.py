"""Per-layer metric readers: ``<metric name>.py`` with ``read(ctx)``,
which returns the reading or None where the run gave it nothing to
read."""
