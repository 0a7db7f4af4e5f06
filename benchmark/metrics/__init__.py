"""Per-layer metric readers, one file a metric, each with ``read(run)``."""
