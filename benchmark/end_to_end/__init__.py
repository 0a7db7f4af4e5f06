"""End-to-end metric readers, one file a metric, found by its name in
``BENCHMARK.json``: ``read(run)`` returns the number or None. ``setup_s``
is the harness's own (``run.py``)."""
