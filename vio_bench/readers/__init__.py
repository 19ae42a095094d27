"""Per-layer metric readers. A metric's file ``vio_bench/metrics/<name>.json``
names its reader (a module here with ``read(summary, ctx, **args)``) and
the reader's arguments. A reader that finds nothing to read returns None,
and the harness leaves the metric out of the result line."""
