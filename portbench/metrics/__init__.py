"""Metric readers, one a metric, named after it. ``read`` takes what its
kind gives: an end-to-end metric the run's ``harness.Run``, a per-layer
metric its traced window's ``trace.TraceRecord``. It returns one number,
or, a per-layer reader, None where the window holds nothing to read."""
