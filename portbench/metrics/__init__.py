"""One reader per per-layer metric, found by the metric's name: each
module's ``read(record)`` returns the metric's value from the run's spans,
counters and trace, or None when it finds nothing to read."""
