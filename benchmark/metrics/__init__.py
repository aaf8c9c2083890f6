"""Per-metric readers: one file a metric, found by the metric's name."""
