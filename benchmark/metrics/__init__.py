"""Metric readers, one file a metric, found by the metric's name: each
defines ``read(ctx) -> float | None`` (harness.Context), and returns None
where its cell gives it nothing to read."""
