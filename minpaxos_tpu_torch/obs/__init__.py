"""Metrics of the serving path (``metrics.MetricsRegistry``)."""
