"""Metrics of the serving path (``metrics.MetricsRegistry``) and the
resident loop's telemetry-row layout (``recorder``)."""
