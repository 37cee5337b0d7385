"""Observability: the metric names the package renders."""
