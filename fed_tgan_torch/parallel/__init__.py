"""Aggregation over the stacked client axis."""
