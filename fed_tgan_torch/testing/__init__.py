"""Deterministic fault injection for the port's fault-tolerance paths."""
