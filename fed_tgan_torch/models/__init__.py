"""CTGAN networks."""
