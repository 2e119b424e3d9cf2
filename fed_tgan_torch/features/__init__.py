"""Decode side of the mode-specific normalization."""
