"""Sampling-side pieces of the training package."""
