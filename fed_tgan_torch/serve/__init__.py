"""Serving: artifact registry, sampling engine, HTTP service."""
