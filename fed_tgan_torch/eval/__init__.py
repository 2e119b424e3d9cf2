"""Quality metrics of synthetic tables."""
