"""Artifact format of the port."""
