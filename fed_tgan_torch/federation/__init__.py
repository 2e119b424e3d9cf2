"""Federated init: harmonization, similarity weights."""
