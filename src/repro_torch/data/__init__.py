"""Synthetic federated voice corpus."""
