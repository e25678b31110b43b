"""Synthetic data streams of the port (numpy batches)."""
