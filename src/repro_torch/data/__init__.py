"""Synthetic federated data (numpy; FEMNIST-like images so far)."""
