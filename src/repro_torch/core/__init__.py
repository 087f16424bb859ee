"""Quantizer, k-means, gradient correction and the FedLite train step."""
