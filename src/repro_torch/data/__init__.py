"""Deterministic synthetic data of the port (``synthetic``)."""
