"""Measurement scripts for the port, run as ``python -m`` modules."""
