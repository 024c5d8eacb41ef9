"""Canned workloads for the port (JAX-free)."""
