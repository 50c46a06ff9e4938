"""Sequence parallelism of the port."""
