"""Datasets of the port: the procedural digit / fashion sets (numpy)."""

from repro_torch.data import synthetic_digits  # noqa: F401
