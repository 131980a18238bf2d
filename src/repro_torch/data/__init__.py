"""Datasets of the port (numpy): the procedural digit / fashion sets and
the synthetic token stream."""

from repro_torch.data import synthetic_digits, tokens  # noqa: F401
