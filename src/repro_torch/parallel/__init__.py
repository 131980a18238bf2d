"""Logical-axis sharding policy of the port
(``repro_torch.parallel.sharding``)."""

from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES, AxisRules, P, Sharding, logical_to_spec, rules_for_arch,
    spec_tree_to_shardings)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "P",
    "Sharding",
    "logical_to_spec",
    "spec_tree_to_shardings",
    "rules_for_arch",
]
