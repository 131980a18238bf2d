"""Routing-variant registry: typed specs resolved to route functions.

A routing variant is registered once with a ``build(spec)`` factory
returning the concrete route function ``fn(u_hat, n_iters) -> (v, c)``.
Callers hold a :class:`RoutingSpec` — a small frozen dataclass carried by
``CapsNetConfig.routing`` — and resolve it to a callable via
:func:`resolve`.

Three variants: ``reference``, ``optimized`` and ``cuda``.  Variant
``cuda`` always resolves to the wrapper of the hand-written kernel: there
is no availability probe and no fallback variant.  Which code that wrapper
runs is decided by the device of the tensor it is given (the plain version
for a CPU tensor, the kernel for a CUDA tensor, an error otherwise).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Tuple

import torch

RouteFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

_SOFTMAX_MODES = ("exact", "taylor")


@dataclasses.dataclass(frozen=True)
class RoutingSpec:
    """Typed description of a dynamic-routing configuration."""

    mode: str = "reference"           # registered variant name
    softmax: str = "exact"            # exact | taylor (paper Eq. 2)
    div_exp_log: bool = False         # paper Eq. 3 (optimized variant only)

    def __post_init__(self):
        if self.softmax not in _SOFTMAX_MODES:
            raise ValueError(
                f"softmax must be one of {_SOFTMAX_MODES}, got "
                f"{self.softmax!r}")

    # -- canonical constructors --------------------------------------------

    @classmethod
    def reference(cls) -> "RoutingSpec":
        return cls(mode="reference")

    @classmethod
    def optimized(cls, softmax: str = "taylor",
                  div_exp_log: bool = False) -> "RoutingSpec":
        return cls(mode="optimized", softmax=softmax,
                   div_exp_log=div_exp_log)

    @classmethod
    def cuda(cls, softmax: str = "taylor") -> "RoutingSpec":
        return cls(mode="cuda", softmax=softmax)

    @classmethod
    def named(cls, name: str) -> "RoutingSpec":
        """The deployment-default spec for a variant name (paper §III-B:
        the optimized/cuda paths ship with the Taylor softmax)."""
        table = {"reference": cls.reference(),
                 "optimized": cls.optimized(),
                 "cuda": cls.cuda()}
        if name not in table:
            raise ValueError(
                f"unknown routing variant {name!r}; known: "
                f"{sorted(table)}")
        return table[name]


@dataclasses.dataclass(frozen=True)
class RoutingVariant:
    """One registered routing implementation."""

    name: str
    build: Callable[[RoutingSpec], RouteFn]


class RoutingRegistry:
    def __init__(self):
        self._variants: Dict[str, RoutingVariant] = {}

    def register(self, variant: RoutingVariant) -> RoutingVariant:
        self._variants[variant.name] = variant
        return variant

    def names(self):
        return sorted(self._variants)

    def get(self, name: str) -> RoutingVariant:
        try:
            return self._variants[name]
        except KeyError:
            raise ValueError(
                f"unknown routing mode {name!r}; registered: "
                f"{self.names()}") from None

    def normalize(self, spec: RoutingSpec) -> RoutingSpec:
        """Check that the spec names a registered variant and return it.
        Nothing is rewritten: a spec never changes variant behind the
        caller's back."""
        self.get(spec.mode)
        return spec

    def resolve(self, spec: RoutingSpec) -> RouteFn:
        """Spec -> concrete ``fn(u_hat, n_iters) -> (v, c)``."""
        spec = self.normalize(spec)
        return self.get(spec.mode).build(spec)


# ---------------------------------------------------------------------------
# Default registry: the three paper variants
# ---------------------------------------------------------------------------

registry = RoutingRegistry()


def _build_reference(spec: RoutingSpec) -> RouteFn:
    from repro_torch.core import routing

    return routing.route_reference


def _build_optimized(spec: RoutingSpec) -> RouteFn:
    from repro_torch.core import routing

    return functools.partial(
        routing.route_optimized, softmax_mode=spec.softmax,
        use_div_exp_log=spec.div_exp_log)


def _build_cuda(spec: RoutingSpec) -> RouteFn:
    from repro_torch.core import routing

    return functools.partial(routing.route_cuda, softmax_mode=spec.softmax)


registry.register(RoutingVariant("reference", _build_reference))
registry.register(RoutingVariant("optimized", _build_optimized))
registry.register(RoutingVariant("cuda", _build_cuda))


def resolve(spec: RoutingSpec) -> RouteFn:
    return registry.resolve(spec)


def normalize(spec: RoutingSpec) -> RoutingSpec:
    return registry.normalize(spec)
