"""Unified kernel registry: typed specs + config-resolving dispatch.

One :class:`KernelSpec` per hand-written CUDA kernel declares:

  * ``build()`` — the kernel's Python wrapper (lazy import, so importing
    ``repro_torch.kernels`` touches neither ``nvcc`` nor the card);
  * ``reference()`` — the plain PyTorch version with the same semantics;
  * ``space`` — the design space for this kernel: the tunable launch
    geometry (measured by :mod:`repro_torch.kernels.tuning`) plus the
    numerics-changing knobs (``softmax_mode``) that the parity harness
    sweeps but the timing tuner never flips;
  * ``legalize`` — shape-aware config legalization;
  * ``example_cases`` / ``make_example`` — canonical inputs shared by
    the parity tests and the on-card check.

Dispatch (:meth:`KernelRegistry.call`) resolves, in order: explicit
per-call overrides > tuned config from the on-disk cache (when the
:func:`repro_torch.kernels.tuning.tuning` scope or ``tune=`` asks for it
and the arguments lie on the card) > the deterministic legalized
defaults (the ``tune=False`` CI path), and then calls the wrapper.  The
registry never chooses between kernel and plain version: the wrapper
does, by the device of the tensor it is given — the plain version for a
CPU tensor, the kernel for a CUDA tensor, an error otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from repro_torch.kernels import tuning
from repro_torch.kernels.tuning import largest_divisor


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: wrapper, plain version, tunable design space.

    ``space`` maps every design-space knob to its candidate values;
    ``tuned`` names the subset the measured autotuner may vary (launch
    geometry — numerics-preserving by construction).  ``base_config``
    holds the defaults; ``legalize(config, *args, **kw)`` clamps a
    candidate to what the kernel and the concrete shapes allow.  The
    ``example_cases`` dicts drive the registry-wide parity harness:
    ``make_example(case, device) -> (args, kwargs)``.
    """

    name: str
    build: Callable[[], Callable[..., Any]]
    reference: Callable[[], Callable[..., Any]]
    space: Mapping[str, tuple]
    tuned: Tuple[str, ...]
    base_config: Mapping[str, Any]
    legalize: Callable[..., Dict[str, Any]]
    make_example: Callable[..., Tuple[tuple, dict]]
    example_cases: Tuple[Mapping[str, Any], ...] = ()
    ref_accepts: Tuple[str, ...] = ()     # semantic kwargs the oracle takes

    def ref_call(self, *args, **kwargs):
        """Invoke the plain version, filtering kwargs it does not accept."""
        fn = self.reference()
        return fn(*args, **{k: v for k, v in kwargs.items()
                            if k in self.ref_accepts})


class KernelRegistry:
    """Name -> :class:`KernelSpec`; resolution + dispatch."""

    def __init__(self):
        self._specs: Dict[str, KernelSpec] = {}

    def register(self, spec: KernelSpec) -> KernelSpec:
        self._specs[spec.name] = spec
        return spec

    def names(self):
        return sorted(self._specs)

    def get(self, name: str) -> KernelSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise ValueError(f"unknown kernel {name!r}; registered: "
                             f"{self.names()}") from None

    # -- config resolution -------------------------------------------------

    def default_config(self, name: str, *args, **kwargs) -> Dict[str, Any]:
        """The deterministic ``tune=False`` config for these shapes."""
        spec = self.get(name)
        return spec.legalize(dict(spec.base_config), *args, **kwargs)

    def resolve_config(self, name: str, *args,
                       overrides: Optional[Dict[str, Any]] = None,
                       tune: Optional[bool] = None, **kwargs
                       ) -> Dict[str, Any]:
        """Overrides > tuned cache entry (if tuning) > legalized defaults.

        With tuning on and a cache miss, arguments on the card trigger a
        measured :func:`repro_torch.kernels.tuning.autotune` on the spot;
        CPU tensors never do (their wrapper runs the plain version).
        """
        spec = self.get(name)
        config = spec.legalize(dict(spec.base_config), *args, **kwargs)
        use_tune = tune if tune is not None else tuning.tune_enabled()
        if use_tune and tuning.backend_of(args) == "cuda":
            cache = tuning.default_cache()
            cached = cache.get(tuning.cache_key_for(spec, args))
            if cached is None:
                cached, _ = tuning.autotune(spec, args, kwargs, cache=cache)
            merged = dict(spec.base_config)
            merged.update(cached)
            config = spec.legalize(merged, *args, **kwargs)
        if overrides:
            config.update({k: v for k, v in overrides.items()
                           if v is not None})
            config = spec.legalize(config, *args, **kwargs)
        return config

    # -- dispatch ----------------------------------------------------------

    def call(self, name: str, *args,
             config: Optional[Dict[str, Any]] = None,
             tune: Optional[bool] = None, **kwargs) -> Any:
        """Dispatch ``name`` on ``args`` through the kernel's wrapper with
        the resolved config.  ``kwargs`` are semantic (``n_iters``,
        ``softmax_mode``); tunable overrides ride in ``config``."""
        spec = self.get(name)
        resolved = self.resolve_config(name, *args, overrides=config,
                                       tune=tune, **kwargs)
        return spec.build()(*args, **kwargs, **resolved)


def _legalize_blocks(dims_fn: Callable[..., Dict[str, int]],
                     divisors: Tuple[Tuple[str, str], ...] = ()
                     ) -> Callable[..., Dict[str, Any]]:
    """Build a spec ``legalize`` from a mapping of block-size knobs to the
    dimensions they tile (``dims_fn(*args) -> {knob: dim}``): every such
    knob becomes ``largest_divisor(dim, requested)``.  For kernels that tile
    an axis (the attention kernels to come); a CUDA kernel's thread count
    divides nothing and is legalized by :func:`_legalize_threads` instead.

    ``divisors`` pairs are enforced
    after the divisor pass: for each ``(a, b)``, ``config[a]`` is first
    clamped to divide ``b``'s dimension, then ``config[b]`` is walked
    down in ``config[a]``-sized steps until it both divides the
    dimension and is a multiple of ``config[a]``.  The procedure is
    idempotent."""

    def legalize(config: Dict[str, Any], *args, **kwargs) -> Dict[str, Any]:
        dims = dims_fn(*args, **kwargs)
        for key, dim in dims.items():
            config[key] = largest_divisor(dim, config[key])
        for a, b in divisors:
            dim = dims.get(b)
            va = int(config[a])
            if dim is not None:
                va = largest_divisor(dim, va)
                config[a] = va
            vb = max(int(config[b]), va)
            vb = vb // va * va
            if dim is not None:
                while vb > va and dim % vb:
                    vb -= va
            config[b] = vb
        return config

    return legalize


WARP = 32
MAX_THREADS = 1024


def _legalize_threads(config: Dict[str, Any], *args, **kwargs
                      ) -> Dict[str, Any]:
    """A CUDA block is whole warps, at most 1024 threads: round the
    request down to a multiple of 32 inside [32, 1024].  Idempotent."""
    t = int(config["threads"])
    config["threads"] = max(WARP, min(MAX_THREADS, t // WARP * WARP))
    return config


# ---------------------------------------------------------------------------
# Registered kernels
# ---------------------------------------------------------------------------

registry = KernelRegistry()


def _rand(seed: int, shape, dtype="float32", scale: float = 1.0,
          device="cpu"):
    """Seeded example input, made with numpy so that it does not depend on
    the device or on the PyTorch version."""
    import numpy as np
    import torch

    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x * np.float32(scale))
            .to(getattr(torch, dtype)).to(device))


# -- fused_routing ----------------------------------------------------------


def _build_fused_routing():
    from repro_torch.kernels.routing.routing_kernel import fused_routing_cuda

    return fused_routing_cuda


def _routing_reference():
    from repro_torch.kernels.routing.ref import fused_routing_ref

    return fused_routing_ref


def _routing_example(case, device="cpu"):
    shape = case.get("shape", (4, 24, 10, 16))
    u = _rand(case.get("seed", 0), shape, case.get("dtype", "float32"),
              scale=0.2, device=device)
    return (u,), {"n_iters": case.get("n_iters", 3),
                  "softmax_mode": case.get("softmax_mode", "exact")}


registry.register(KernelSpec(
    name="fused_routing",
    build=_build_fused_routing,
    reference=_routing_reference,
    space={"threads": (128, 256, 512, 1024),
           "softmax_mode": ("exact", "taylor")},
    tuned=("threads",),
    base_config={"threads": 1024},
    legalize=_legalize_threads,
    make_example=_routing_example,
    example_cases=(
        {"shape": (4, 24, 10, 16), "softmax_mode": "exact", "atol": 1e-5},
        {"shape": (9, 30, 10, 16), "softmax_mode": "exact", "atol": 1e-5},
        {"shape": (6, 36, 5, 8), "softmax_mode": "taylor", "atol": 1e-4},
        {"shape": (3, 252, 10, 16), "softmax_mode": "taylor", "atol": 1e-4},
    ),
    ref_accepts=("n_iters", "softmax_mode"),
))


# -- taylor_softmax ---------------------------------------------------------


def _build_taylor_softmax():
    from repro_torch.kernels.softmax.kernel import taylor_softmax_cuda

    return taylor_softmax_cuda


def _softmax_reference():
    from repro_torch.kernels.softmax.ref import taylor_softmax_ref

    return taylor_softmax_ref


def _softmax_example(case, device="cpu"):
    shape = case.get("shape", (8, 16))
    x = _rand(case.get("seed", 0), shape, case.get("dtype", "float32"),
              scale=case.get("scale", 5.0), device=device)
    return (x,), {}


registry.register(KernelSpec(
    name="taylor_softmax",
    build=_build_taylor_softmax,
    reference=_softmax_reference,
    space={"threads": (128, 256, 512, 1024)},
    tuned=("threads",),
    base_config={"threads": 256},
    legalize=_legalize_threads,
    make_example=_softmax_example,
    example_cases=(
        {"shape": (8, 16), "atol": 1e-6},
        {"shape": (33, 250), "atol": 1e-6},          # odd/ragged rows
        {"shape": (4, 7, 64), "atol": 1e-6},
        {"shape": (1, 1024), "atol": 1e-6},
        {"shape": (16, 64), "dtype": "bfloat16", "scale": 3.0,
         "atol": 1e-2},
    ),
    ref_accepts=(),
))


# ---------------------------------------------------------------------------
# Ergonomic wrappers (registry dispatch with explicit tunable overrides)
# ---------------------------------------------------------------------------


def fused_routing(u_hat, n_iters: int = 3, softmax_mode: str = "exact",
                  threads: Optional[int] = None,
                  tune: Optional[bool] = None):
    """u_hat (B, I, J, D) -> (v (B, J, D), c (B, I, J)): every routing
    iteration in one kernel launch (plain version for a CPU tensor)."""
    return registry.call("fused_routing", u_hat, n_iters=n_iters,
                         softmax_mode=softmax_mode,
                         config={"threads": threads}, tune=tune)


def taylor_softmax(x, threads: Optional[int] = None,
                   tune: Optional[bool] = None):
    """Softmax over the last axis with the Eq. 2 polynomial exp."""
    return registry.call("taylor_softmax", x, config={"threads": threads},
                         tune=tune)
