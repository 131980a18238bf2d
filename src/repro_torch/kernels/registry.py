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
  * ``launch_plan`` — what a legalized config asks of the card (threads,
    cluster size, the grid, and the dynamic shared memory where the shapes
    size it), from the planners the wrapper itself calls; capslint's
    ``kernel-legality`` rule proves every tuner candidate within Hopper's
    limits with it;
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
from repro_torch.kernels.limits import MAX_THREADS, WARP
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
    ``launch_plan(config, *args, **kw) -> {"threads", "cluster", "grid"[,
    "smem_bytes"]}`` is what the kernel's launch with a legalized
    ``config`` asks for: ``grid`` the blocks on axes (x, y, z), as the
    source's launcher computes them; ``smem_bytes`` where the shapes size
    the shared memory (where a constant of the source bounds it, the source
    asserts that it fits).  It is read by
    :mod:`repro_torch.analysis.checkers.legality`, never by dispatch.
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
    launch_plan: Optional[Callable[..., Dict[str, int]]] = None

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
          device="cpu", rng=None):
    """Seeded example input, made with numpy so that it does not depend on
    the device or on the PyTorch version; or, for a case that asks for
    ``rng`` "device", by the generator of the device it is made on (fast at
    the sizes of kernel-legality's scaled cases; an empty tensor on
    meta)."""
    import numpy as np
    import torch

    if rng == "device":
        dev = torch.device(device)
        if dev.type == "meta":
            return torch.empty(shape, dtype=getattr(torch, dtype), device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(shape, generator=gen, device=dev) * scale
        return x.to(getattr(torch, dtype))
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
              scale=0.2, device=device, rng=case.get("rng"))
    return (u,), {"n_iters": case.get("n_iters", 3),
                  "softmax_mode": case.get("softmax_mode", "exact")}


def _legalize_routing(config: Dict[str, Any], u_hat, *args, **kwargs
                      ) -> Dict[str, Any]:
    """Whole warps, at most 1024 threads; then the cluster size that
    :func:`plan_i_splits` gives this ``u_hat`` on this card (0 asks for its
    plan, a tuned size is kept where its slice fits).  On the CPU, where
    the plain version takes any I, an I that fits no cluster keeps the
    largest size; on the card and on meta it raises ``ValueError``.
    Idempotent."""
    from repro_torch.kernels.routing.routing_kernel import (
        ROUTING_MAX_CLUSTER, plan_i_splits)

    config = _legalize_threads(config)
    b, i, j, d = u_hat.shape
    try:
        config["i_splits"] = plan_i_splits(
            b, i, j, d, u_hat.element_size(), config["i_splits"],
            _sm_count(u_hat.device))
    except ValueError:
        if u_hat.device.type != "cpu":
            raise
        config["i_splits"] = ROUTING_MAX_CLUSTER
    return config


def _routing_plan(config: Dict[str, Any], u_hat, *args, **kwargs
                  ) -> Dict[str, int]:
    from repro_torch.kernels.routing.routing_kernel import routing_smem_bytes

    b, i, j, d = u_hat.shape
    return {"smem_bytes": routing_smem_bytes(i, j, d, u_hat.element_size(),
                                             config["i_splits"]),
            "threads": config["threads"], "cluster": config["i_splits"],
            "grid": (b * config["i_splits"], 1, 1)}


# The tunables are the cluster size (blocks that split an image's input
# capsules; 0 = planned) and the block size.
registry.register(KernelSpec(
    name="fused_routing",
    build=_build_fused_routing,
    reference=_routing_reference,
    space={"i_splits": (1, 2, 4, 8), "threads": (128, 256, 512, 1024),
           "softmax_mode": ("exact", "taylor")},
    tuned=("i_splits", "threads"),
    base_config={"i_splits": 0, "threads": 256},
    legalize=_legalize_routing,
    launch_plan=_routing_plan,
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
              scale=case.get("scale", 5.0), device=device,
              rng=case.get("rng"))
    return (x,), {}


def _softmax_plan(operands: int) -> Callable[..., Dict[str, int]]:
    """The plan of the softmax kernels (one operand forward, x and the
    cotangent backward): the threads the wrapper launches, which for the
    tile kernel are the rows of its tile.  No shared memory: the source
    bounds a tile by ``kSoftmaxTileBytes`` and asserts that it fits."""

    def plan(config: Dict[str, Any], x, *args, **kwargs) -> Dict[str, int]:
        from repro_torch.kernels.softmax.kernel import (softmax_body,
                                                        softmax_tile_rows)

        n, threads = x.shape[-1], config["threads"]
        rows = x.numel() // max(n, 1)
        body = softmax_body(n)
        if body == "tile":
            # a row a thread
            threads = softmax_tile_rows(rows, n, operands * x.element_size(),
                                        threads)
            blocks = -(-rows // threads)
        elif body == "warp":
            blocks = -(-rows // (threads // WARP))    # a row a warp
        else:
            blocks = rows                             # a row a block
        return {"threads": threads, "cluster": 1, "grid": (blocks, 1, 1)}

    return plan


registry.register(KernelSpec(
    name="taylor_softmax",
    build=_build_taylor_softmax,
    reference=_softmax_reference,
    space={"threads": (128, 256, 512, 1024)},
    tuned=("threads",),
    base_config={"threads": 256},
    legalize=_legalize_threads,
    launch_plan=_softmax_plan(1),
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


# -- taylor_softmax_bwd -----------------------------------------------------
# The backward of row 2, which has no TPU kernel (the reference
# differentiates its plain-jnp softmax with jax.grad): (x, g) -> dx.  The
# tunable is row 2's.  The last case puts entries exactly on the clip edge
# (x - max(x) = -32, where the derivative is 1/2) and past it.


def _build_taylor_softmax_bwd():
    from repro_torch.kernels.softmax.kernel import taylor_softmax_bwd_cuda

    return taylor_softmax_bwd_cuda


def _softmax_bwd_reference():
    from repro_torch.kernels.softmax.ref import taylor_softmax_bwd_ref

    return taylor_softmax_bwd_ref


def _softmax_bwd_example(case, device="cpu"):
    import torch

    shape = case.get("shape", (8, 16))
    dtype = case.get("dtype", "float32")
    x = _rand(case.get("seed", 0), shape, "float32",
              scale=case.get("scale", 5.0), device=device,
              rng=case.get("rng"))
    if case.get("edge"):
        # row r holds a maximum of 0 and an entry at exactly -32 (and one
        # below it) wherever the row is long enough
        x[..., 0] = 0.0
        x = torch.clamp(x, min=-31.0, max=-1e-3)
        x[..., 0] = 0.0
        x[..., 1] = -32.0
        if shape[-1] > 2:
            x[..., 2] = -40.0
    g = _rand(case.get("seed", 0) + 1, shape, "float32", device=device,
              rng=case.get("rng"))
    return (x.to(getattr(torch, dtype)), g.to(getattr(torch, dtype))), {}


registry.register(KernelSpec(
    name="taylor_softmax_bwd",
    build=_build_taylor_softmax_bwd,
    reference=_softmax_bwd_reference,
    space={"threads": (128, 256, 512, 1024)},
    tuned=("threads",),
    base_config={"threads": 256},
    legalize=_legalize_threads,
    launch_plan=_softmax_plan(2),
    make_example=_softmax_bwd_example,
    example_cases=(
        {"shape": (8, 16), "atol": 1e-6},
        {"shape": (33, 250), "atol": 1e-6},
        {"shape": (4, 7, 64), "atol": 1e-6},
        {"shape": (1, 1024), "atol": 1e-6},
        {"shape": (16, 64), "dtype": "bfloat16", "scale": 3.0,
         "atol": 1e-2},
        {"shape": (6, 5, 10), "scale": 1.0, "edge": True, "atol": 1e-6},
    ),
    ref_accepts=(),
))


# -- flash_attention --------------------------------------------------------
# The example cases are the reference's.  The tunable is the CUDA kernel's
# own: ``q_block`` query positions per thread block, each with all G heads of
# its KV head, or a chunk of them past 64 (G * q_block <= 64 rows); the KV
# tile is fixed at 64 rows and a ragged last tile is masked, so no block size
# has to divide S or T.


def _build_flash_attention():
    from repro_torch.kernels.attention.kernel import flash_attention_cuda

    return flash_attention_cuda


def _attention_reference():
    from repro_torch.kernels.attention.ref import attention_ref

    return attention_ref


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _refuse_misfit(what: str, q, k=None) -> None:
    """``ValueError`` for a (B, T, K, D) cache ``k`` that does not fit the
    (B, S, H, D) query ``q``: the wrappers refuse such shapes outright, so
    they lie outside the kernel's domain (kernel-legality skips them)."""
    if k is None:
        return
    b, h, d = q.shape[0], q.shape[2], q.shape[-1]
    if k.shape[0] != b or k.shape[-1] != d or h % k.shape[2]:
        raise ValueError(f"{what}: cache {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")


def _legalize_flash(config: Dict[str, Any], q, k=None, v=None, **kwargs
                    ) -> Dict[str, Any]:
    """``q_block`` becomes the largest power of two that keeps G * q_block
    within a block's 64 rows and does not pass the sequence, G the query
    heads a block holds (a group of more than 64 is dealt to chunks,
    ``flash_block_heads``).  A cache that does not fit q (another batch or
    head dim, H not a multiple of K) is refused with ``ValueError``, as the
    wrapper refuses it on every device.  Idempotent."""
    from repro_torch.kernels.attention.kernel import (FLASH_ROWS,
                                                      flash_block_heads)
    from repro_torch.kernels.tuning import next_pow2

    _refuse_misfit("flash attention", q, k)
    g = flash_block_heads(
        q.shape[2] // (k.shape[2] if k is not None else q.shape[2]))
    cap = min(int(config["q_block"]), max(1, FLASH_ROWS // g),
              next_pow2(q.shape[1]))
    config["q_block"] = _pow2_floor(cap)
    return config


def _flash_plan(config: Dict[str, Any], q, k=None, *args, **kwargs
                ) -> Dict[str, int]:
    """A flash block: the fixed threads of the body q's type takes; one
    block a cluster; one flattened grid on axis x, a block per q tile of
    ``q_block`` positions, batch row, KV head and chunk of its query heads
    (``flash_head_chunks``).  No shared memory: the head dim fixes it, and
    each launch template of the source asserts that it fits."""
    from repro_torch.kernels.attention.kernel import (FLASH_THREADS,
                                                      flash_body,
                                                      flash_head_chunks)

    b, s = q.shape[0], q.shape[1]
    nkv = k.shape[2] if k is not None else q.shape[2]
    chunks = flash_head_chunks(q.shape[2] // nkv)
    n_qt = -(-s // config["q_block"])
    return {"threads": FLASH_THREADS[flash_body(q.dtype)], "cluster": 1,
            "grid": (n_qt * b * nkv * chunks, 1, 1)}


def _attention_example(case, device="cpu"):
    b, s, t, h, k, d = case.get("dims", (2, 128, 128, 4, 2, 32))
    dtype, seed, rng = (case.get("dtype", "float32"), case.get("seed", 0),
                        case.get("rng"))
    q = _rand(seed, (b, s, h, d), dtype, device=device, rng=rng)
    kk = _rand(seed + 1, (b, t, k, d), dtype, device=device, rng=rng)
    v = _rand(seed + 2, (b, t, k, d), dtype, device=device, rng=rng)
    return (q, kk, v), {"causal": case.get("causal", True),
                        "q_offset": case.get("q_offset", 0),
                        "softmax_mode": case.get("softmax_mode", "exact")}


registry.register(KernelSpec(
    name="flash_attention",
    build=_build_flash_attention,
    reference=_attention_reference,
    space={"q_block": (8, 16, 32, 64),
           "softmax_mode": ("exact", "taylor")},
    tuned=("q_block",),
    base_config={"q_block": 64},
    legalize=_legalize_flash,
    launch_plan=_flash_plan,
    make_example=_attention_example,
    example_cases=(
        {"dims": (2, 128, 128, 8, 4, 32), "causal": True, "atol": 2e-5},
        {"dims": (2, 64, 256, 8, 2, 32), "causal": False, "atol": 2e-5},
        {"dims": (1, 192, 192, 2, 1, 64), "causal": True,
         "atol": 2e-5},                               # non-pow2 seq
        {"dims": (1, 64, 256, 4, 2, 32), "causal": True, "q_offset": 192,
         "atol": 2e-5},                               # decode window
        {"dims": (1, 128, 128, 4, 2, 32), "softmax_mode": "taylor",
         "atol": 5e-2},                # vs exact oracle: approx-exp bound
    ),
    ref_accepts=("causal", "q_offset"),
))


# -- flash_attention_dequant ------------------------------------------------
# Flash attention over int8 K/V rows with one float32 scale per cache row,
# shared by the KV heads, dequantized as the tiles are read (the resident
# cache stays int8).  The example cases are the reference's; the tunable is
# ``q_block`` as for flash_attention.  ``page_size`` is structural (the
# page length the rows were written in), legalized to divide T as the
# reference's block divisor does; the kernel reads a scale per row, so its
# tiles need no alignment to it.


def _build_flash_attention_dequant():
    from repro_torch.kernels.attention.kernel import (
        flash_attention_dequant_cuda)

    return flash_attention_dequant_cuda


def _attention_dequant_reference():
    from repro_torch.kernels.attention.ref import attention_dequant_ref

    return attention_dequant_ref


def _legalize_flash_dequant(config: Dict[str, Any], q, kq=None, *args,
                            **kwargs) -> Dict[str, Any]:
    """``q_block`` as :func:`_legalize_flash`; ``page_size`` the largest
    divisor of T not above the request.  Idempotent."""
    config = _legalize_flash(config, q, kq)
    t = kq.shape[1] if kq is not None else q.shape[1]
    config["page_size"] = largest_divisor(t, int(config["page_size"]))
    return config


def _attention_dequant_example(case, device="cpu"):
    from repro_torch.models.attention import quantize_kv_rows

    b, s, t, h, k, d = case.get("dims", (2, 128, 128, 4, 2, 32))
    seed, rng = case.get("seed", 0), case.get("rng")
    q = _rand(seed, (b, s, h, d), case.get("dtype", "float32"),
              device=device, rng=rng)
    kq, ks = quantize_kv_rows(_rand(seed + 1, (b, t, k, d), device=device,
                                    rng=rng))
    vq, vs = quantize_kv_rows(_rand(seed + 2, (b, t, k, d), device=device,
                                    rng=rng))
    return ((q, kq, ks, vq, vs),
            {"causal": case.get("causal", True),
             "q_offset": case.get("q_offset", 0),
             "softmax_mode": case.get("softmax_mode", "exact")})


registry.register(KernelSpec(
    name="flash_attention_dequant",
    build=_build_flash_attention_dequant,
    reference=_attention_dequant_reference,
    space={"q_block": (8, 16, 32, 64),
           "page_size": (8, 16, 32, 64, 128),
           "softmax_mode": ("exact", "taylor")},
    tuned=("q_block",),
    base_config={"q_block": 64, "page_size": 64},
    legalize=_legalize_flash_dequant,
    launch_plan=_flash_plan,
    make_example=_attention_dequant_example,
    example_cases=(
        # parity vs the dequantizing oracle is tight: both read the same
        # int8 rows, so quantization error cancels and only the online
        # softmax differs.  (The *quantization* tolerance vs an
        # unquantized cache is asserted end-to-end in the serving tests.)
        {"dims": (2, 128, 128, 8, 4, 32), "causal": True, "atol": 2e-5},
        {"dims": (2, 64, 256, 8, 2, 32), "causal": False, "atol": 2e-5},
        {"dims": (1, 64, 256, 4, 2, 32), "causal": True, "q_offset": 192,
         "atol": 2e-5},                               # decode window
        {"dims": (1, 192, 192, 2, 1, 64), "causal": True,
         "atol": 2e-5},                               # non-pow2 seq
    ),
    ref_accepts=("causal", "q_offset"),
))


# -- decode_attention -------------------------------------------------------
# q_len = 1 serving decode, each slot masked at its own ``kv_valid_len``,
# over a dense cache (B, T, K, D) or the page pool's (n_pages, page, K, D)
# leaves read in place through per-slot ``tables`` (B, P), either optionally
# int8 with per-row scales ``ks``/``vs``: four bodies of one kernel.  The
# example cases are the reference's; a case may also ask for ``shuffled``
# tables (a permutation of the pool, -1 past each slot's last valid page).
# The tunables are ``kv_splits``, the blocks of the cluster that serves one
# (slot, KV head), each owning a contiguous range of the slot's rows, and
# the block size, whose warps take the range's cache tiles in turn.

# The port's own cases, after the reference's, at group sizes those do not
# reach: the decode kernel takes every G the reference takes, G 12
# (mistral-large's 96 query heads over 8 KV heads: two chunks of 6) over a
# bf16 cache and over int8 pages, G 6 (dbrx's 48 over 8: one block) and G
# 20 (three chunks of 7, 7 and 6).
PORT_DECODE_CASES = (
    {"dims": (2, 64, 24, 2, 32), "valid": (64, 29), "kv_dtype": "bfloat16",
     "atol": 2e-5},
    {"dims": (3, 64, 24, 2, 32), "valid": (49, 64, 8), "paged": (12, 16, 4),
     "quant": True, "atol": 2e-5},
    {"dims": (2, 96, 12, 2, 16), "valid": (96, 5), "atol": 2e-5},
    {"dims": (2, 64, 40, 2, 32), "valid": (64, 13), "atol": 2e-5},
)


def _build_decode_attention():
    from repro_torch.kernels.attention.kernel import decode_attention_cuda

    return decode_attention_cuda


def _decode_attention_reference():
    from repro_torch.kernels.attention.ref import decode_attention_ref

    return decode_attention_ref


def _sm_count(device) -> int:
    """The SMs of the card the tensors lie on; the H100's off the card,
    where the plain version ignores the plan."""
    from repro_torch.kernels.attention.kernel import H100_SMS

    if device.type != "cuda":
        return H100_SMS
    if device not in _SM_COUNTS:
        import torch

        _SM_COUNTS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNTS[device]


_SM_COUNTS: Dict[Any, int] = {}


def _legalize_decode(config: Dict[str, Any], q, k=None, *args,
                     tables=None, **kwargs) -> Dict[str, Any]:
    """``kv_splits`` no more than :func:`decode_kv_splits` plans for one
    slot's KV heads, chunks of their query heads and rows on this card
    (the same for every batch); then whole warps, at most 512 threads,
    and no more warps than the block's shared memory holds at this head
    dim, cache type and split count.  Shapes the wrapper refuses on every device (a cache that does
    not fit q) raise its ``ValueError``.  Idempotent."""
    from repro_torch.kernels.attention.kernel import (
        DECODE_MAX_THREADS, _check_decode_cache, decode_kv_splits,
        decode_smem_bytes)
    from repro_torch.kernels.limits import MAX_DYNAMIC_SMEM

    if len(args) >= 2:
        _check_decode_cache(q, k, args[0], args[1], tables,
                            kwargs.get("ks"), kwargs.get("vs"))
    h, d = q.shape[2], q.shape[-1]
    nkv, kv_bytes = k.shape[2], k.element_size()
    t = (tables.shape[1] * k.shape[1] if tables is not None else k.shape[1])
    splits = decode_kv_splits(nkv, t, int(config["kv_splits"]),
                              _sm_count(q.device), h // nkv)
    threads = max(WARP, min(DECODE_MAX_THREADS,
                            int(config["threads"]) // WARP * WARP))
    while threads > WARP and decode_smem_bytes(
            d, threads, kv_bytes, splits) > MAX_DYNAMIC_SMEM:
        threads -= WARP
    config["kv_splits"], config["threads"] = splits, threads
    return config


def _decode_plan(config: Dict[str, Any], q, k=None, *args, **kwargs
                 ) -> Dict[str, int]:
    """A block per (slot, KV head, chunk of at most 8 query heads, split
    of the slot's rows), on axis x; ``chunked`` says whether the launch
    takes the source's chunked template instances (``kChunked``)."""
    from repro_torch.kernels.attention.kernel import (decode_chunked,
                                                      decode_group_chunks,
                                                      decode_smem_bytes)

    b, nkv = q.shape[0], k.shape[2]
    chunked = decode_chunked(q.shape[2] // nkv)
    chunks = decode_group_chunks(q.shape[2] // nkv) if chunked else 1
    return {"smem_bytes": decode_smem_bytes(
                q.shape[-1], config["threads"], k.element_size(),
                config["kv_splits"]),
            "threads": config["threads"], "cluster": config["kv_splits"],
            "grid": (b * nkv * chunks * config["kv_splits"], 1, 1),
            "chunked": chunked}


def _decode_attention_example(case, device="cpu"):
    import torch

    from repro_torch.models.attention import quantize_kv_rows

    b, t, h, nkv, d = case.get("dims", (4, 128, 8, 4, 32))
    dtype, seed, rng = (case.get("dtype", "float32"), case.get("seed", 0),
                        case.get("rng"))
    q = _rand(seed, (b, 1, h, d), dtype, device=device, rng=rng)
    dtype = case.get("kv_dtype", dtype)          # a cache type of its own
    valid = torch.tensor(case["valid"], dtype=torch.int32, device=device)
    kwargs = {"softmax_mode": case.get("softmax_mode", "exact")}
    paged = case.get("paged")
    if paged:
        import numpy as np

        n_pages, page, p_per = paged
        kk = _rand(seed + 1, (n_pages, page, nkv, d), dtype, device=device,
                   rng=rng)
        v = _rand(seed + 2, (n_pages, page, nkv, d), dtype, device=device,
                  rng=rng)
        if case.get("shuffled"):
            perm = np.random.RandomState(seed + 3).permutation(n_pages)
            tab = perm[:b * p_per].reshape(b, p_per).astype(np.int32)
            used = -(-np.asarray(case["valid"]) // page)   # pages in use
            tab[np.arange(p_per)[None, :] >= used[:, None]] = -1
            kwargs["tables"] = torch.from_numpy(tab).to(device)
        else:
            kwargs["tables"] = ((torch.arange(b * p_per, dtype=torch.int32,
                                              device=device)
                                 .reshape(b, p_per)) * 7 + 3) % n_pages
    else:
        kk = _rand(seed + 1, (b, t, nkv, d), dtype, device=device, rng=rng)
        v = _rand(seed + 2, (b, t, nkv, d), dtype, device=device, rng=rng)
    if case.get("quant"):
        kk, kwargs["ks"] = quantize_kv_rows(kk)
        v, kwargs["vs"] = quantize_kv_rows(v)
    return (q, kk, v, valid), kwargs


registry.register(KernelSpec(
    name="decode_attention",
    build=_build_decode_attention,
    reference=_decode_attention_reference,
    space={"threads": (64, 128, 256),
           "kv_splits": (1, 2, 4, 8),
           "softmax_mode": ("exact", "taylor")},
    tuned=("threads", "kv_splits"),
    base_config={"threads": 256, "kv_splits": 8},
    legalize=_legalize_decode,
    launch_plan=_decode_plan,
    make_example=_decode_attention_example,
    example_cases=(
        {"dims": (4, 128, 8, 2, 32), "valid": (128, 64, 1, 97),
         "atol": 2e-5},
        # ragged odd lengths + a fully-masked slot (valid=0 -> zeros)
        {"dims": (3, 96, 4, 2, 16), "valid": (5, 96, 0), "atol": 2e-5},
        {"dims": (6, 128, 4, 2, 32), "valid": (128, 31, 77, 1, 64, 9),
         "quant": True, "atol": 2e-5},
        # paged: (n_pages, page, pages_per_slot) pool, table indirection
        {"dims": (3, 64, 4, 2, 32), "valid": (64, 17, 1),
         "paged": (12, 16, 4), "atol": 2e-5},
        {"dims": (3, 64, 4, 2, 32), "valid": (49, 64, 8),
         "paged": (12, 16, 4), "quant": True, "atol": 2e-5},
        {"dims": (5, 128, 4, 2, 32), "valid": (100, 128, 64, 1, 27),
         "softmax_mode": "taylor", "atol": 5e-2},
    ) + PORT_DECODE_CASES,
    ref_accepts=("tables", "ks", "vs"),
))


# -- fused_sampling ---------------------------------------------------------
# Temperature / top-k / top-p and the counter-based draw of every row in one
# launch; greedy (temperature <= 0) is an exact argmax.  Tokens are int32,
# so the parity harness's tolerance means equality.  The tunables are the
# cluster size (the blocks that share a row) and the block size.


def _build_fused_sampling():
    from repro_torch.kernels.sampling.kernel import fused_sampling_cuda

    return fused_sampling_cuda


def _sampling_reference():
    from repro_torch.kernels.sampling.ref import fused_sampling_ref

    return fused_sampling_ref


def _legalize_sampling(config: Dict[str, Any], logits, *args, **kwargs
                       ) -> Dict[str, Any]:
    """Whole warps, at most 1024 threads; then the cluster size that
    :func:`plan_cluster` gives rows of this length.  Idempotent."""
    from repro_torch.kernels.sampling.kernel import plan_cluster

    config = _legalize_threads(config)
    config["cluster"] = plan_cluster(logits.shape[-1], config["cluster"],
                                     config["threads"])
    return config


def _sampling_plan(config: Dict[str, Any], logits, *args, **kwargs
                   ) -> Dict[str, int]:
    from repro_torch.kernels.sampling.kernel import sampling_smem_bytes

    return {"smem_bytes": sampling_smem_bytes(logits.shape[-1],
                                              config["cluster"]),
            "threads": config["threads"], "cluster": config["cluster"],
            "grid": (logits.shape[0] * config["cluster"], 1, 1)}


def _sampling_example(case, device="cpu"):
    import torch

    b, v = case.get("dims", (8, 64))
    logits = _rand(case.get("seed", 0), (b, v), "float32", scale=3.0,
                   device=device, rng=case.get("rng"))

    def row(key, default, dtype):
        return torch.tensor(case.get(key, (default,) * b), dtype=dtype,
                            device=device)

    seeds = torch.tensor([(i * 0x9E3779B1 + 17) & 0x7FFFFFFF
                          for i in range(b)], dtype=torch.int32,
                         device=device)
    pos = torch.tensor([i * 5 + case.get("pos0", 1) for i in range(b)],
                       dtype=torch.int32, device=device)
    return (logits, row("temperature", 1.0, torch.float32), seeds, pos,
            row("top_k", 0, torch.int32), row("top_p", 1.0, torch.float32)), {}


registry.register(KernelSpec(
    name="fused_sampling",
    build=_build_fused_sampling,
    reference=_sampling_reference,
    space={"cluster": (1, 2, 4, 8), "threads": (256, 512, 1024)},
    tuned=("cluster", "threads"),
    base_config={"cluster": 8, "threads": 512},
    legalize=_legalize_sampling,
    launch_plan=_sampling_plan,
    make_example=_sampling_example,
    example_cases=(
        # tokens are int32 — the parity harness's allclose means *equal*
        {"dims": (8, 64), "temperature": (0.0,) * 8},          # greedy
        {"dims": (8, 64)},                                     # temp 1.0
        {"dims": (6, 50), "temperature": (0.0, 0.7, 1.0, 1.3, 0.0, 2.0)},
        {"dims": (4, 64), "top_k": (5, 1, 64, 0)},
        {"dims": (4, 64), "top_p": (0.1, 0.5, 0.9, 1.0)},
        {"dims": (3, 33), "temperature": (0.8, 0.9, 1.1),
         "top_k": (7, 0, 3), "top_p": (0.9, 0.3, 1.0), "pos0": 11},
    ),
    ref_accepts=(),
))


# ---------------------------------------------------------------------------
# Ergonomic wrappers (registry dispatch with explicit tunable overrides)
# ---------------------------------------------------------------------------


def fused_routing(u_hat, n_iters: int = 3, softmax_mode: str = "exact",
                  i_splits: Optional[int] = None,
                  threads: Optional[int] = None,
                  tune: Optional[bool] = None):
    """u_hat (B, I, J, D) -> (v (B, J, D), c (B, I, J)): every routing
    iteration in one kernel launch, an image's input capsules split over
    ``i_splits`` blocks of a cluster (plain version for a CPU tensor)."""
    return registry.call("fused_routing", u_hat, n_iters=n_iters,
                         softmax_mode=softmax_mode,
                         config={"i_splits": i_splits, "threads": threads},
                         tune=tune)


def taylor_softmax(x, threads: Optional[int] = None,
                   tune: Optional[bool] = None):
    """Softmax over the last axis with the Eq. 2 polynomial exp."""
    return registry.call("taylor_softmax", x, config={"threads": threads},
                         tune=tune)


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                    softmax_mode: str = "exact",
                    q_block: Optional[int] = None,
                    tune: Optional[bool] = None):
    """q (B, S, H, D); k, v (B, T, K, D); H = K * G -> (B, S, H, D)."""
    return registry.call("flash_attention", q, k, v, causal=causal,
                         q_offset=q_offset, softmax_mode=softmax_mode,
                         config={"q_block": q_block}, tune=tune)


def taylor_softmax_bwd(x, g, threads: Optional[int] = None,
                       tune: Optional[bool] = None):
    """The gradient of ``taylor_softmax(x)`` against the output cotangent
    ``g`` (same shape and type) -> dx in ``x``'s type."""
    return registry.call("taylor_softmax_bwd", x, g,
                         config={"threads": threads}, tune=tune)


def flash_attention_dequant(q, kq, ks, vq, vs, causal: bool = True,
                            q_offset: int = 0, softmax_mode: str = "exact",
                            q_block: Optional[int] = None,
                            page_size: Optional[int] = None,
                            tune: Optional[bool] = None):
    """q (B, S, H, D); int8 kq, vq (B, T, K, D) with float32 per-row
    scales ks, vs (B, T) -> (B, S, H, D)."""
    return registry.call("flash_attention_dequant", q, kq, ks, vq, vs,
                         causal=causal, q_offset=q_offset,
                         softmax_mode=softmax_mode,
                         config={"q_block": q_block, "page_size": page_size},
                         tune=tune)


def decode_attention(q, k, v, kv_valid_len, tables=None, ks=None, vs=None,
                     softmax_mode: str = "exact",
                     threads: Optional[int] = None,
                     kv_splits: Optional[int] = None,
                     tune: Optional[bool] = None):
    """q_len = 1 decode attention: q (B, 1, H, D) against a dense cache
    k, v (B, T, K, D), or with ``tables`` (B, P) the pool leaves
    (n_pages, page, K, D), int8 with per-row scales ``ks``/``vs`` or not;
    each slot masked at ``kv_valid_len`` (B,) -> (B, 1, H, D)."""
    return registry.call("decode_attention", q, k, v, kv_valid_len,
                         tables=tables, ks=ks, vs=vs,
                         softmax_mode=softmax_mode,
                         config={"threads": threads, "kv_splits": kv_splits},
                         tune=tune)


def fused_sampling(logits, temperature, seeds, pos, top_k=None, top_p=None,
                   cluster: Optional[int] = None,
                   threads: Optional[int] = None,
                   tune: Optional[bool] = None):
    """Fused sampling: logits (B, V) float32 and per-row temperature / seed
    / position / top_k / top_p -> (B,) int32 tokens.  Scalars and host
    arrays are broadcast to (B,) and reach the logits' device in one copy;
    ``top_k`` None or 0 and ``top_p`` None or 1.0 leave the restriction
    off.  Seeds are taken modulo 2^32, as the kernel's uint32 hash reads
    them."""
    import numpy as np
    import torch

    b = logits.shape[0]

    def row(x, default, floating):
        """(B,) int32 bit patterns of a float32 or a uint32 row."""
        x = np.broadcast_to(np.asarray(default if x is None else x), (b,))
        if floating:
            return x.astype(np.float32).view(np.int32)
        return (x.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
            np.int32)

    packed = np.stack([row(temperature, 0.0, True), row(seeds, 0, False),
                       row(pos, 0, False), row(top_k, 0, False),
                       row(top_p, 1.0, True)])
    temp, seed, posr, tk, tp = torch.from_numpy(packed).to(
        logits.device).unbind(0)
    return registry.call(
        "fused_sampling", logits, temp.view(torch.float32), seed, posr, tk,
        tp.view(torch.float32),
        config={"cluster": cluster, "threads": threads}, tune=tune)
