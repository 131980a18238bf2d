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


# -- flash_attention --------------------------------------------------------
# The example cases are the reference's.  The tunable is the CUDA kernel's
# own: ``q_block`` query positions per thread block, each with all G heads of
# its KV head (G * q_block <= 64 rows); the KV tile is fixed at 64 rows and a
# ragged last tile is masked, so no block size has to divide S or T.


def _build_flash_attention():
    from repro_torch.kernels.attention.kernel import flash_attention_cuda

    return flash_attention_cuda


def _attention_reference():
    from repro_torch.kernels.attention.ref import attention_ref

    return attention_ref


def _pow2_floor(n: int) -> int:
    return 1 << (max(int(n), 1).bit_length() - 1)


def _legalize_flash(config: Dict[str, Any], q, k=None, v=None, **kwargs
                    ) -> Dict[str, Any]:
    """``q_block`` becomes the largest power of two that keeps G * q_block
    within a block's 64 rows and does not pass the sequence.  Idempotent."""
    from repro_torch.kernels.attention.kernel import FLASH_ROWS
    from repro_torch.kernels.tuning import next_pow2

    g = max(1, q.shape[2] // (k.shape[2] if k is not None else q.shape[2]))
    cap = min(int(config["q_block"]), max(1, FLASH_ROWS // g),
              next_pow2(q.shape[1]))
    config["q_block"] = _pow2_floor(cap)
    return config


def _attention_example(case, device="cpu"):
    b, s, t, h, k, d = case.get("dims", (2, 128, 128, 4, 2, 32))
    dtype, seed = case.get("dtype", "float32"), case.get("seed", 0)
    q = _rand(seed, (b, s, h, d), dtype, device=device)
    kk = _rand(seed + 1, (b, t, k, d), dtype, device=device)
    v = _rand(seed + 2, (b, t, k, d), dtype, device=device)
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


# -- decode_attention -------------------------------------------------------
# q_len = 1 serving decode against a dense cache (B, T, K, D), each slot
# masked at its own ``kv_valid_len``.  The example cases are the
# reference's, paged and int8 ones included: their oracle is ported, their
# kernel bodies come with the paged slice (the wrapper raises on them).  The
# tunable is the block size: one block serves one (slot, KV head) and its
# warps take the slot's cache tiles in turn.


def _build_decode_attention():
    from repro_torch.kernels.attention.kernel import decode_attention_cuda

    return decode_attention_cuda


def _decode_attention_reference():
    from repro_torch.kernels.attention.ref import decode_attention_ref

    return decode_attention_ref


def _legalize_decode(config: Dict[str, Any], q, k=None, *args, **kwargs
                     ) -> Dict[str, Any]:
    """Whole warps, at most 512 threads, and no more warps than the
    block's shared memory holds at this head dim.  Idempotent."""
    from repro_torch.kernels.attention.kernel import (MAX_DYNAMIC_SMEM,
                                                      decode_smem_bytes)

    t = max(WARP, min(512, int(config["threads"]) // WARP * WARP))
    while t > WARP and decode_smem_bytes(q.shape[-1], t) > MAX_DYNAMIC_SMEM:
        t -= WARP
    config["threads"] = t
    return config


def _decode_attention_example(case, device="cpu"):
    import torch

    from repro_torch.models.attention import quantize_kv_rows

    b, t, h, nkv, d = case.get("dims", (4, 128, 8, 4, 32))
    dtype, seed = case.get("dtype", "float32"), case.get("seed", 0)
    q = _rand(seed, (b, 1, h, d), dtype, device=device)
    dtype = case.get("kv_dtype", dtype)          # a cache type of its own
    valid = torch.tensor(case["valid"], dtype=torch.int32, device=device)
    kwargs = {"softmax_mode": case.get("softmax_mode", "exact")}
    paged = case.get("paged")
    if paged:
        n_pages, page, p_per = paged
        kk = _rand(seed + 1, (n_pages, page, nkv, d), dtype, device=device)
        v = _rand(seed + 2, (n_pages, page, nkv, d), dtype, device=device)
        kwargs["tables"] = ((torch.arange(b * p_per, dtype=torch.int32,
                                          device=device)
                             .reshape(b, p_per)) * 7 + 3) % n_pages
    else:
        kk = _rand(seed + 1, (b, t, nkv, d), dtype, device=device)
        v = _rand(seed + 2, (b, t, nkv, d), dtype, device=device)
    if case.get("quant"):
        kk, kwargs["ks"] = quantize_kv_rows(kk)
        v, kwargs["vs"] = quantize_kv_rows(v)
    return (q, kk, v, valid), kwargs


registry.register(KernelSpec(
    name="decode_attention",
    build=_build_decode_attention,
    reference=_decode_attention_reference,
    space={"threads": (64, 128, 256),
           "softmax_mode": ("exact", "taylor")},
    tuned=("threads",),
    base_config={"threads": 256},
    legalize=_legalize_decode,
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
    ),
    ref_accepts=("tables", "ks", "vs"),
))


# -- fused_sampling ---------------------------------------------------------
# Temperature / top-k / top-p and the counter-based draw of every row in one
# launch; greedy (temperature <= 0) is an exact argmax.  Tokens are int32,
# so the parity harness's tolerance means equality.  The tunable is the
# block size (one block per row).


def _build_fused_sampling():
    from repro_torch.kernels.sampling.kernel import fused_sampling_cuda

    return fused_sampling_cuda


def _sampling_reference():
    from repro_torch.kernels.sampling.ref import fused_sampling_ref

    return fused_sampling_ref


def _sampling_example(case, device="cpu"):
    import torch

    b, v = case.get("dims", (8, 64))
    logits = _rand(case.get("seed", 0), (b, v), "float32", scale=3.0,
                   device=device)

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
    space={"threads": (256, 512, 1024)},
    tuned=("threads",),
    base_config={"threads": 1024},
    legalize=_legalize_threads,
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


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                    softmax_mode: str = "exact",
                    q_block: Optional[int] = None,
                    tune: Optional[bool] = None):
    """q (B, S, H, D); k, v (B, T, K, D); H = K * G -> (B, S, H, D)."""
    return registry.call("flash_attention", q, k, v, causal=causal,
                         q_offset=q_offset, softmax_mode=softmax_mode,
                         config={"q_block": q_block}, tune=tune)


def decode_attention(q, k, v, kv_valid_len, tables=None, ks=None, vs=None,
                     softmax_mode: str = "exact",
                     threads: Optional[int] = None,
                     tune: Optional[bool] = None):
    """q_len = 1 decode attention: q (B, 1, H, D) against a dense cache
    k, v (B, T, K, D), each slot masked at ``kv_valid_len`` (B,) ->
    (B, 1, H, D).  ``tables`` / ``ks`` / ``vs`` (paged and int8 caches)
    raise ``NotImplementedError`` until the paged slice."""
    return registry.call("decode_attention", q, k, v, kv_valid_len,
                         tables=tables, ks=ks, vs=vs,
                         softmax_mode=softmax_mode,
                         config={"threads": threads}, tune=tune)


def fused_sampling(logits, temperature, seeds, pos, top_k=None, top_p=None,
                   threads: Optional[int] = None,
                   tune: Optional[bool] = None, scratch=None):
    """Fused sampling: logits (B, V) float32 and per-row temperature / seed
    / position / top_k / top_p -> (B,) int32 tokens.  Scalars and host
    arrays are broadcast to (B,) and reach the logits' device in one copy;
    ``top_k`` None or 0 and ``top_p`` None or 1.0 leave the restriction
    off.  Seeds are taken modulo 2^32, as the kernel's uint32 hash reads
    them.  ``scratch`` is the kernel's work space (see
    :func:`repro_torch.kernels.sampling.kernel.fused_sampling_cuda`)."""
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
        tp.view(torch.float32), config={"threads": threads}, tune=tune,
        scratch=scratch)
