"""Measured launch-geometry autotuning for the kernel registry.

FastCaps' methodology is a *design-space search* over kernel
configurations (Fig. 1/8: simplified nonlinearities, reordered loops,
parallelization factors chosen per target).  This module is the search
half of that story for the port's CUDA kernels: every
:class:`repro_torch.kernels.KernelSpec` declares a tunable space (for a
CUDA kernel its launch geometry: threads per block), and the tuner
measures the candidates on the card and remembers the winner.

Three pieces:

* **Deterministic defaults** (``tune=False``, the CI path) — config
  resolution never measures anything: the spec's base config is
  legalized against the concrete shapes.
* **The measured tuner** (:func:`autotune`) — times every legalized
  candidate config of a kernel on example inputs (median of CUDA-event
  times after a warm-up) and returns the winner plus the full timing
  table.  The base config is always a candidate, so the tuned choice is
  never slower than the default on the measuring card.
* **The on-disk cache** (:class:`TuneCache`) — winners are stored as
  JSON keyed by ``(kernel, backend, shape-bucket, dtype)`` under
  ``~/.cache/repro-torch-kernels`` (override with
  ``REPRO_TORCH_KERNEL_CACHE_DIR``), so tuning survives processes.
  Shapes are bucketed to powers of two: one tuning run covers the whole
  bucket, keeping the cache small and lookups O(1).  The backend of a
  key is the device type of the arguments (``"cuda"`` or ``"cpu"``).

Whether dispatch *consults* the tuner is a scoped policy, not a global:
``with tuning(True): ...`` (thread-local) or the
``REPRO_TORCH_KERNEL_TUNE=1`` environment variable.  Only tensors on the
card are ever measured; on CPU tensors the wrappers run their plain
versions, which have no geometry to tune.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

CACHE_ENV = "REPRO_TORCH_KERNEL_CACHE_DIR"
TUNE_ENV = "REPRO_TORCH_KERNEL_TUNE"
CACHE_VERSION = 1


# ---------------------------------------------------------------------------
# Deterministic config helpers (shared by every spec's legalizer)
# ---------------------------------------------------------------------------


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1).

    This is the shared block-size default: the whole dimension is covered
    by equal full blocks, and an odd size degrades gracefully (n=9, cap=8
    -> 3) instead of collapsing to 1 the way halving-from-8 did.

    Raises :class:`ValueError` on ``n <= 0`` or ``cap <= 0`` — a zero-size
    dimension or a zero/negative block request is always a caller bug
    (empty example case, config typo), and silently returning 1 used to
    hide it until the kernel produced garbage grids.
    """
    n, cap = int(n), int(cap)
    if n <= 0:
        raise ValueError(f"largest_divisor: dimension must be positive, "
                         f"got n={n}")
    if cap <= 0:
        raise ValueError(f"largest_divisor: block cap must be positive, "
                         f"got cap={cap} (for dimension n={n})")
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (bucket key for cache shapes).  Named
    distinctly from ``serving.schedulers.pow2_bucket(n, cap)``, which
    clamps — confusing the two picks the wrong bucket."""
    b = 1
    while b < int(n):
        b *= 2
    return b


def shape_bucket(shapes: Iterable[Tuple[int, ...]]) -> str:
    """Cache-key string for a tuple of array shapes, pow2-bucketed per dim
    (``(9, 252, 10, 16)`` -> ``"16x256x16x16"``)."""
    return ",".join("x".join(str(next_pow2(d)) for d in s) or "scalar"
                    for s in shapes)


def config_label(config: Dict[str, Any]) -> str:
    """Canonical label for a config in timing tables and reports
    (``{"q_block": 64, "kv_block": 128}`` -> ``"kv_block=128,q_block=64"``).
    The single source of the format — :func:`autotune` keys its timing
    table with it, and benches/tests must index with it, never rebuild
    the string by hand."""
    return ",".join(f"{k}={config[k]}" for k in sorted(config))


# ---------------------------------------------------------------------------
# Tuning policy (scoped, thread-local)
# ---------------------------------------------------------------------------

_POLICY = threading.local()


def tune_enabled() -> bool:
    """Whether dispatch should consult the tuner cache (scope > env)."""
    scoped = getattr(_POLICY, "tune", None)
    if scoped is not None:
        return scoped
    return (os.environ.get(TUNE_ENV, "").strip().lower()
            not in ("", "0", "false", "off", "no"))


@contextlib.contextmanager
def tuning(enabled: bool = True):
    """Scope in which registry dispatch prefers tuned configs.

    Thread-local, so one serving engine can run tuned kernels while
    another thread stays on deterministic defaults.
    """
    prev = getattr(_POLICY, "tune", None)
    _POLICY.tune = bool(enabled)
    try:
        yield
    finally:
        _POLICY.tune = prev


# ---------------------------------------------------------------------------
# On-disk cache
# ---------------------------------------------------------------------------


class TuneCache:
    """JSON-backed winner cache keyed ``kernel|backend|bucket|dtype``.

    The file is read lazily once and written atomically (per-writer tmp
    + rename, with a merge of the on-disk entries first), so multiple
    processes sharing one cache dir can write concurrently without ever
    publishing corrupt JSON or erasing each other's keys; an unwritable
    cache dir degrades to memory-only.  Entries store the winning config
    plus the measured timing table for reporting::

        {"version": 1,
         "entries": {"fused_routing|cuda|32x256x16x16|float32":
                     {"config": {"threads": 512},
                      "timings": {"threads=512": 0.0012, ...}}}}
    """

    def __init__(self, path: Optional[str] = None):
        if path is None:
            root = os.environ.get(CACHE_ENV) or os.path.join(
                os.path.expanduser("~"), ".cache", "repro-torch-kernels")
            path = os.path.join(root, "autotune.json")
        self.path = path
        self._entries: Optional[Dict[str, Dict[str, Any]]] = (
            None)                                      # guarded-by: _lock
        self._written: set = set()                     # guarded-by: _lock
        #   ^ the keys THIS instance put (the merge-on-write overlay set)
        self._lock = threading.Lock()

    @staticmethod
    def key(kernel: str, backend: str, bucket: str, dtype: str) -> str:
        return f"{kernel}|{backend}|{bucket}|{dtype}"

    def _load_locked(self) -> Dict[str, Dict[str, Any]]:
        """Lazy read of the on-disk cache; ``_locked`` = caller holds
        ``self._lock`` (every public entry point takes it first)."""
        if self._entries is None:
            entries: Dict[str, Dict[str, Any]] = {}
            try:
                with open(self.path) as f:
                    blob = json.load(f)
                if blob.get("version") == CACHE_VERSION:
                    entries = dict(blob.get("entries", {}))
            except (OSError, ValueError):
                pass
            self._entries = entries
        return self._entries

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            entry = self._load_locked().get(key)
            return dict(entry["config"]) if entry else None

    def entry(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._load_locked().get(key)
            return json.loads(json.dumps(e)) if e else None

    def put(self, key: str, config: Dict[str, Any],
            timings: Optional[Dict[str, float]] = None) -> None:
        with self._lock:
            entries = self._load_locked()
            entries[key] = {"config": dict(config),
                            "timings": dict(timings or {})}
            self._written.add(key)
            try:
                os.makedirs(os.path.dirname(self.path), exist_ok=True)
                # Concurrent writers (two serving processes sharing one
                # REPRO_TORCH_KERNEL_CACHE_DIR) must never corrupt the file or
                # erase each other's keys:
                #   * an exclusive flock on a sidecar lock file brackets
                #     the whole read-merge-replace, so no other writer's
                #     publish can land inside our window (platforms
                #     without fcntl skip the lock: writes stay corruption
                #     -free via the rename, a racing key may be lost);
                #   * merge-on-write — re-read the file under the lock
                #     and overlay ONLY the keys this instance itself
                #     wrote, so entries another process published since
                #     our lazy load survive (overlaying the whole stale
                #     in-memory snapshot would silently revert them);
                #   * a per-writer tmp name — a shared `.tmp` would let
                #     two processes interleave writes into one file and
                #     os.replace() would then publish the garbage;
                #   * atomic rename — readers only ever see a complete
                #     JSON document.
                with self._file_lock():
                    merged: Dict[str, Dict[str, Any]] = {}
                    try:
                        with open(self.path) as f:
                            blob = json.load(f)
                        if blob.get("version") == CACHE_VERSION:
                            merged.update(blob.get("entries", {}))
                    except (OSError, ValueError):
                        pass
                    merged.update({k: entries[k] for k in self._written
                                   if k in entries})
                    self._entries = merged
                    tmp = (f"{self.path}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
                    with open(tmp, "w") as f:
                        json.dump({"version": CACHE_VERSION,
                                   "entries": merged},
                                  f, indent=1, sort_keys=True)
                    os.replace(tmp, self.path)
            except OSError:
                pass                      # memory-only fallback

    @contextlib.contextmanager
    def _file_lock(self):
        """Exclusive cross-process lock around read-merge-replace (a
        sidecar ``.lock`` file, never the data file itself — locking the
        file we os.replace would lock a dead inode)."""
        try:
            import fcntl
        except ImportError:               # non-POSIX: best-effort, no lock
            yield
            return
        with open(self.path + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def clear_memory(self) -> None:
        """Drop the in-memory view (tests: re-read after env changes)."""
        with self._lock:
            self._entries = None


_default_cache = TuneCache()


def default_cache() -> TuneCache:
    """Process-wide cache; re-targets if REPRO_TORCH_KERNEL_CACHE_DIR changed."""
    global _default_cache
    root = os.environ.get(CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro-torch-kernels")
    expect = os.path.join(root, "autotune.json")
    if _default_cache.path != expect:
        _default_cache = TuneCache(expect)
    return _default_cache


# ---------------------------------------------------------------------------
# Measurement
# ---------------------------------------------------------------------------


def _time_call(fn: Callable[[], Any], warmup: int = 1, iters: int = 3
               ) -> float:
    """Median seconds of ``fn`` on the current CUDA device, by CUDA events
    (the host clock would time the enqueue, not the kernel)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    times.sort()
    return times[len(times) // 2]


def candidate_configs(spec, *args, **kwargs) -> List[Dict[str, Any]]:
    """Legalized, deduplicated candidate configs for ``spec`` on these
    shapes: the cartesian product of the tuned axes of ``spec.space``,
    with the (legalized) base config guaranteed present and first."""
    import itertools

    base = spec.legalize(dict(spec.base_config), *args, **kwargs)
    seen, out = set(), []

    def push(cfg):
        key = tuple(sorted(cfg.items()))
        if key not in seen:
            seen.add(key)
            out.append(cfg)

    push(base)
    axes = [(k, spec.space[k]) for k in spec.tuned]
    for combo in itertools.product(*(vals for _, vals in axes)):
        cand = dict(spec.base_config)
        cand.update({k: v for (k, _), v in zip(axes, combo)})
        push(spec.legalize(cand, *args, **kwargs))
    return out


def autotune(spec, args: tuple, kwargs: Optional[dict] = None,
             cache: Optional[TuneCache] = None, warmup: int = 1,
             iters: int = 3,
             timer: Optional[Callable[..., float]] = None,
             ) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Measure every candidate config of ``spec`` on concrete ``args``.

    Returns ``(best_config, timings)`` where ``timings`` maps a compact
    config label to median seconds; the winner is stored in ``cache``
    (the default on-disk cache when None) under the shape-bucket key, so
    later dispatches pick it up.  ``timer(fn, warmup=, iters=)`` replaces
    the CUDA-event measurement (tests inject a deterministic one).
    """
    kwargs = dict(kwargs or {})
    cache = cache or default_cache()
    timer = timer or _time_call
    key = cache_key_for(spec, args)
    impl = spec.build()
    best_cfg, best_t = None, float("inf")
    timings: Dict[str, float] = {}
    for cfg in candidate_configs(spec, *args, **kwargs):
        label = config_label(cfg)
        t = timer(lambda cfg=cfg: impl(*args, **kwargs, **cfg),
                  warmup=warmup, iters=iters)
        timings[label] = t
        if t < best_t:
            best_cfg, best_t = cfg, t
    if best_cfg is None:
        raise RuntimeError(f"autotune: {spec.name} has no candidate config")
    cache.put(key, best_cfg, timings)
    return best_cfg, timings


def backend_of(args: tuple) -> str:
    """Device type of the first tensor argument (``"cuda"`` / ``"cpu"``)."""
    first = next((a for a in args if hasattr(a, "device")), None)
    return first.device.type if first is not None else "cpu"


def cache_key_for(spec, args: tuple) -> str:
    """(kernel, backend, shape-bucket, dtype) key for these arguments."""
    shapes = [tuple(getattr(a, "shape", ())) for a in args
              if hasattr(a, "shape")]
    first = next((a for a in args if hasattr(a, "dtype")), None)
    dtype = (str(first.dtype).replace("torch.", "") if first is not None
             else "none")
    return TuneCache.key(spec.name, backend_of(args), shape_bucket(shapes),
                         dtype)
