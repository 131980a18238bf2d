"""CUDA graphs: the port's stand-in for the reference's ``jax.jit``.

The reference traces an entry point once per input shape and replays the
compiled executable (``src/repro/deploy/pipeline.py:209``, the serving
steps of ``src/repro/serving/engine.py:144-167``).  On the card the port
does the same with a captured CUDA graph: :class:`CapturedCall` records
one call of a function on static input buffers and replays it.  The
kernels inside stay the port's own hand-written ones; the graph only
removes the host's launch work between them.

A call site keeps one :class:`CapturedCall` per key (a batch shape) and:

* fills the call's static ``inputs`` before each run (:meth:`stage`, or
  ``copy_`` into ``call.inputs[name]`` from a pinned host buffer);
* calls it with the tensors the function reads or writes in place
  (``reads``: caches, pool leaves, parameters).  The first call runs the
  function once eagerly on a side stream (that run is the call's result:
  it also resolves every kernel config and builds the kernels), then
  captures it into a graph on the device's shared memory pool.  Each
  later call checks that every ``reads`` tensor still has the address it
  had at capture (a tensor that moved is re-captured, and counted:
  :attr:`CapturedCall.stats`), replays the graph, adds the launch
  counts the capture recorded to the kernel wrappers' counters, and
  returns the outputs cloned (the ``keep`` outputs uncloned: valid until
  the next replay of any graph of the device's pool).

A capture that fails raises :class:`GraphError`; nothing falls back to the
eager run on a CUDA tensor.  The cyclic garbage collector is off during a
capture: an unreachable engine's graph destroyed mid-capture would
invalidate it.  Under :func:`capturing`, a tuner run
(:func:`repro_torch.kernels.tuning.autotune`) or a kernel build
(:func:`repro_torch.kernels.build.load_library`) raises.  On the CPU, and
inside :func:`eager` (the profiler's traced runs and the comparisons of
graph against eager), a call runs the same function on the same static
inputs eagerly.

Launch counters: every kernel wrapper counts its launches in Python
(``<wrapper>.launches`` and its ``launches_by_*`` dicts), and those lines
run once, at capture.  :func:`counters` reads them all; a capture records
its growth and sets the counters back (a capture launches nothing), and
each replay adds it once.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch


class GraphError(RuntimeError):
    """A capture failed, or work that must not run inside a captured
    region (a tuner run, a kernel build) was asked for there."""


_local = threading.local()

# Totals over every call site of this process (chip_smoke.py reads them per
# phase; an engine reads its own calls' stats).
TOTALS: Dict[str, float] = {"captures": 0, "recaptures": 0, "replays": 0,
                            "eager": 0, "capture_s": 0.0}


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Run every graph call site of this thread eagerly inside the scope
    (the same staged code, on the same static buffers): for the profiler's
    traced runs, whose counting rule needs each launch on the host, and
    for holding the graphs against the eager port."""
    _local.eager = getattr(_local, "eager", 0) + 1
    try:
        yield
    finally:
        _local.eager -= 1


def active(device: torch.device) -> bool:
    """Whether a call site on ``device`` captures and replays: a CUDA
    device, outside :func:`eager`."""
    return device.type == "cuda" and not getattr(_local, "eager", 0)


def capturing() -> bool:
    """Whether this thread is inside a capture."""
    return bool(getattr(_local, "capturing", 0))


def refuse_in_capture(what: str) -> None:
    """Raise :class:`GraphError` inside a capture: ``what`` must run
    before it (config resolution, kernel builds)."""
    if capturing():
        raise GraphError(f"{what} inside a captured CUDA graph: resolve "
                         f"configs and build the kernels before the capture")


def config_key() -> tuple:
    """What a capture bakes in besides the shapes: the launch configs the
    kernel registry resolves, which follow the tuning policy (off, or on
    over the tune cache at its path).  Call sites key their graphs with
    it, so a graph captured untuned is not replayed under tuning, nor one
    of one tune cache under another (a config tuned into the same cache
    after the capture is not picked up)."""
    from repro_torch.kernels import tuning

    return ((tuning.default_cache().path,) if tuning.tune_enabled()
            else (None,))


# -- launch counters ---------------------------------------------------------

# the counted kernel wrappers, ``module:function``
COUNTED_WRAPPERS = (
    "repro_torch.kernels.routing.routing_kernel:fused_routing_cuda",
    "repro_torch.kernels.softmax.kernel:taylor_softmax_cuda",
    "repro_torch.kernels.softmax.kernel:taylor_softmax_bwd_cuda",
    "repro_torch.kernels.attention.kernel:flash_attention_cuda",
    "repro_torch.kernels.attention.kernel:flash_attention_dequant_cuda",
    "repro_torch.kernels.attention.kernel:decode_attention_cuda",
    "repro_torch.kernels.sampling.kernel:fused_sampling_cuda",
    "repro_torch.kernels.gemm.kernel:fixed_order_matmul_cuda",
)

CounterKey = Tuple[str, str, Any]

_counted: Dict[str, Any] = {}        # name -> wrapper, bound at first use


def _wrappers():
    if not _counted:
        for target in COUNTED_WRAPPERS:
            module, name = target.split(":")
            _counted[name] = getattr(importlib.import_module(module), name)
    return _counted.items()


def counters() -> Dict[CounterKey, int]:
    """Every launch counter of the kernel wrappers: ``(wrapper,
    attribute, None)`` for an int counter, ``(wrapper, attribute, key)``
    for each entry of a ``launches_by_*`` dict."""
    out: Dict[CounterKey, int] = {}
    for name, fn in _wrappers():
        for attr, value in vars(fn).items():
            if not attr.startswith("launches"):
                continue
            if isinstance(value, dict):
                for k, n in value.items():
                    out[(name, attr, k)] = int(n)
            else:
                out[(name, attr, None)] = int(value)
    return out


def _set_counters(values: Dict[CounterKey, int], add: bool) -> None:
    _wrappers()
    for (name, attr, k), n in values.items():
        fn = _counted[name]
        if k is None:
            setattr(fn, attr, (getattr(fn, attr) if add else 0) + n)
        else:
            d = getattr(fn, attr)
            d[k] = (d[k] if add else 0) + n


def add_counts(delta: Dict[CounterKey, int]) -> None:
    """Add a capture's launch counts to the counters (one replay)."""
    _set_counters(delta, add=True)


def restore_counts(before: Dict[CounterKey, int]) -> None:
    """Set the counters back to ``before``."""
    _set_counters(before, add=False)


def count_delta(before: Dict[CounterKey, int],
                after: Dict[CounterKey, int]) -> Dict[CounterKey, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


# -- memory pools and streams -----------------------------------------------

_pools: Dict[torch.device, Any] = {}
_streams: Dict[torch.device, Any] = {}


def _pool(device: torch.device):
    """The graph memory pool shared by every capture on ``device``."""
    if device not in _pools:
        _pools[device] = torch.cuda.graph_pool_handle()
    return _pools[device]


def _stream(device: torch.device):
    """The side stream every warm-up and capture on ``device`` runs on."""
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device)
    return _streams[device]


# -- one captured call ---------------------------------------------------------


def _map(fn, out):
    if isinstance(out, tuple):
        return tuple(_map(fn, o) for o in out)
    if isinstance(out, list):
        return [_map(fn, o) for o in out]
    if isinstance(out, dict):
        return {k: _map(fn, v) for k, v in out.items()}
    return fn(out) if isinstance(out, torch.Tensor) else out


class CapturedCall:
    """``fn(**inputs)`` captured once into a CUDA graph on the static
    ``inputs`` and replayed per call (see the module docstring).

    ``fn`` returns a tensor or a tuple of them; ``keep`` names the
    positions of a tuple returned uncloned.  ``name`` labels errors.  A
    ``reads`` tensor that moved since the capture re-captures (counted in
    ``stats["recaptures"]``): a replay never reads stale addresses."""

    def __init__(self, fn: Callable[..., Any], inputs: Dict[str, torch.Tensor],
                 name: str = "graph", keep: Sequence[int] = ()):
        self.fn = fn
        self.inputs = inputs
        self.name = name
        self.keep = frozenset(keep)
        self.device = next(iter(inputs.values())).device
        self.stats: Dict[str, float] = {"captures": 0, "recaptures": 0,
                                        "replays": 0, "eager": 0,
                                        "capture_s": 0.0}
        self.last_capture_s = 0.0      # seconds the last call's capture took
        self._graph = None
        self._out = None
        self._delta: Dict[CounterKey, int] = {}
        self._ptrs: Tuple[int, ...] = ()

    def stage(self, **values: torch.Tensor) -> None:
        """Copy each value into its static input (asynchronously from a
        pinned host tensor)."""
        for k, v in values.items():
            self.inputs[k].copy_(v, non_blocking=True)

    @property
    def delta(self) -> Dict[CounterKey, int]:
        """The launch counts one replay adds (the capture's)."""
        return dict(self._delta)

    def __call__(self, reads: Sequence[torch.Tensor] = ()) -> Any:
        self.last_capture_s = 0.0
        if not active(self.device):
            self._bump("eager")
            return self.fn(**self.inputs)
        ptrs = tuple(t.data_ptr() for t in reads)
        if self._graph is not None and ptrs != self._ptrs:
            self._graph = self._out = None
            self._bump("recaptures")
        if self._graph is None:
            return self._capture(ptrs)
        self._graph.replay()
        add_counts(self._delta)
        self._bump("replays")
        return self._outputs(self._out)

    def _bump(self, key: str, n: float = 1) -> None:
        self.stats[key] += n
        TOTALS[key] += n

    def _outputs(self, out: Any) -> Any:
        if isinstance(out, tuple):
            return tuple(o if i in self.keep else _map(torch.clone, o)
                         for i, o in enumerate(out))
        return _map(torch.clone, out)

    def _capture(self, ptrs: Tuple[int, ...]) -> Any:
        """One eager run on the side stream (the call's result), then the
        capture on the same stream."""
        device = self.device
        side, cur = _stream(device), torch.cuda.current_stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(**self.inputs)
        cur.wait_stream(side)
        # the warm-up's tensors were made on the side stream: their memory
        # must not be reused there before this stream is done with them
        _map(lambda t: t.record_stream(cur), out)
        before = counters()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        _local.capturing = getattr(_local, "capturing", 0) + 1
        # no garbage collection inside the capture: a graph collected there
        # (an engine's, freed with its reference cycle) destroys itself
        # with calls a capture forbids, which invalidates this one
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=_pool(device), stream=side,
                                  capture_error_mode="thread_local"):
                static = self.fn(**self.inputs)
        except Exception as e:
            raise GraphError(f"{self.name}: capture failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
            _local.capturing -= 1
            after = counters()
            restore_counts(before)
        self.last_capture_s = time.perf_counter() - t0
        self._bump("captures")
        self._bump("capture_s", self.last_capture_s)
        self._graph, self._out, self._ptrs = graph, static, ptrs
        self._delta = count_delta(before, after)
        return out


def graph_stats(calls: Sequence[Optional[CapturedCall]]) -> Dict[str, float]:
    """The stats of several call sites summed."""
    out = {"captures": 0, "recaptures": 0, "replays": 0, "eager": 0,
           "capture_s": 0.0}
    for c in calls:
        if c is not None:
            for k in out:
                out[k] += c.stats[k]
    return out
