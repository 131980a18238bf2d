"""kernel-legality: every legalized kernel config is launchable on Hopper.

The tuner proposes launch geometries, ``spec.legalize`` clamps them to
what the kernel and the shapes allow, and dispatch launches whatever comes
out.  The reference proves its Pallas invariants (blocks divide their
dimension, a block's working set fits a per-backend budget); a CUDA kernel
has other limits: threads per block, the thread-block cluster, the dynamic
shared memory a block may ask for, the blocks of a grid on each axis.  This
rule proves those, symbolically.

Each :class:`repro_torch.kernels.KernelSpec` declares
``launch_plan(config, *args, **kw) -> {"threads", "cluster", "grid"[,
"smem_bytes"]}``, which calls the planners the kernel's wrapper itself
calls (``routing_smem_bytes``, ``softmax_tile_rows``,
``decode_smem_bytes``, ``sampling_smem_bytes``), so the checker and
dispatch cannot drift.  A plan without ``smem_bytes`` is a kernel whose
shared memory a constant of its source fixes (flash attention by head dim,
the softmax tile by ``kSoftmaxTileBytes``); the source proves that one
with a ``static_assert`` when it compiles.  For every spec the checker takes the spec's own
``example_cases`` *plus* variants scaled to the serving shape buckets of
:data:`repro_torch.configs.SHAPES` (seq 4k/32k/500k, batch 1..256, and 3),
as meta tensors (nothing is allocated), and for every candidate the tuner
could propose (:func:`repro_torch.kernels.tuning.candidate_configs`)
proves:

* **illegal-config** — every knob of the legalized config is a positive
  int (and legalize does not fail on an example case);
* **bad-threads** — the block is whole warps, at most
  :data:`~repro_torch.kernels.limits.MAX_THREADS`;
* **over-cluster** — the cluster is at most
  :data:`~repro_torch.kernels.limits.MAX_CLUSTER` blocks (the portable
  size);
* **over-smem** — the block asks for at most
  :data:`~repro_torch.kernels.limits.MAX_DYNAMIC_SMEM` bytes of dynamic
  shared memory;
* **over-grid** — the grid, as the source's launcher computes it, has at
  least one block on each axis, at most
  :data:`~repro_torch.kernels.limits.MAX_GRID_X` on x and
  :data:`~repro_torch.kernels.limits.MAX_GRID_YZ` on y and z (the card
  refuses a launch past them at run time, whatever the shapes; a plan
  without ``grid`` is not checked for it);
* **unstable-legalize** — legalization is idempotent (a drifting
  legalizer would make cached tuner winners resolve differently than they
  measured);
* **unverifiable** (warning) — a spec without ``launch_plan`` cannot be
  verified.

A scaled case that a kernel refuses outright — its legalize raises
``ValueError``, as for an image of more capsules or a row of more logits
than a cluster's shared memory holds, which the wrapper refuses on the
card too — lies outside the kernel's domain and is skipped; an example
case must legalize.  Each run records in :attr:`KernelLegalityChecker.cases`
how many example cases, proven scaled cases and refused scaled cases each
spec had (``--json`` reports them), so a legalizer that refused every
serving-sized shape would show.

Unlike the other rules this one runs against the *live* registry (it
imports ``repro_torch.kernels``), because the invariant lives in Python
callables, not source text.  ``chip_smoke.py`` holds its verdicts against
the card: every candidate it passes is launched there.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Iterator, List, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.loader import Project
from repro_torch.kernels.limits import (MAX_CLUSTER, MAX_DYNAMIC_SMEM,
                                        MAX_GRID_X, MAX_GRID_YZ, MAX_THREADS,
                                        WARP)


def _bucket_values() -> List[int]:
    """Serving shape-bucket dims (seq + batch) from repro_torch.configs,
    plus an odd size."""
    from repro_torch.configs import SHAPES

    vals: Set[int] = {3}
    for info in SHAPES.values():
        vals.add(int(info["seq"]))
        vals.add(int(info["batch"]))
    return sorted(vals)


def _meta(x: Any, shape=None) -> Any:
    """A tensor as an allocation-free meta stand-in (of ``shape`` when
    given); anything else passes through."""
    import torch

    if not isinstance(x, torch.Tensor):
        return x
    return torch.empty(tuple(x.shape) if shape is None else shape,
                       dtype=x.dtype, device="meta")


def _scaled(args: tuple, kwargs: dict, value: int, bucket: int):
    """The case with every axis equal to ``value``, of every tensor
    argument, replaced by ``bucket`` (how the same kernel sees a
    serving-sized shape)."""
    import torch

    def scale(x):
        if not isinstance(x, torch.Tensor):
            return x
        return _meta(x, tuple(bucket if d == value else d for d in x.shape))

    return (tuple(scale(a) for a in args),
            {k: scale(v) for k, v in kwargs.items()})


def _shapes(args: tuple, kwargs: dict) -> str:
    import torch

    xs = [a for a in list(args) + list(kwargs.values())
          if isinstance(a, torch.Tensor)]
    return "/".join("x".join(str(d) for d in x.shape) for x in xs) or "scalar"


def _label(config: Dict[str, Any]) -> str:
    from repro_torch.kernels.tuning import config_label

    return config_label(config)


class KernelLegalityChecker:
    name = "kernel-legality"
    description = (f"every tuner candidate, legalized against the example "
                   f"cases and the repro_torch.configs shape buckets, "
                   f"launches within Hopper's limits: whole warps up to "
                   f"{MAX_THREADS} threads, a cluster of at most "
                   f"{MAX_CLUSTER}, at most {MAX_DYNAMIC_SMEM} bytes of "
                   f"dynamic shared memory, a grid of at most {MAX_GRID_X} "
                   f"blocks on x and {MAX_GRID_YZ} on y and z")
    codes = {
        "illegal-config": "a legalized knob is not a positive int, or "
                          "legalize fails on an example case",
        "bad-threads": "the block is not whole warps or exceeds 1024 "
                       "threads",
        "over-cluster": "the cluster exceeds the portable 8 blocks",
        "over-smem": "the block asks for more dynamic shared memory than "
                     "Hopper gives one",
        "over-grid": "the grid has more blocks on an axis than Hopper "
                     "launches (2^31 - 1 on x, 65535 on y and z), or none",
        "unstable-legalize": "legalize is not idempotent on its own "
                             "output",
        "unverifiable": "spec declares no launch_plan; legality cannot "
                        "be proven",
    }

    def __init__(self, kernel_registry=None):
        self._registry = kernel_registry
        # spec -> {"example", "scaled", "refused"}: the cases of the last
        # run (written anew by every run; no finding depends on it)
        self.cases: Dict[str, Dict[str, int]] = {}

    def run(self, project: Project) -> Iterator[Finding]:
        reg = self._registry
        if reg is None:
            from repro_torch.kernels.registry import registry as reg
        emitted: Set[Tuple[str, str, str]] = set()
        cases: Dict[str, Dict[str, int]] = {}
        for name in reg.names():
            counts = cases[name] = {"example": 0, "scaled": 0, "refused": 0}
            for f in self._check_spec(project.root, reg.get(name), counts):
                key = (f.code, f.symbol, f.message)
                if key not in emitted:
                    emitted.add(key)
                    yield f
        self.cases = cases

    # -- per-spec ------------------------------------------------------------

    @staticmethod
    def _location(root: Path, spec) -> Tuple[str, int]:
        fn = spec.launch_plan or spec.legalize
        code = getattr(fn, "__code__", None)
        if code is None:              # e.g. functools.partial
            code = getattr(getattr(fn, "func", None), "__code__", None)
        if code is None:
            return (f"<kernel:{spec.name}>", 1)
        path = Path(code.co_filename)
        try:
            rel = path.resolve().relative_to(root).as_posix()
        except ValueError:
            rel = path.as_posix()
        return (rel, code.co_firstlineno)

    def _check_spec(self, root: Path, spec, counts: Dict[str, int]
                    ) -> Iterator[Finding]:
        path, line = self._location(root, spec)
        if spec.launch_plan is None:
            yield Finding(
                rule=self.name, code="unverifiable", path=path, line=line,
                symbol=spec.name, severity="warning",
                message=(f"kernel `{spec.name}` declares no launch_plan; "
                         f"its legalized configs cannot be verified"),
                hint="declare launch_plan from the planners the wrapper "
                     "calls")
            return
        for _, value, _, args, kwargs in self.case_variants(spec):
            example = value is None
            proven = self.prove(spec, args, kwargs, example,
                                location=(path, line))
            counts["example" if example else
                   "scaled" if proven else "refused"] += 1
            for _, found in proven:
                yield from found

    def prove(self, spec, args: tuple, kwargs: dict, example: bool = True,
              location=None) -> List[Tuple[Dict[str, Any], List[Finding]]]:
        """``[(candidate, findings)]`` for every tuner candidate of
        ``spec`` on these arguments (meta stand-ins, or real tensors on the
        card, where ``chip_smoke.py`` launches each candidate that has no
        finding).  A case the kernel refuses outright (``ValueError`` from
        legalize) gives ``[]`` unless it is an ``example`` case."""
        from repro_torch.kernels import tuning

        path, line = location or self._location(Path.cwd(), spec)
        try:
            candidates = tuning.candidate_configs(spec, *args, **kwargs)
        # The whole point: a legalize that *crashes* on a shape case is
        # itself the finding (recorded below, never swallowed); only a
        # ValueError on a scaled case is the kernel refusing the shape.
        # capslint: disable=exception-hygiene
        except Exception as e:
            if isinstance(e, ValueError) and not example:
                return []
            return [({}, [Finding(
                rule=self.name, code="illegal-config", path=path,
                line=line, symbol=spec.name,
                message=(f"kernel `{spec.name}` fails to legalize on "
                         f"shapes {_shapes(args, kwargs)}: "
                         f"{type(e).__name__}: {e}"),
                hint="legalize must accept every example case")])]
        return [(config, list(self._check_candidate(
                    spec, path, line, args, kwargs, config)))
                for config in candidates]

    def _check_candidate(self, spec, path: str, line: int, args: tuple,
                         kwargs: dict, config: Dict[str, Any]
                         ) -> Iterator[Finding]:
        shapes = _shapes(args, kwargs)
        label = _label(config)

        def finding(code: str, message: str, hint: str) -> Finding:
            return Finding(rule=self.name, code=code, path=path, line=line,
                           symbol=spec.name,
                           message=(f"kernel `{spec.name}`: {message} with "
                                    f"{label} on shapes {shapes}"),
                           hint=hint)

        bad = {k: v for k, v in config.items()
               if not isinstance(v, int) or isinstance(v, bool) or v < 1}
        if bad:
            yield finding("illegal-config",
                          f"legalized knobs {bad} are not positive ints",
                          "legalize must clamp every knob to a positive "
                          "int")
            return
        plan = spec.launch_plan(dict(config), *args, **kwargs)
        threads, cluster = plan["threads"], plan["cluster"]
        smem = plan.get("smem_bytes", 0)
        if threads % WARP or not WARP <= threads <= MAX_THREADS:
            yield finding("bad-threads",
                          f"a block of {threads} threads is not whole warps "
                          f"in [{WARP}, {MAX_THREADS}]",
                          "legalize threads to a multiple of 32 up to 1024")
        if not 1 <= cluster <= MAX_CLUSTER:
            yield finding("over-cluster",
                          f"a cluster of {cluster} blocks is outside "
                          f"[1, {MAX_CLUSTER}]",
                          "clamp the cluster to the portable 8 blocks")
        if smem > MAX_DYNAMIC_SMEM:
            yield finding("over-smem",
                          f"a block asks for {smem} bytes of dynamic shared "
                          f"memory, more than {MAX_DYNAMIC_SMEM}",
                          "legalize against the planner's shared memory, "
                          "not just the knob's range")
        grid = plan.get("grid")
        if grid is not None and not all(
                1 <= n <= cap for n, cap in zip(
                    grid, (MAX_GRID_X, MAX_GRID_YZ, MAX_GRID_YZ))):
            yield finding("over-grid",
                          f"a grid of {tuple(grid)} blocks is outside "
                          f"[1, {MAX_GRID_X}] x [1, {MAX_GRID_YZ}] x "
                          f"[1, {MAX_GRID_YZ}]",
                          "put the blocks on axis x, or refuse the shape in "
                          "legalize")
        again = spec.legalize(dict(config), *args, **kwargs)
        if again != config:
            yield finding("unstable-legalize",
                          f"legalize is not idempotent ({label} -> "
                          f"{_label(again)})",
                          "legalize(legalize(c)) must equal legalize(c), "
                          "or cached tuner winners drift on reload")

    # -- case generation -------------------------------------------------

    @staticmethod
    def case_variants(spec) -> Iterator[Tuple[dict, Any, Any, tuple, dict]]:
        """``(case, value, bucket, args, kwargs)``: each example case on meta
        (``value`` and ``bucket`` None), then its variants with each axis of
        the first tensor argument but the last (batch, sequence, capsules,
        rows; the last is a feature axis the kernels fix: head dim, capsule
        dim, row or vocabulary length) scaled to every bucket: every axis
        equal to ``value``, of every tensor argument, becomes ``bucket``."""
        import torch

        buckets = _bucket_values()
        for case in spec.example_cases:
            real_args, real_kwargs = spec.make_example(case)
            args = tuple(_meta(a) for a in real_args)
            kwargs = {k: _meta(v) for k, v in real_kwargs.items()}
            yield case, None, None, args, kwargs
            first = next(a for a in args if isinstance(a, torch.Tensor))
            for value in sorted({d for d in first.shape[:-1] if d > 1}):
                for bucket in buckets:
                    if bucket != value:
                        yield (case, value, bucket,
                               *_scaled(args, kwargs, value, bucket))
