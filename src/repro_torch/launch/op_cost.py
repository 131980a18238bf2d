"""Cost of an eager PyTorch function, counted op by op as it dispatches (the
port's twin of ``repro/launch/hlo_cost.py``).

The reference compiles a step, parses XLA's HLO text and weights each loop
body by its trip count.  Eager PyTorch has no compiled module: every aten op
the function runs passes through :class:`CostMode`, a ``TorchDispatchMode``,
which counts it as it goes.  So

  * a Python loop (the port's loop over stacked units, the chunked
    attention's KV blocks, a recurrent scan) is counted as it runs: there
    is no trip count to weight by;
  * autograd's backward (``torch.autograd.grad``) and the recompute of
    ``torch.utils.checkpoint`` are counted as they dispatch, so a remat
    step is charged its recomputed forward;
  * on the meta device nothing is computed or allocated, and a full-size
    step of a 123B-parameter model is counted on a laptop.

Conventions, as in HloCostAnalysis and the reference: an elementwise op
costs ``numel(result)`` flops; a matmul, bmm, baddbmm, the products an
einsum lowers to, or a convolution costs ``2 * numel(result) * K``
(``torch.utils.flop_counter``'s formulas; these are also ``dot_flops``); a
reduction costs ``max(numel(input), numel(result))``; a transcendental (exp,
log, tanh, rsqrt, sqrt, sigmoid, erf and the like) costs its numel in
flops and in ``transcendentals``; views, reshapes, ``detach``, allocations
and metadata ops are free; data movement (copies, concatenation, gathers,
fills) costs bytes but no flops.  Bytes are the operands' plus the
result's: in eager PyTorch each op reads its operands from device memory
and writes its result there, so this *is* eager's memory traffic (the
reference's "fusion = operands + result" with every op its own fusion).
An operand broadcast by a zero stride is charged its stored elements; a
gather or index reads only what it returns (2x the result plus the
indices), and a write into a slice (``copy_`` into a view) moves the
source and the slice.

A kernel wrapper of :mod:`repro_torch.kernels` given meta tensors computes
nothing and calls :func:`add_kernel` with its registry row's cost (the
bound formulas of :mod:`repro_torch.launch.roofline`): the kernel's own
bytes and operations, not those of its plain version.

``temp_bytes`` is the peak of the bytes held by storages the function
allocated (its arguments' storages excluded; outputs included while they
live), tracked through weak references to the storages.  A storage's
Python object lives exactly as long as its ``StorageImpl`` (PyTorch keeps
the object of a storage that C++ still holds), so a storage that autograd
saves for the backward stays counted until the graph lets it go; meta
storages carry their byte size like any other.

There are no collectives: the port has no partitioner.  A copy between
two devices is recorded in ``collective_by_kind["device_copy"]``; a meta
dry run has none.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_FREE = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "_unsafe_view", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type", "record_stream",
    "resize_", "set_", "_reshape_alias", "view",
}
# ops that write their result and read nothing but indices (bytes: the
# result, and any index operand)
_FILLS = {
    "zeros", "ones", "full", "zeros_like", "ones_like", "full_like",
    "new_zeros", "new_ones", "new_full", "fill_", "zero_", "fill",
    "arange", "linspace", "scalar_tensor", "randn", "rand", "randint",
    "randn_like", "rand_like", "randint_like", "normal_", "uniform_",
    "bernoulli", "bernoulli_", "random_", "exponential_", "eye", "tril_indices",
    "triu_indices", "lift_fresh_copy",
}
# data movement: bytes, no flops
_MOVES = {
    "clone", "_to_copy", "copy_", "copy", "cat", "stack", "constant_pad_nd",
    "repeat", "flip", "roll", "permute_copy", "transpose_copy", "t_copy",
    "expand_copy", "view_copy", "_unsafe_index_put", "index_put",
    "slice_scatter", "select_scatter", "diagonal_scatter",
    "as_strided_scatter", "split_with_sizes_copy", "unbind_copy",
    "sort", "argsort", "topk", "nonzero", "masked_select", "tril", "triu",
    "one_hot", "_unsafe_view_copy", "unfold_copy", "narrow_copy",
    "index_copy", "_pin_memory",
}
# in-place writes of a few rows through indices: bytes are the source rows
# read, the rows written and the indices, not the whole destination; the
# adding ones cost a flop a written element
_INDEX_WRITES = {"index_put_", "index_copy_", "index_add_", "scatter_",
                 "scatter_add_", "scatter_reduce_"}
# reads only what it returns: 2x the result plus the indices
_GATHERS = {"index", "_unsafe_index", "index_select", "gather", "embedding",
            "take", "take_along_dim"}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
    "any", "all", "cumsum", "cumprod", "logcumsumexp", "count_nonzero",
    "nll_loss_forward", "nll_loss2d_forward", "aminmax", "_cdist_forward",
    "native_layer_norm", "native_group_norm", "native_batch_norm",
    "_native_batch_norm_legit", "_native_batch_norm_legit_no_training",
}
# transcendental reductions: flops as a reduction, one transcendental per
# input element
_TRANSCENDENTAL_REDUCTIONS = {"_softmax", "_log_softmax", "logsumexp",
                              "logcumsumexp"}
_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10", "log1p",
    "tanh", "tanh_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "sigmoid",
    "sigmoid_", "erf", "erf_", "erfc", "erfinv", "pow", "pow_", "sin",
    "cos", "tan", "atan", "asin", "acos", "sinh", "cosh", "logit", "silu",
    "silu_", "gelu", "gelu_", "softplus", "mish", "elu", "selu", "celu",
    "log_sigmoid_forward", "gelu_backward", "silu_backward", "xlogy",
    "special_erfcx", "lgamma", "digamma",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")


@dataclasses.dataclass
class Cost:
    """What a function costs.  The reference's fields (``flops``,
    ``transcendentals``, ``bytes``, ``collective_bytes``,
    ``collective_by_kind``, ``collective_count``), plus ``dot_flops`` (the
    matmul and convolution share of ``flops``), ``temp_bytes`` (the peak
    bytes of storages the function allocated),
    and per-op tallies: ``op_counts`` and ``op_bytes`` by aten op name
    (``aten.mm``; a kernel wrapper on meta as ``kernel.<row>``) and
    ``layout_copy_bytes`` (the copies that materialize a layout:
    ``clone``, ``_to_copy`` on one device, ``copy_`` between layouts)."""

    flops: float = 0.0
    transcendentals: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_flops: float = 0.0
    temp_bytes: int = 0
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    layout_copy_bytes: float = 0.0

    def add(self, other: "Cost", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.transcendentals += other.transcendentals * mult
        self.bytes += other.bytes * mult
        self.collective_bytes += other.collective_bytes * mult
        self.dot_flops += other.dot_flops * mult
        self.layout_copy_bytes += other.layout_copy_bytes * mult
        for mine, theirs in ((self.collective_by_kind,
                              other.collective_by_kind),
                             (self.collective_count, other.collective_count),
                             (self.op_counts, other.op_counts),
                             (self.op_bytes, other.op_bytes)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0) + v * mult


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor's elements occupy, a dimension of stride 0 (a
    broadcast) counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _numel(t: Any) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _tensors(tree: Any, acc: Optional[List[torch.Tensor]] = None
             ) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (nested tuples, lists
    and dicts; faster than a general tree flatten, which would dominate
    the count's own time)."""
    acc = [] if acc is None else acc
    if isinstance(tree, torch.Tensor):
        acc.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            if isinstance(x, torch.Tensor):
                acc.append(x)
            elif isinstance(x, (list, tuple, dict)):
                _tensors(x, acc)
    elif isinstance(tree, dict):
        _tensors(list(tree.values()), acc)
    return acc


_ACTIVE: List["CostMode"] = []


def add_kernel(name: str, nbytes: float, ops: float, dot_ops: float = 0.0,
               transcendentals: float = 0.0) -> None:
    """Charge a hand-written kernel's cost (``name``: its kernel-table row)
    to every active :class:`CostMode`.  A kernel wrapper calls this when
    it is given meta tensors; outside a counting scope it does nothing."""
    for mode in _ACTIVE:
        c = mode.cost
        c.flops += ops
        c.dot_flops += dot_ops
        c.transcendentals += transcendentals
        c.bytes += nbytes
        key = f"kernel.{name}"
        c.op_counts[key] = c.op_counts.get(key, 0) + 1
        c.op_bytes[key] = c.op_bytes.get(key, 0.0) + nbytes


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched inside it into :attr:`cost`, and the
    peak bytes of the storages allocated inside it
    (:attr:`cost.temp_bytes`)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live = 0
        self._owned: Dict[int, int] = {}     # StorageImpl address -> bytes

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------

    def _release(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def _track(self, outs: List[torch.Tensor], ins: List[torch.Tensor]
               ) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._owned:
                continue
            seen.add(key)
            self._owned[key] = st.nbytes()
            self.live += st.nbytes()
            weakref.finalize(st, self._release, key)
        if self.live > self.cost.temp_bytes:
            self.cost.temp_bytes = self.live

    # -- counting ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self._track(outs, ins)
        packet = func._overloadpacket
        name = func.name().split("::")[-1].split(".")[0]
        key = f"{func.namespace}.{name}"
        c = self.cost
        c.op_counts[key] = c.op_counts.get(key, 0) + 1
        if func.is_view or name in _FREE:
            return out
        flops, trans, dot, nbytes = self._op_cost(func, packet, name, args,
                                                  kwargs, ins, outs, out)
        c.flops += flops
        c.transcendentals += trans
        c.dot_flops += dot
        c.bytes += nbytes
        c.op_bytes[key] = c.op_bytes.get(key, 0.0) + nbytes
        return out

    def _op_cost(self, func, packet, name, args, kwargs, ins, outs, out
                 ) -> Tuple[float, float, float, float]:
        c = self.cost
        res_numel = sum(t.numel() for t in outs)
        res_bytes = sum(tensor_bytes(t) for t in outs)
        in_bytes = sum(tensor_bytes(t) for t in ins)
        mutated = [a for a, info in zip(args, func._schema.arguments)
                   if isinstance(a, torch.Tensor) and info.alias_info
                   is not None and info.alias_info.is_write]
        if func.namespace in _COLLECTIVE_NAMESPACES:
            c.collective_bytes += res_bytes
            c.collective_by_kind[name] = (c.collective_by_kind.get(name, 0.0)
                                          + res_bytes)
            c.collective_count[name] = c.collective_count.get(name, 0) + 1
            return 0.0, 0.0, 0.0, float(in_bytes + res_bytes)
        if packet in flop_registry:
            dot = float(flop_registry[packet](*args, **kwargs, out_val=out))
            return dot, 0.0, dot, float(in_bytes + res_bytes)

        def unmutated(ts):
            return [t for t in ts if all(t is not m for m in mutated)]

        if name in _FILLS:
            return 0.0, 0.0, 0.0, float(res_bytes + sum(
                tensor_bytes(t) for t in unmutated(ins)))
        if name in _INDEX_WRITES:
            src = args[2] if name == "index_put_" else (
                args[3] if len(args) > 3 else None)
            rows = tensor_bytes(src) if isinstance(src, torch.Tensor) else 0
            idx = sum(tensor_bytes(t) for t in unmutated(ins)
                      if t is not src)
            adds = "add" in name or "reduce" in name
            flops = float(src.numel()) if adds and rows else 0.0
            return flops, 0.0, 0.0, float(2 * rows + idx)
        if name in _GATHERS:
            idx = sum(tensor_bytes(t) for t in ins
                      if not t.dtype.is_floating_point
                      and t.dtype != torch.bool)
            return 0.0, 0.0, 0.0, float(2 * res_bytes + idx)
        if name in _MOVES:
            nbytes = in_bytes + res_bytes
            if mutated and name.endswith("_"):
                # a write into ``mutated``: charged as the result, not read
                nbytes -= sum(tensor_bytes(t) for t in mutated)
            self._copies(name, ins, outs, kwargs)
            return 0.0, 0.0, 0.0, float(nbytes)
        first = ins[0].numel() if ins else 0
        if name in _TRANSCENDENTAL_REDUCTIONS:
            return float(max(first, res_numel)), float(first), 0.0, \
                float(in_bytes + res_bytes)
        if name in _REDUCTIONS:
            return float(max(first, res_numel)), 0.0, 0.0, \
                float(in_bytes + res_bytes)
        trans = float(res_numel) if name in _TRANSCENDENTAL else 0.0
        return float(res_numel), trans, 0.0, float(in_bytes + res_bytes)

    def _copies(self, name, ins, outs, kwargs) -> None:
        """Layout copies and copies between devices."""
        c = self.cost
        if not ins or not outs:
            return
        src = ins[-1] if name == "copy_" else ins[0]
        dst = outs[0]
        if src.device != dst.device:
            nbytes = tensor_bytes(dst)
            c.collective_bytes += nbytes
            c.collective_by_kind["device_copy"] = (
                c.collective_by_kind.get("device_copy", 0.0) + nbytes)
            c.collective_count["device_copy"] = (
                c.collective_count.get("device_copy", 0) + 1)
            return
        if name in ("clone", "_to_copy") or (
                name == "copy_" and (src.stride() != dst.stride()
                                     or src.shape != dst.shape)):
            c.layout_copy_bytes += tensor_bytes(dst)


def counted(fn: Callable[..., Any], *args, **kwargs) -> Tuple[Any, Cost]:
    """``fn(*args, **kwargs)`` under a :class:`CostMode`: (its result, its
    :class:`Cost`)."""
    with CostMode() as mode:
        out = fn(*args, **kwargs)
    return out, mode.cost


def weighted_cost(fn: Callable[..., Any], *args, **kwargs) -> Cost:
    """The :class:`Cost` of ``fn(*args, **kwargs)`` (the reference's
    ``weighted_cost`` takes HLO text; the port runs the function)."""
    return counted(fn, *args, **kwargs)[1]
