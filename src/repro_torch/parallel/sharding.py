"""Logical-axis sharding: map named tensor axes onto mesh axes.

The port's copy of ``repro/parallel/sharding.py``, the same policy over the
same rule tables.  Every parameter, cache leaf and activation carries a
tuple of *logical* axis names (``lm.cache_specs``, the ``axes`` of
``lm.specs``' ``LeafSpec``\\ s); a rule table maps each name onto mesh axis
names, and :func:`shape_aware_spec` turns a leaf's names and shape into a
partition spec: which mesh axes split which dimension.

What differs from the reference, and why:

  * A partition spec is :class:`P`, a plain tuple with the reference's
    canonical form (trailing ``None`` entries stripped), and a sharding is
    :class:`Sharding`, the pair ``(mesh, spec)``.  There is no XLA to hand
    them to: the engines that shard (``serving.ServeEngine`` and
    ``serving.CapsuleEngine`` under a ``ShardedScheduler``) read them to
    decide which device holds which block of the slot axis.
  * There is no ``shard_constraint``.  The reference's is
    ``with_sharding_constraint`` under an ambient mesh, an instruction to
    XLA's partitioner inside a jitted function; eager PyTorch has no
    partitioner to instruct.  Data-parallel serving, the one sharded path
    the port runs, needs none: parameters are replicated and each device
    owns its slots.
  * The ``model``-axis (tensor-parallel) placements are computed exactly as
    the reference computes them, and held equal to its in the tests, but no
    engine of the port runs them (nor does the reference's: its runnable
    ``ShardedScheduler`` is pure data parallelism, and only its ``dryrun``
    lowers the TP placements).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, visible_devices
from repro_torch.models.common import LeafSpec

MeshAxes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per leading dimension, each ``None``
    (replicated), a mesh axis name, or a tuple of names (the dimension is
    split over their product).  Trailing ``None`` entries are stripped, the
    reference's canonical form, so ``P("data", None) == P("data")``."""

    def __new__(cls, *axes: MeshAxes) -> "P":
        axes = list(axes)
        while axes and axes[-1] is None:
            axes.pop()
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Sharding(NamedTuple):
    """Where a leaf lives: ``spec`` over ``mesh``."""

    mesh: Mesh
    spec: P


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis names to mesh axes.

    ``rules`` maps a logical name to a mesh axis name, a tuple of mesh axis
    names (the dim is sharded over their product), or None (replicated).
    Mesh axes that do not exist on the actual mesh are silently dropped so a
    single rule table serves single-pod and multi-pod meshes.
    """

    rules: Mapping[str, MeshAxes]

    def lookup(self, name: Optional[str], mesh_axis_names: Sequence[str]
               ) -> MeshAxes:
        if name is None:
            return None
        axes = self.rules.get(name, None)
        if axes is None:
            return None
        if isinstance(axes, str):
            axes = (axes,)
        present = tuple(a for a in axes if a in mesh_axis_names)
        if not present:
            return None
        if len(present) == 1:
            return present[0]
        return present

    def with_overrides(self, **overrides: MeshAxes) -> "AxisRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return AxisRules(merged)


# The default production rule table (the reference's): ``batch`` spans the
# cross-pod axis and the data axis; weight ``embed`` dims are FSDP-sharded
# over ``data``; model-parallel structures go to ``model``.
DEFAULT_RULES = AxisRules(
    {
        # activations
        "batch": ("pod", "data"),
        "seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_kv_heads": "model",
        "act_expert": "model",
        # weights
        "embed": "data",          # FSDP axis
        "embed_tp": "model",
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "qkv_dim": None,
        "head_dim": None,
        "vocab": "model",
        "expert": "model",
        "expert_mlp": None,
        "state": None,
        "conv_in": None,
        "conv_out": "model",
        "caps_in": "data",
        "caps_out": "model",
        "caps_dim": None,
        "layers": None,           # stacked layer axis: never sharded
        # SSM / xLSTM
        "mamba_inner": "model",
        "mamba_conv": "model",
        "mlstm_up": "model",
        "mlstm_inner": "model",
        "slstm_gates": None,
        "head_dim_v": None,
        # KV cache: batch claims data first; when batch cannot shard,
        # kv_seq claims data; when kv_heads cannot, kv_head_dim claims model
        "kv_seq": "data",
        "kv_head_dim": "model",
    }
)

# CPU / single-device rules: everything replicated.
REPLICATED_RULES = AxisRules({})

# Small models are not tensor-parallelised (the reference's §Perf H-A1):
# d_model <= 2048 -> pure DP + FSDP (batch also claims the model axis);
# MoE keeps expert -> model.
_NO_TP_OVERRIDES = dict(
    batch=("pod", "data", "model"),
    mlp=None, heads=None, kv_heads=None, vocab=None,
    act_heads=None, act_mlp=None, act_kv_heads=None,
    mamba_inner=None, mamba_conv=None,
    mlstm_up=None, mlstm_inner=None, head_dim_v=None,
    conv_out=None,
    kv_head_dim=None,
)

_NO_TP_ARCHS = ("xlstm-1.3b", "zamba2-1.2b", "qwen3-1.7b", "llama3.2-1b",
                "deepseek-moe-16b", "hubert-xlarge")


def rules_for_arch(arch_id: str, base: AxisRules = DEFAULT_RULES,
                   kind: str = "train") -> AxisRules:
    """Per-architecture, per-step-kind overrides of the default rule table
    (``kind="decode"`` keeps the TP/EP rules for every arch: decode wants
    the weights stationary)."""
    if kind != "decode" and arch_id in _NO_TP_ARCHS:
        rules = base.with_overrides(**_NO_TP_OVERRIDES)
        if arch_id == "deepseek-moe-16b":
            # EP stays: experts across model
            rules = rules.with_overrides(expert="model", act_expert="model")
        return rules
    return base


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: AxisRules,
                    mesh_axis_names: Sequence[str]) -> P:
    """A tuple of logical axis names -> a partition spec; each mesh axis is
    used at most once (the first logical dim wins)."""
    used: set = set()
    out = []
    for name in logical_axes:
        axes = rules.lookup(name, mesh_axis_names)
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        tup = tuple(a for a in tup if a not in used)
        if not tup:
            out.append(None)
            continue
        used.update(tup)
        out.append(tup[0] if len(tup) == 1 else tup)
    return P(*out)


def _axes_of(leaf: Any) -> Any:
    """A ``LeafSpec`` stands for its logical axes."""
    return leaf.axes if isinstance(leaf, LeafSpec) else leaf


def _is_axes_leaf(x: Any) -> bool:
    return x is None or isinstance(x, (tuple, LeafSpec))


def _map_axes(fn, tree: Any) -> Any:
    """``fn`` over a tree of dicts and lists whose leaves are axis tuples,
    partition specs, ``LeafSpec``\\ s or ``None``."""
    if _is_axes_leaf(tree):
        return fn(_axes_of(tree))
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_axes(fn, v) for v in tree]
    raise TypeError(f"not an axes tree leaf: {tree!r}")


def spec_tree_to_pspecs(spec_tree: Any, rules: AxisRules,
                        mesh_axis_names: Sequence[str]) -> Any:
    """A tree of logical-axis tuples -> a tree of partition specs (a ``P``
    passes through; ``None`` is replicated)."""

    def one(axes):
        if isinstance(axes, P):
            return axes
        if axes is None:
            return P()
        return logical_to_spec(axes, rules, mesh_axis_names)

    return _map_axes(one, spec_tree)


def spec_tree_to_shardings(spec_tree: Any, mesh: Mesh,
                           rules: AxisRules) -> Any:
    """A tree of logical-axis tuples -> a tree of :class:`Sharding`."""
    return _map_axes(lambda s: Sharding(mesh, s),
                     spec_tree_to_pspecs(spec_tree, rules, mesh.axis_names))


def shape_aware_spec(logical_axes: Sequence[Optional[str]],
                     shape: Sequence[int], rules: AxisRules,
                     mesh_shape: Mapping[str, int]) -> P:
    """The production policy, in one pass: for each dim, the rule-mapped
    mesh axes are kept only if (a) no earlier dim of this tensor claimed
    them and (b) the dim's size is divisible by the axes' product (the
    longest such prefix).  An axis freed by (b) on one dim stays claimable
    by a later dim (a decode KV cache with batch 1 frees ``data`` for
    ``kv_seq``)."""
    names = list(mesh_shape.keys())
    used: set = set()
    out = []
    for d, name in enumerate(tuple(logical_axes)):
        axes = rules.lookup(name, names)
        if axes is None:
            out.append(None)
            continue
        tup = (axes,) if isinstance(axes, str) else tuple(axes)
        tup = tuple(a for a in tup if a not in used)
        while tup:
            total = 1
            for a in tup:
                total *= mesh_shape[a]
            if total > 0 and shape[d] % total == 0:
                break
            tup = tup[:-1]
        if not tup:
            out.append(None)
            continue
        used.update(tup)
        out.append(tup[0] if len(tup) == 1 else tup)
    return P(*out)


def _walk_pair(fn, structs: Any, axes: Any) -> Any:
    """``fn(struct, axes)`` over ``structs``' leaves (tensors or
    ``LeafSpec``\\ s: anything with a ``shape``), ``axes`` walked alongside;
    an ``axes`` leaf of ``None`` covers a whole subtree (replicated)."""
    if isinstance(structs, dict):
        return {k: _walk_pair(fn, v, None if axes is None else axes[k])
                for k, v in structs.items()}
    if isinstance(structs, list):
        return [_walk_pair(fn, v, None if axes is None else axes[i])
                for i, v in enumerate(structs)]
    return fn(structs, _axes_of(axes))


def shardings_for(structs: Any, axes_tree: Any, rules: AxisRules,
                  mesh: Mesh) -> Any:
    """A :class:`Sharding` for every leaf of ``structs`` (tensors or
    ``LeafSpec``\\ s), with the shape-aware policy; an ``axes_tree`` leaf of
    ``None`` is replicated and a ``P`` is taken as it is."""
    mesh_shape = mesh.shape

    def one(struct, axes):
        if axes is None:
            return Sharding(mesh, P())
        if isinstance(axes, P):
            return Sharding(mesh, axes)
        return Sharding(mesh, shape_aware_spec(axes, tuple(struct.shape),
                                               rules, mesh_shape))

    return _walk_pair(one, structs, axes_tree)


def shard_shape(shape: Sequence[int], spec: Sequence[MeshAxes],
                mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    """The shape of one device's block of a leaf of global ``shape`` under
    partition spec ``spec`` on a mesh of axis sizes ``mesh_shape`` (the
    twin of ``NamedSharding.shard_shape``): each dimension divided by the
    product of the mesh axes its entry names.  Raises ``ValueError`` when
    a dimension does not divide (the shape-aware policy never asks for
    that)."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} is longer than shape {tuple(shape)}")
    out = []
    for d, dim in enumerate(shape):
        axes = spec[d] if d < len(spec) else None
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        n = 1
        for a in axes:
            n *= mesh_shape[a]
        if dim % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {axes} ({n} blocks)")
        out.append(dim // n)
    return tuple(out)


def replicated_shardings(tree: Any, mesh: Mesh) -> Any:
    """A replicated :class:`Sharding` for every leaf of ``tree``: the
    placement of state that crosses engines (a handoff's rows) before the
    target scatters it into the slots it owns."""
    sharding = Sharding(mesh, P())
    return _walk_pair(lambda _s, _a: sharding, tree, None)


def divisible_or_none(dim: int, axes: MeshAxes, mesh: Mesh) -> bool:
    """Whether ``dim`` splits evenly over ``axes`` of ``mesh``."""
    if axes is None:
        return True
    tup = (axes,) if isinstance(axes, str) else axes
    total = 1
    for a in tup:
        total *= mesh.shape[a]
    return dim % total == 0


def disjoint_submeshes(n: int, axis_name: str = "data",
                       devices: Optional[Sequence[Any]] = None
                       ) -> Tuple[Mesh, ...]:
    """``n`` one-axis meshes over disjoint device groups (default: every
    visible card; raises when there is none): the prefill engine and each
    decode engine of a disaggregated pool get their own, so a handoff
    crosses devices.  With ``d`` devices each gets ``d // n`` of them (any
    remainder stays unused); with fewer devices than groups each mesh has
    one device and the devices are reused round-robin — distinct meshes,
    degenerate placement, as in the reference."""
    if n <= 0:
        raise ValueError(f"need a positive submesh count, got {n}")
    devs = ([torch.device(d) for d in devices] if devices is not None
            else visible_devices())
    if not devs:
        raise ValueError("no devices to build submeshes from")
    per = max(len(devs) // n, 1)
    groups = [[devs[(i * per + j) % len(devs)] for j in range(per)]
              for i in range(n)]
    return tuple(Mesh(_object_array(g), (axis_name,)) for g in groups)


def _object_array(items: Sequence[Any]) -> np.ndarray:
    arr = np.empty((len(items),), dtype=object)
    arr[:] = list(items)
    return arr


def batch_devices(mesh: Mesh, rules: AxisRules = DEFAULT_RULES
                  ) -> Tuple[torch.device, ...]:
    """One device per block of the ``batch`` axis: the mesh's entries along
    the axes ``batch`` maps to (in the mesh's order), at index 0 of every
    other axis (the block's replicas there hold the same slots; the port
    runs one of them).  A mesh whose axes ``batch`` does not map to gives
    one block on its first device."""
    axes = rules.lookup("batch", mesh.axis_names)
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    names = list(mesh.axis_names)
    order = [names.index(a) for a in axes] + [
        i for i, a in enumerate(names) if a not in axes]
    arr = np.transpose(mesh.devices, order)
    n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    return tuple(arr.reshape(n, -1)[:, 0])
