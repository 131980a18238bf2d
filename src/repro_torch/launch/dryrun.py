"""Dry run: count every (architecture x input shape x mesh) cell on the meta
device and record its memory, cost and op census (the port's twin of
``repro/launch/dryrun.py``).

The reference lowers and compiles each cell for a 256- or 512-chip virtual
TPU mesh and reads XLA's analyses.  The port has no compiler.  Its analogue:

  * the mesh is the production mesh with every entry ``torch.device("meta")``
    (a port mesh may repeat a device), so nothing needs 512 devices;
  * the cell's step (a train step through ``autograd.grad`` and AdamW, a
    prefill or a decode step, the CapsNet train or inference step) runs on
    meta tensors at the full published shapes: nothing is allocated;
  * :mod:`repro_torch.launch.op_cost` counts every aten op as it dispatches:
    FLOPs, transcendentals and bytes (eager PyTorch's own memory traffic)
    and the peak bytes of live temporaries;
  * the argument bytes per device are exact, from the port's sharding
    policy (``parallel.sharding.shard_shape`` of each leaf's spec);
  * FLOPs, bytes and temporaries per device are the whole step's over the
    mesh's size: an assumption of even partition (the port has no
    partitioner to say otherwise), and so no collective is counted;
  * a cell fails, as a compile-time OOM fails in the reference, when its
    argument plus temporary bytes per device exceed the card's memory
    (``roofline.HBM_CAPACITY_BYTES``).

Decode's ``pos`` is a host ``int`` (``configs.input_specs``): the last row of
the cell's cache.  No card is needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single --out experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Results (one JSON per cell) feed ``launch/roofline.py`` and
``launch/report.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import configs as cfg_lib
from repro_torch.core import capsnet as capsnet_lib
from repro_torch.deploy.registry import RoutingSpec
from repro_torch.launch import op_analysis, op_cost, roofline
from repro_torch.launch.mesh import (make_production_mesh, mesh_context,
                                     require_virtual_devices)
from repro_torch.models import common, lm
from repro_torch.models.common import LMConfig, tree_map
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.parallel import sharding as shard_lib
from repro_torch.training.trainer import TrainerConfig, make_train_step

COLLECTIVES_NOTE = ("none counted: the port has no partitioner, and a meta "
                    "dry run emits no collective (the reference's come from "
                    "XLA's SPMD partitioner)")
PARTITION_NOTE = ("even: flops, bytes and temporaries per device are the "
                  "whole step's over n_chips; argument bytes are exact")


class CellDoesNotFit(RuntimeError):
    """A cell's argument plus temporary bytes per device exceed the card's
    memory (the reference's compile-time OOM)."""


# ---------------------------------------------------------------------------
# Cell construction: (fn, arg structs, arg shardings, out shardings)
# ---------------------------------------------------------------------------


def _structs(specs: Any, device: Any = "meta") -> Any:
    """Empty tensors of a ``LeafSpec`` tree's shapes and types."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device), specs)


def _step_sharding(mesh) -> shard_lib.Sharding:
    return shard_lib.Sharding(mesh, shard_lib.P())


def _train_cell(cfg: LMConfig, shape, rules, mesh):
    specs = lm.specs(cfg)
    params = _structs(specs)
    opt = adamw.init_state(params)
    batch = cfg_lib.input_specs(cfg, shape)

    params_sh = shard_lib.shardings_for(params, specs, rules, mesh)
    opt_sh = {"m": params_sh, "v": params_sh, "step": _step_sharding(mesh)}
    batch_sh = shard_lib.shardings_for(
        batch, cfg_lib.batch_axes(cfg, shape), rules, mesh)
    step = make_train_step(lambda p, b: lm.loss_fn(p, cfg, b),
                           TrainerConfig(optim=AdamWConfig()), donate=False)
    return (step, (params, opt, batch), (params_sh, opt_sh, batch_sh),
            (params_sh, opt_sh, None))


def _inference_args(cfg: LMConfig, shape, rules, mesh):
    info = cfg_lib.shape_info(shape)
    specs = lm.specs(cfg)
    params = _structs(specs)
    batch = cfg_lib.input_specs(cfg, shape)
    params_sh = shard_lib.shardings_for(params, specs, rules, mesh)
    batch_sh = shard_lib.shardings_for(
        batch, cfg_lib.batch_axes(cfg, shape), rules, mesh)
    caches = lm.make_caches(cfg, info["batch"], info["seq"], device="meta")
    caches_sh = (None if caches is None
                 else lm.cache_shardings(cfg, caches, mesh, rules))
    return params, batch, caches, params_sh, batch_sh, caches_sh


def _prefill_cell(cfg: LMConfig, shape, rules, mesh):
    params, batch, caches, params_sh, batch_sh, caches_sh = \
        _inference_args(cfg, shape, rules, mesh)
    if cfg.family == "audio":
        def enc(params, batch):
            x, _, _ = lm.forward(params, cfg, batch)
            return common.unembed(params["embed"], cfg, x[:, -1:, :])
        return enc, (params, batch), (params_sh, batch_sh), None

    def prefill(params, batch, caches):
        return lm.prefill_step(params, cfg, batch, caches)

    return (prefill, (params, batch, caches),
            (params_sh, batch_sh, caches_sh), (None, caches_sh))


def _decode_cell(cfg: LMConfig, shape, rules, mesh):
    params, batch, caches, params_sh, batch_sh, caches_sh = \
        _inference_args(cfg, shape, rules, mesh)

    def decode(params, batch, caches):
        return lm.decode_step(params, cfg, batch, caches)

    return (decode, (params, batch, caches),
            (params_sh, batch_sh, caches_sh), (None, caches_sh))


CAPSNET_SHAPES = ["train_1k", "infer_1k"]


def _capsnet_cell(cfg, shape: str, rules, mesh):
    b = roofline.CAPSNET_BATCH[shape]
    specs = capsnet_lib.specs(cfg)
    params = _structs(specs)
    params_sh = shard_lib.shardings_for(params, specs, rules, mesh)
    images = torch.empty((b, cfg.image_hw, cfg.image_hw, cfg.in_channels),
                         dtype=torch.float32, device="meta")
    labels = torch.empty((b,), dtype=torch.int32, device="meta")
    im_sh = shard_lib.shardings_for(images, ("batch", None, None, None),
                                    rules, mesh)
    lb_sh = shard_lib.shardings_for(labels, ("batch",), rules, mesh)

    if shape == "train_1k":
        opt = adamw.init_state(params)
        opt_sh = {"m": params_sh, "v": params_sh,
                  "step": _step_sharding(mesh)}
        train = make_train_step(
            lambda p, batch: capsnet_lib.loss_fn(p, cfg, *batch),
            TrainerConfig(optim=AdamWConfig()), donate=False)

        def step(params, opt_state, images, labels):
            return train(params, opt_state, (images, labels))[:2]

        return (step, (params, opt, images, labels),
                (params_sh, opt_sh, im_sh, lb_sh), (params_sh, opt_sh))

    def infer(params, images):
        with torch.no_grad():
            lengths, _ = capsnet_lib.forward(params, cfg, images)
        return lengths

    return infer, (params, images), (params_sh, im_sh), None


def arch_is_capsnet(cfg) -> bool:
    return not isinstance(cfg, LMConfig)


VARIANTS = ("base", "opt", "kernels")


def apply_variant(cfg, variant: str, kind: str = "train"):
    """Config-level bundles, the reference's names.  ``opt`` (the shipped
    default): bf16 parameters for the inference kinds.  ``base``: the
    reference's pre-hillclimb baseline (no attention-scan or loss remat,
    scatter MoE dispatch, per-row decode dispatch).  ``kernels`` (the
    port's own): ``opt`` with the step through the hand-written kernels'
    wrappers where the port serves through them: prefill attention and
    decode attention (``attn_impl`` / ``decode_impl`` ``"cuda"``), CapsNet
    inference routing ``cuda`` and CapsNet training routing ``optimized``
    (row 2 and its backward).  A CapsNet's ``kind`` is ``"train"`` or
    ``"infer"``."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if arch_is_capsnet(cfg):
        if variant != "kernels":
            return cfg
        spec = (RoutingSpec.optimized() if kind == "train"
                else RoutingSpec.cuda())
        return dataclasses.replace(cfg, routing=spec)
    if variant == "base":
        kw: Dict[str, Any] = {"attn_scan_remat": False, "loss_remat": False}
        if getattr(cfg, "moe", None) is not None:
            kw["moe"] = dataclasses.replace(
                cfg.moe, dispatch="scatter", global_decode_dispatch=False)
        return dataclasses.replace(cfg, **kw)
    kw = {}
    if kind in ("prefill", "decode"):
        kw["param_dtype"] = "bfloat16"
        if variant == "kernels":
            kw["attn_impl"] = "cuda"
            kw["decode_impl"] = "cuda"
    return dataclasses.replace(cfg, **kw) if kw else cfg


def cell_kind(arch: str, shape) -> str:
    """``train``, ``prefill`` or ``decode`` (an LM), ``train`` or
    ``infer`` (a CapsNet)."""
    if arch.startswith("capsnet"):
        return "train" if shape == "train_1k" else "infer"
    return cfg_lib.shape_info(shape)["kind"]


def cell_config(arch: str, shape, variant: str = "base", cfg: Any = None):
    """The config a cell's step runs: ``cfg`` (default: the arch's
    published one) under ``variant``."""
    cfg = cfg if cfg is not None else cfg_lib.get_config(arch)
    return apply_variant(cfg, variant, cell_kind(arch, shape))


def build_cell(arch: str, shape, rules, mesh, variant: str = "base",
               cfg: Any = None):
    """(fn, args, arg shardings, out shardings) of a cell.  ``shape`` is a
    name of ``configs.SHAPES`` (or a CapsNet shape) or a ``{"seq",
    "batch", "kind"}`` mapping; ``cfg`` replaces the arch's published
    config (a cell cut to one card)."""
    cfg = cell_config(arch, shape, variant, cfg)
    if arch.startswith("capsnet"):
        return _capsnet_cell(cfg, shape, rules, mesh)
    kind = cell_kind(arch, shape)
    if kind == "train":
        return _train_cell(cfg, shape, rules, mesh)
    if kind == "prefill":
        return _prefill_cell(cfg, shape, rules, mesh)
    return _decode_cell(cfg, shape, rules, mesh)


def place_args(arch: str, cfg, args, device: Any, seed: int = 0):
    """A cell's arguments (the meta ones :func:`build_cell` gives) made
    real on ``device``, in the same trees: parameters from the model's own
    init drawn from ``seed`` on the device, AdamW state from
    ``adamw.init_state``, token and label ids uniform over the vocabulary
    (or the classes), float inputs standard normal, caches zeros; a host
    ``int`` (decode's ``pos``) stays as it is."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    lib = capsnet_lib if arch.startswith("capsnet") else lm
    params = lib.init(cfg, gen, device)
    high = cfg.n_classes if arch.startswith("capsnet") else cfg.vocab

    def fill(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype.is_floating_point:
            return torch.randn(x.shape, generator=gen, device=device
                               ).to(x.dtype)
        return torch.randint(0, high, x.shape, generator=gen,
                             device=device).to(x.dtype)

    def zeros(x):
        return torch.zeros(x.shape, dtype=x.dtype, device=device)

    out = [params]
    for a in args[1:]:
        if isinstance(a, dict) and set(a) == {"m", "v", "step"}:
            out.append(adamw.init_state(params))
        elif isinstance(a, dict) and ("kv" in a or "units" in a
                                      or "mamba" in a):
            out.append(tree_map(zeros, a))               # caches
        elif isinstance(a, dict):
            out.append({k: fill(v) for k, v in a.items()})
        else:
            out.append(fill(a))
    return tuple(out)


# ---------------------------------------------------------------------------
# Bytes per device
# ---------------------------------------------------------------------------


def leaf_pairs(tree: Any, shardings: Any = None):
    """(leaf, sharding) over a tree of tensors (dicts, lists, tuples) and
    its tree of shardings; ``None`` shardings replicate a subtree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_pairs(v, None if shardings is None else shardings[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_pairs(v, None if shardings is None
                              else shardings[i])
    elif isinstance(tree, torch.Tensor):
        yield tree, shardings


def bytes_per_device(tree: Any, shardings: Any, mesh) -> int:
    """Bytes of one device's blocks of every tensor leaf of ``tree`` (host
    scalars hold none): each leaf's ``shard_shape`` under its sharding, a
    leaf without one replicated."""
    total = 0
    for leaf, sh in leaf_pairs(tree, shardings):
        spec = sh.spec if sh is not None else shard_lib.P()
        total += (math.prod(shard_lib.shard_shape(leaf.shape, spec,
                                                  mesh.shape))
                  * leaf.element_size())
    return total


def arg_bytes(args, in_shardings, mesh) -> int:
    return sum(bytes_per_device(a, s, mesh)
               for a, s in zip(args, in_shardings))


def _storage_keys(tree: Any) -> set:
    return {t.untyped_storage()._cdata for t, _ in leaf_pairs(tree, None)}


def out_alias_bytes(out, out_shardings, args, in_shardings, mesh
                    ) -> Tuple[int, int]:
    """(bytes of the outputs a step makes, bytes of those that are its
    arguments updated in place: the caches), per device."""
    argkeys = _storage_keys(args)
    outs = list(leaf_pairs(out, out_shardings))
    fresh = [(t, s) for t, s in outs
             if t.untyped_storage()._cdata not in argkeys]
    alias = [(t, s) for t, s in outs
             if t.untyped_storage()._cdata in argkeys]

    def total(pairs):
        return sum(bytes_per_device(t, s, mesh) for t, s in pairs)

    return total(fresh), total(alias)


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def count_cell(fn, args) -> Tuple[Any, op_cost.Cost, float]:
    """(the step's output, its :class:`op_cost.Cost`, seconds) of one call
    of a cell's step on its (meta) arguments."""
    t0 = time.time()
    out, cost = op_cost.counted(fn, *args)
    return out, cost, time.time() - t0


def record(arch: str, shape_name: str, mesh, mesh_name: str, variant: str,
           cost: op_cost.Cost, trace_s: float, args, in_sh, out, out_sh
           ) -> Dict[str, Any]:
    """The reference's record keys wherever the port has the quantity."""
    n = mesh.size
    out_b, alias_b = out_alias_bytes(out, out_sh, args, in_sh, mesh)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": n,
        "backend": "meta",
        "variant": variant,
        "trace_s": round(trace_s, 2),
        "n_ops": int(sum(v for k, v in cost.op_counts.items())),
        # exact per device, from the shardings
        "arg_bytes_per_dev": int(arg_bytes(args, in_sh, mesh)),
        "out_bytes_per_dev": int(out_b),
        "alias_bytes_per_dev": int(alias_b),
        # whole step over n_chips (even partition)
        "temp_bytes_per_dev": int(cost.temp_bytes // n),
        "flops_per_dev": cost.flops / n,
        "dot_flops_per_dev": cost.dot_flops / n,
        "bytes_per_dev": cost.bytes / n,
        "transcendentals_per_dev": cost.transcendentals / n,
        "collective_bytes_per_dev": cost.collective_bytes / n,
        "collective_counts": {k: float(v)
                              for k, v in cost.collective_count.items()},
        "collective_bytes_by_kind": {
            k: float(v) for k, v in cost.collective_by_kind.items()},
        "collectives": COLLECTIVES_NOTE,
        "partition": PARTITION_NOTE,
        "op_census": op_analysis.op_census(cost),
        "reshape_copy_bytes": op_analysis.reshape_transpose_bytes(cost) / n,
    }
    rec["fits"] = roofline.fits(rec)
    return rec


def check_fits(rec: Dict[str, Any]) -> None:
    if not roofline.fits(rec):
        need = rec["arg_bytes_per_dev"] + rec["temp_bytes_per_dev"]
        raise CellDoesNotFit(
            f"{rec['arch']} {rec['shape']} on {rec['mesh']}: "
            f"{need / 1e9:.2f} GB per device (arguments "
            f"{rec['arg_bytes_per_dev'] / 1e9:.2f} GB + temporaries "
            f"{rec['temp_bytes_per_dev'] / 1e9:.2f} GB) > the "
            f"card's {roofline.HBM_CAPACITY_BYTES / 1e9:.0f} GB")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell_meshes(arch: str, shape: str, multi_pods,
                    out_dir: Optional[str] = None,
                    hlo_dir: Optional[str] = None,
                    variant: str = "base") -> list:
    """Count one cell once and record it on each production mesh of
    ``multi_pods`` (the count does not depend on the mesh; the bytes per
    device do), writing each record to ``out_dir``; ``hlo_dir`` takes the
    full op tally (the port's stand-in for the reference's HLO text).
    A record says whether the cell fits a card (``fits``); after writing
    every record, :class:`CellDoesNotFit` is raised for the meshes where it
    does not (the reference's compile-time OOM, which leaves no record)."""
    kind = (cfg_lib.SHAPES[shape]["kind"]
            if not arch.startswith("capsnet") else "train")
    rules = shard_lib.rules_for_arch(arch, kind=kind)
    counted = None
    recs = []
    for multi_pod in multi_pods:
        mesh = make_production_mesh(multi_pod=multi_pod)
        with mesh_context(mesh):
            fn, args, in_sh, out_sh = build_cell(arch, shape, rules, mesh,
                                                 variant)
            if counted is None:
                counted = (args,) + count_cell(fn, args)
        c_args, out, cost, trace_s = counted
        rec = record(arch, shape, mesh, mesh_name(multi_pod), variant, cost,
                     trace_s, c_args, in_sh, out, out_sh)
        tag = f"{arch}__{shape}__{rec['mesh']}"
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
                json.dump(rec, f, indent=1)
        if hlo_dir:
            os.makedirs(hlo_dir, exist_ok=True)
            with open(os.path.join(hlo_dir, f"{tag}.ops.json"), "w") as f:
                json.dump({"op_counts": cost.op_counts,
                           "op_bytes": cost.op_bytes}, f, indent=1)
        recs.append(rec)
    for rec in recs:
        check_fits(rec)
    return recs


def run_cell(arch: str, shape: str, multi_pod: bool,
             out_dir: Optional[str] = None,
             hlo_dir: Optional[str] = None,
             variant: str = "base") -> Dict[str, Any]:
    """Count one cell on one production mesh (:func:`run_cell_meshes`)."""
    return run_cell_meshes(arch, shape, [multi_pod], out_dir, hlo_dir,
                           variant)[0]


def all_cells(include_capsnet: bool = True):
    cells = list(cfg_lib.CELLS)
    if include_capsnet:
        cells += [(a, s) for a in cfg_lib.PAPER_ARCHS for s in CAPSNET_SHAPES]
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--hlo-dir", default=None,
                    help="write each cell's full op tally here")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-capsnet", action="store_true")
    ap.add_argument("--variant", choices=list(VARIANTS), default="opt")
    args = ap.parse_args(argv)

    require_virtual_devices(512)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if args.all:
        cells = all_cells(include_capsnet=not args.no_capsnet)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = []
    for arch, shape in cells:
        status = (cfg_lib.cell_status(arch, shape)
                  if not arch.startswith("capsnet") else None)
        if status:
            print(f"[skip] {arch:22s} {shape:12s} {status}", flush=True)
            continue
        todo = []
        for mp in meshes:
            fname = os.path.join(args.out or "",
                                 f"{arch}__{shape}__{mesh_name(mp)}.json")
            if args.skip_existing and args.out and os.path.exists(fname):
                print(f"[have] {arch:22s} {shape:12s} {mesh_name(mp)}",
                      flush=True)
            else:
                todo.append(mp)
        if not todo:
            continue
        try:
            recs = run_cell_meshes(arch, shape, todo, args.out,
                                   args.hlo_dir, variant=args.variant)
        except Exception as e:  # noqa: BLE001 — report every cell
            failures.append((arch, shape, repr(e)))
            print(f"[FAIL] {arch:22s} {shape:12s} {e!r}", flush=True)
            traceback.print_exc(limit=3)
            continue
        for rec in recs:
            print(f"[ ok ] {arch:22s} {shape:12s} {rec['mesh']:8s} "
                  f"flops/dev={rec['flops_per_dev']:.3e} "
                  f"bytes/dev={rec['bytes_per_dev']:.3e} "
                  f"args={rec['arg_bytes_per_dev'] / 2**30:.2f}GiB "
                  f"temp={rec['temp_bytes_per_dev'] / 2**30:.2f}GiB "
                  f"trace={rec['trace_s']:.1f}s", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        raise SystemExit(1)
    print("\nAll dry-run cells counted.")


if __name__ == "__main__":
    main()
