"""The port's dry run (``repro_torch.launch.dryrun``), its cells
(``repro_torch.configs`` ``SHAPES`` / ``CELLS`` / ``input_specs``), the
production meshes and ``parallel.sharding.shard_shape``, held against the
reference.

The reference's dry run lowers each cell onto 256 or 512 virtual devices
and reads XLA's per-device argument size.  Here the reference's side is
computed without devices: each leaf's spec from its pure
``shape_aware_spec`` and its per-device shape from
``NamedSharding(AbstractMesh(...), spec).shard_shape`` (an abstract mesh
needs no devices; the reference's ``shardings_for`` needs a mesh of real
ones).  The port's ``arg_bytes`` must equal that sum for every runnable
cell and the CapsNet cells on both production meshes.  The one difference
is decode's ``pos``: the reference's is a 4-byte int32 scalar argument,
the port's a host ``int`` that takes no device memory.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.core import capsnet as ref_capsnet
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_sh
from repro_torch import configs as port_configs
from repro_torch.launch import dryrun, report, roofline, run_matrix
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel import sharding as sh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}
CAPSNET_CELLS = [(a, s) for a in port_configs.PAPER_ARCHS
                 for s in dryrun.CAPSNET_SHAPES]
ARG_CELLS = ref_configs.runnable_cells() + CAPSNET_CELLS
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int32": torch.int32}


# ---------------------------------------------------------------------------
# Shapes, cells, input specs
# ---------------------------------------------------------------------------


def test_shapes_and_cells_equal_reference():
    assert port_configs.SHAPES == ref_configs.SHAPES
    assert port_configs.ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS
    assert port_configs.CELLS == ref_configs.CELLS
    assert port_configs.runnable_cells() == ref_configs.runnable_cells()
    assert len(port_configs.runnable_cells()) == 31
    assert len(port_configs.CELLS) - 31 == 9
    assert dryrun.all_cells() == port_configs.CELLS + CAPSNET_CELLS


@pytest.mark.parametrize("arch,shape", ref_configs.CELLS)
def test_cell_status_equals_reference(arch, shape):
    assert port_configs.cell_status(arch, shape) == \
        ref_configs.cell_status(arch, shape)


@pytest.mark.parametrize("arch", ref_configs.ASSIGNED_ARCHS)
@pytest.mark.parametrize("shape", list(ref_configs.SHAPES))
def test_input_specs_and_axes_equal_reference(arch, shape):
    ref_cfg = ref_configs.get_config(arch)
    cfg = port_configs.get_config(arch)
    ref = ref_configs.input_specs(ref_cfg, shape)
    port = port_configs.input_specs(cfg, shape)
    assert set(port) == set(ref)
    for k, struct in ref.items():
        if k == "pos":
            # a host int in the port: the cache's last row
            assert struct.shape == () and struct.dtype == jnp.int32
            assert port[k] == ref_configs.SHAPES[shape]["seq"] - 1
            continue
        assert port[k].device.type == "meta"
        assert tuple(port[k].shape) == tuple(struct.shape)
        assert port[k].dtype == TORCH_DTYPES[str(struct.dtype)]
    assert port_configs.batch_axes(cfg, shape) == \
        ref_configs.batch_axes(ref_cfg, shape)


# ---------------------------------------------------------------------------
# Meshes and shard shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == MESHES[multi_pod]
    assert mesh.size == (512 if multi_pod else 256)
    assert {d.type for d in mesh.device_list} == {"meta"}
    mesh_lib.require_virtual_devices(mesh.size, mesh)
    with pytest.raises(RuntimeError, match="512 entries"):
        mesh_lib.require_virtual_devices(512, mesh_lib.make_production_mesh())
    mesh_lib.require_virtual_devices(512)


@pytest.mark.parametrize("spec", [(), ("data",), (None, "model"),
                                  (("pod", "data"), None, "model"),
                                  ("pod", ("data", "model"))])
def test_shard_shape_equals_named_sharding(spec):
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    shape = (64, 512, 256)
    ref = NamedSharding(mesh, JP(*spec)).shard_shape(shape)
    assert sh.shard_shape(shape, sh.P(*spec), MESHES[True]) == tuple(ref)


def test_shard_shape_refuses_indivisible():
    with pytest.raises(ValueError, match="does not split"):
        sh.shard_shape((10, 4), ("data",), {"data": 16})


# ---------------------------------------------------------------------------
# Argument bytes per device against the reference's shard shapes
# ---------------------------------------------------------------------------


def _ref_leaf_bytes(structs, axes_tree, rules, mesh_shape, amesh):
    leaves, treedef = jax.tree.flatten(structs)
    axes = treedef.flatten_up_to(ref_sh._mark_none(axes_tree))
    total = 0
    for s, a in zip(leaves, axes):
        spec = (JP() if a is None or isinstance(a, ref_sh._NoneAxes)
                else ref_sh.shape_aware_spec(a, s.shape, rules, mesh_shape))
        block = NamedSharding(amesh, spec).shard_shape(s.shape)
        total += math.prod(block) * jnp.dtype(s.dtype).itemsize
    return total


def _ref_arg_bytes(arch, shape, multi_pod):
    mesh_shape = MESHES[multi_pod]
    amesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    cfg = ref_configs.get_config(arch)
    if arch.startswith("capsnet"):
        rules = ref_sh.rules_for_arch(arch, kind="train")
        params = jax.eval_shape(lambda k: ref_capsnet.init(cfg, k),
                                jax.ShapeDtypeStruct((2,), jnp.uint32))
        total = _ref_leaf_bytes(params, ref_capsnet.specs(cfg), rules,
                                mesh_shape, amesh)
        b = 1024
        images = jax.ShapeDtypeStruct((b, 28, 28, 1), jnp.float32)
        labels = jax.ShapeDtypeStruct((b,), jnp.int32)
        total += _ref_leaf_bytes(images, ("batch", None, None, None), rules,
                                 mesh_shape, amesh)
        if shape == "train_1k":
            opt = jax.eval_shape(ref_adamw.init_state, params)
            total += 2 * _ref_leaf_bytes(opt["m"], ref_capsnet.specs(cfg),
                                         rules, mesh_shape, amesh) + 4
            total += _ref_leaf_bytes(labels, ("batch",), rules, mesh_shape,
                                     amesh)
        return total
    kind = ref_configs.SHAPES[shape]["kind"]
    if kind in ("prefill", "decode"):          # the "opt" variant
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    rules = ref_sh.rules_for_arch(arch, kind=kind)
    params = ref_lm.param_structs(cfg)
    axes = ref_lm.specs(cfg)
    total = _ref_leaf_bytes(params, axes, rules, mesh_shape, amesh)
    batch = ref_configs.input_specs(cfg, shape)
    total += _ref_leaf_bytes(batch, ref_configs.batch_axes(cfg, shape),
                             rules, mesh_shape, amesh)
    if kind == "train":
        opt = jax.eval_shape(ref_adamw.init_state, params)
        total += 2 * _ref_leaf_bytes(opt["m"], axes, rules, mesh_shape,
                                     amesh) + 4
    elif cfg.family != "audio":
        info = ref_configs.SHAPES[shape]
        caches = ref_lm.make_caches(cfg, info["batch"], info["seq"],
                                    as_structs=True)
        total += _ref_leaf_bytes(caches, ref_lm.cache_specs(cfg), rules,
                                 mesh_shape, amesh)
    return total


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", ARG_CELLS)
def test_arg_bytes_equal_reference_shard_shapes(arch, shape, multi_pod):
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    kind = (ref_configs.SHAPES[shape]["kind"]
            if not arch.startswith("capsnet") else "train")
    rules = sh.rules_for_arch(arch, kind=kind)
    _, args, in_sh, _ = dryrun.build_cell(arch, shape, rules, mesh, "opt")
    port = dryrun.arg_bytes(args, in_sh, mesh)
    ref = _ref_arg_bytes(arch, shape, multi_pod)
    # the reference's decode ``pos`` is a 4-byte argument; the port's is a
    # host int
    pos = 4 if (not arch.startswith("capsnet")
                and ref_configs.SHAPES[shape]["kind"] == "decode") else 0
    assert port == ref - pos


# ---------------------------------------------------------------------------
# Variants, records, the fit check, placement
# ---------------------------------------------------------------------------


def test_apply_variant():
    cfg = port_configs.get_config("deepseek-moe-16b")
    base = dryrun.apply_variant(cfg, "base")
    assert not base.loss_remat and not base.attn_scan_remat
    assert base.moe.dispatch == "scatter"
    assert not base.moe.global_decode_dispatch
    assert dryrun.apply_variant(cfg, "opt", "train") is cfg
    opt = dryrun.apply_variant(cfg, "opt", "decode")
    assert opt.param_dtype == "bfloat16" and opt.decode_impl == "chunked"
    ker = dryrun.apply_variant(cfg, "kernels", "prefill")
    assert (ker.param_dtype, ker.attn_impl, ker.decode_impl) == \
        ("bfloat16", "cuda", "cuda")
    caps = port_configs.get_config("capsnet-mnist")
    assert dryrun.apply_variant(caps, "opt", "infer") is caps
    assert dryrun.apply_variant(caps, "kernels", "infer").routing.mode == \
        "cuda"
    assert dryrun.apply_variant(caps, "kernels", "train").routing.mode == \
        "optimized"
    with pytest.raises(ValueError, match="variant"):
        dryrun.apply_variant(cfg, "fast")


REDUCED_CELLS = [
    ("llama3.2-1b", {"seq": 64, "batch": 2, "kind": "train"}, "opt"),
    ("llama3.2-1b", {"seq": 64, "batch": 2, "kind": "prefill"}, "kernels"),
    ("llama3.2-1b", {"seq": 64, "batch": 2, "kind": "decode"}, "kernels"),
    ("zamba2-1.2b", {"seq": 32, "batch": 2, "kind": "decode"}, "opt"),
    # base: the scatter dispatch counts tokens per expert on meta tensors
    *[("deepseek-moe-16b", {"seq": 32, "batch": 2, "kind": k}, "base")
      for k in ("train", "prefill", "decode")],
    ("capsnet-mnist", "infer_1k", "kernels"),
    ("capsnet-mnist", "train_1k", "kernels"),
]


def _reduced(arch):
    return port_configs.reduced(port_configs.get_config(arch))


@pytest.mark.parametrize("arch,shape,variant", REDUCED_CELLS,
                         ids=lambda x: x if isinstance(x, str) else
                         (x["kind"] if isinstance(x, dict) else None))
def test_counted_cell_runs_placed_on_cpu(arch, shape, variant):
    """A one-device cell: counted on meta (a record with the reference's
    keys), then placed on the CPU by ``place_args`` in the same trees and
    the same bytes, and run to finite outputs."""
    mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), devices=["meta"])
    kind = "train" if arch.startswith("capsnet") else shape["kind"]
    rules = sh.rules_for_arch(arch, kind=kind)
    base = _reduced(arch)
    cfg = dryrun.cell_config(arch, shape, variant, base)
    fn, args, in_sh, out_sh = dryrun.build_cell(arch, shape, rules, mesh,
                                                variant, cfg=base)
    out, cost, trace_s = dryrun.count_cell(fn, args)
    rec = dryrun.record(arch, "cell", mesh, "1x1", variant, cost, trace_s,
                        args, in_sh, out, out_sh)
    for key in ("arg_bytes_per_dev", "out_bytes_per_dev",
                "temp_bytes_per_dev", "alias_bytes_per_dev",
                "flops_per_dev", "bytes_per_dev", "transcendentals_per_dev",
                "collective_bytes_per_dev", "collective_counts",
                "collective_bytes_by_kind", "op_census",
                "reshape_copy_bytes", "trace_s"):
        assert key in rec
    assert rec["backend"] == "meta" and rec["n_chips"] == 1
    assert rec["collective_bytes_per_dev"] == 0.0
    assert rec["flops_per_dev"] > 0 and rec["temp_bytes_per_dev"] > 0
    if kind in ("prefill", "decode"):
        assert rec["alias_bytes_per_dev"] > 0          # caches in place
    if variant == "kernels":
        assert any(k.startswith("kernel.") for k in cost.op_counts)
    placed = dryrun.place_args(arch, cfg, args, "cpu", seed=0)
    leaves = list(dryrun.leaf_pairs(placed))
    assert len(leaves) == len(list(dryrun.leaf_pairs(args)))
    assert sum(t.numel() * t.element_size() for t, _ in leaves) == \
        rec["arg_bytes_per_dev"]
    res = fn(*placed)
    for t, _ in dryrun.leaf_pairs(res):
        if t.dtype.is_floating_point:
            assert torch.isfinite(t).all()


def test_mistral_decode_charges_the_decode_row():
    """mistral-large-123b's ``decode_32k`` under ``kernels`` (96 query heads
    over 8 KV heads, G 12) at full width on the production mesh, its depth
    cut to 2 layers for time: every layer's decode attention goes through
    the decode kernel's wrapper on meta, which charges row 5 once a layer
    (before the decode kernel took G > 8, the wrapper refused the cell)."""
    arch = "mistral-large-123b"
    cut = dataclasses.replace(port_configs.get_config(arch), n_layers=2)
    assert cut.n_heads // cut.n_kv_heads == 12
    mesh = mesh_lib.make_production_mesh(multi_pod=False)
    rules = sh.rules_for_arch(arch, kind="decode")
    fn, args, in_sh, out_sh = dryrun.build_cell(arch, "decode_32k", rules,
                                                mesh, "kernels", cfg=cut)
    out, cost, _ = dryrun.count_cell(fn, args)
    assert cost.op_counts["kernel.decode_attention"] == cut.n_layers
    case = {"dims": (128, 32768, 96, 8, 128), "valid": (32768,) * 128,
            "dtype": "bfloat16", "quant": False, "softmax_mode": "exact"}
    assert cost.bytes >= cut.n_layers * roofline.decode_work(case).nbytes
    logits = out[0]
    assert logits.device.type == "meta" and logits.shape[0] == 128


def test_check_fits_is_the_compile_time_oom(monkeypatch, tmp_path):
    rec = {"arch": "a", "shape": "s", "mesh": "16x16",
           "arg_bytes_per_dev": 60e9, "temp_bytes_per_dev": 30e9}
    assert not roofline.fits(rec)
    with pytest.raises(dryrun.CellDoesNotFit, match="80 GB"):
        dryrun.check_fits(rec)
    rec["temp_bytes_per_dev"] = 10e9
    dryrun.check_fits(rec)
    # a cell that does not fit is recorded on every mesh, then fails
    monkeypatch.setattr(roofline, "HBM_CAPACITY_BYTES", 1e6)
    with pytest.raises(dryrun.CellDoesNotFit, match="capsnet-mnist"):
        dryrun.run_cell_meshes("capsnet-mnist", "infer_1k", [False, True],
                               out_dir=str(tmp_path), variant="opt")
    assert len(os.listdir(tmp_path)) == 2
    recs = roofline.load_records(str(tmp_path))
    assert [r["fits"] for r in recs] == [False, False]
    assert "**no**" in report.dryrun_table(recs)


def test_multi_mesh_counts_once():
    """``run_cell_meshes`` counts the step once and records each mesh:
    the same flops over the chips, each mesh's own argument bytes."""
    recs = dryrun.run_cell_meshes("capsnet-mnist", "infer_1k",
                                  [False, True], variant="opt")
    a, b = recs
    assert (a["mesh"], b["mesh"]) == ("16x16", "2x16x16")
    assert a["flops_per_dev"] == pytest.approx(2 * b["flops_per_dev"])
    assert a["trace_s"] == b["trace_s"]
    assert a["arg_bytes_per_dev"] == dryrun.arg_bytes(
        *_capsnet_args(False))
    assert b["arg_bytes_per_dev"] == dryrun.arg_bytes(*_capsnet_args(True))


def _capsnet_args(multi_pod):
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    rules = sh.rules_for_arch("capsnet-mnist", kind="train")
    _, args, in_sh, _ = dryrun.build_cell("capsnet-mnist", "infer_1k",
                                          rules, mesh, "opt")
    return args, in_sh, mesh


# ---------------------------------------------------------------------------
# The command lines
# ---------------------------------------------------------------------------


def _run(*argv, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_dryrun_and_report_command_lines(tmp_path):
    out = tmp_path / "dryrun"
    r = _run("repro_torch.launch.dryrun", "--arch", "capsnet-mnist",
             "--shape", "infer_1k", "--mesh", "single", "--out", str(out),
             "--hlo-dir", str(tmp_path / "ops"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[ ok ] capsnet-mnist" in r.stdout
    with open(out / "capsnet-mnist__infer_1k__16x16.json") as f:
        rec = json.load(f)
    assert rec["backend"] == "meta" and rec["n_chips"] == 256
    with open(tmp_path / "ops" / "capsnet-mnist__infer_1k__16x16.ops.json"
              ) as f:
        assert json.load(f)["op_counts"]["aten.convolution"] == 2
    r = _run("repro_torch.launch.report", "--dir", str(out))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "### Dry-run matrix" in r.stdout
    assert "### Roofline" in r.stdout
    assert "| capsnet-mnist | infer_1k | 16x16 |" in r.stdout
    r = _run("repro_torch.launch.roofline", "--dir", str(out), "--markdown")
    assert r.returncode == 0 and "**" in r.stdout
    rows = [roofline.analyze(x) for x in roofline.load_records(str(out))]
    assert report.dryrun_table([rec]).count("\n") == 2
    assert rows[0]["model_flops"] == roofline.model_flops("capsnet-mnist",
                                                          "infer_1k")


def test_run_matrix_one_subprocess_per_cell(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.path.join(ROOT, "src"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cells = [("capsnet-mnist", "infer_1k"),
             ("hubert-xlarge", "decode_32k")]          # skipped, as the
    failures = run_matrix.run_matrix(cells, str(tmp_path), ["single"],
                                     timeout=240)      # reference skips it
    printed = capsys.readouterr().out
    assert failures == []
    assert "[skip] hubert-xlarge" in printed
    assert "[ ok ] capsnet-mnist" in printed
    assert os.listdir(tmp_path) == ["capsnet-mnist__infer_1k__16x16.json"]
    assert len(run_matrix.matrix_cells()) == 44
