"""The port's sharding policy (``repro_torch.parallel.sharding``), meshes
(``repro_torch.launch.mesh``), ``adamw.state_specs`` and
``lm.cache_shardings``, held against the reference's functions on the same
inputs.

Every case of ``tests/test_sharding.py``'s policy tests is held equal to the
reference function's output and to the literal that test expects; then
``rules_for_arch`` for every arch, ``logical_to_spec`` over every arch's
parameter axes, ``shape_aware_spec`` of every family's cache axes on three
mesh shapes, ``disjoint_submeshes``' device groups on 1, 3 and 8 devices,
and the port's own mesh class on the CPU (a mesh may repeat a device).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro.parallel import sharding as ref_sh
from repro_torch import configs as port_configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm as port_lm
from repro_torch.optim import adamw as port_adamw
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P

torch.set_num_threads(1)

MESH_2D = {"data": 16, "model": 16}
MESH_3D = {"pod": 2, "data": 16, "model": 16}
CACHE_MESHES = ({"data": 2}, {"data": 2, "model": 2}, MESH_3D)
LM_ARCHS = port_configs.list_archs(include_paper=False)


def _same(port_spec, ref_spec) -> bool:
    """A port spec (a tuple) and a JAX PartitionSpec hold the same
    entries."""
    return tuple(port_spec) == tuple(ref_spec)


# the policy cases of tests/test_sharding.py: (logical axes, shape, rules
# name, mesh shape, the spec that test expects)
POLICY_CASES = {
    "basic_mapping": (("batch", "seq", None), (256, 4096, 1024), "default",
                      MESH_2D, ("data",)),
    "multi_axis_batch": (("batch", None), (256, 8), "default", MESH_3D,
                         (("pod", "data"),)),
    "indivisible_dim_replicates": (
        ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim"),
        (6, 1, 524288, 32, 64), "default", MESH_2D,
        (None, None, "data", "model")),
    "gqa_kv_heads_fallback_to_head_dim": (
        ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim"),
        (88, 128, 32768, 8, 128), "default", MESH_2D,
        (None, "data", None, None, "model")),
    "axis_claimed_once": (("mlp", "heads"), (64, 64), "default", MESH_2D,
                          ("model",)),
    "partial_axis_tuple": (("batch",), (48,), "default", MESH_3D, ("pod",)),
    "hubert_vocab_replicates": (("vocab", "embed"), (504, 1280), "default",
                                MESH_2D, (None, "data")),
    "xlstm_no_tp_weights": (("mlstm_inner", "heads", "head_dim_v"),
                            (4096, 4, 1024), "xlstm-1.3b", MESH_2D, ()),
    "xlstm_no_tp_batch": (("batch", "seq", None), (256, 4096, 2048),
                          "xlstm-1.3b", MESH_2D, (("data", "model"),)),
    "xlstm_no_tp_fsdp": (("embed", "mlstm_up"), (2048, 8192), "xlstm-1.3b",
                         MESH_2D, ("data",)),
    "deepseek_keeps_ep": (("expert", "embed", "expert_mlp"),
                          (64, 2048, 1408), "deepseek-moe-16b", MESH_2D,
                          ("model", "data")),
}


def _rules(pkg, name):
    return (pkg.DEFAULT_RULES if name == "default"
            else pkg.rules_for_arch(name))


class TestShapeAwareSpec:
    @pytest.mark.parametrize("case", sorted(POLICY_CASES))
    def test_policy_case(self, case):
        axes, shape, rules, mesh, want = POLICY_CASES[case]
        got = sh.shape_aware_spec(axes, shape, _rules(sh, rules), mesh)
        ref = ref_sh.shape_aware_spec(axes, shape, _rules(ref_sh, rules),
                                      mesh)
        assert _same(got, ref), (got, ref)
        assert got == P(*want) and tuple(got) == want

    def test_spec_is_canonical(self):
        assert P("data", None, None) == P("data") == ("data",)
        assert P() == () and P(None) == ()
        assert isinstance(P("data"), tuple)


class TestShardingsFor:
    def test_tree_with_nones(self):
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), devices=["cpu"])
        structs = {"w": torch.zeros(16, 8), "b": torch.zeros(8)}
        axes = {"w": ("embed", "mlp"), "b": None}
        out = sh.shardings_for(structs, axes, sh.DEFAULT_RULES, mesh)
        # mesh axes of size 1 still map (harmless no-op placement)
        assert out["w"].spec == P("data", "model")
        assert out["b"].spec == P()
        assert out["w"].mesh is mesh

    def test_leaf_specs_stand_for_their_axes(self):
        cfg = port_configs.reduced(port_configs.get_config("llama3.2-1b"))
        mesh = mesh_lib.make_mesh((2,), ("data",), devices=["cpu", "cpu"])
        specs = port_lm.specs(cfg)
        out = sh.shardings_for(specs, specs, sh.DEFAULT_RULES, mesh)
        want = sh.shape_aware_spec(specs["embed"]["tok"].axes,
                                   specs["embed"]["tok"].shape,
                                   sh.DEFAULT_RULES, {"data": 2})
        assert out["embed"]["tok"].spec == want

    def test_replicated_shardings(self):
        mesh = mesh_lib.make_mesh((2,), ("data",), devices=["cpu", "cpu"])
        out = sh.replicated_shardings({"a": torch.zeros(4), "b": [
            torch.zeros(2), torch.zeros(3)]}, mesh)
        assert out["a"].spec == P() and out["b"][1].spec == P()

    @pytest.mark.parametrize("dim,axes,ok", [
        (8, "data", True), (7, "data", False), (8, ("data", "model"), True),
        (6, ("data", "model"), False), (5, None, True)])
    def test_divisible_or_none(self, dim, axes, ok):
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"),
                                  devices=["cpu"] * 4)
        assert sh.divisible_or_none(dim, axes, mesh) is ok


class TestRulesForArch:
    @pytest.mark.parametrize("kind", ("train", "decode"))
    @pytest.mark.parametrize("arch", port_configs.list_archs())
    def test_rules_equal_reference(self, arch, kind):
        got = sh.rules_for_arch(arch, kind=kind)
        want = ref_sh.rules_for_arch(arch, kind=kind)
        assert dict(got.rules) == dict(want.rules)

    def test_tables_equal_reference(self):
        assert dict(sh.DEFAULT_RULES.rules) == dict(ref_sh.DEFAULT_RULES.rules)
        assert dict(sh.REPLICATED_RULES.rules) == {}
        assert (dict(sh.DEFAULT_RULES.with_overrides(batch=None).rules)
                == dict(ref_sh.DEFAULT_RULES.with_overrides(batch=None).rules))

    @pytest.mark.parametrize("arch", LM_ARCHS)
    def test_parameter_specs_equal_reference(self, arch):
        """``logical_to_spec`` and ``shape_aware_spec`` over every
        parameter of the published config, on the production mesh."""
        rules, ref_rules = (sh.rules_for_arch(arch),
                            ref_sh.rules_for_arch(arch))
        port_specs = port_lm.specs(port_configs.get_config(arch))
        ref_axes = ref_lm.specs(ref_configs.get_config(arch))
        port_leaves = _flat(port_specs)
        ref_leaves = _flat(ref_axes)
        assert sorted(port_leaves) == sorted(ref_leaves)
        for path, leaf in port_leaves.items():
            assert tuple(leaf.axes) == tuple(ref_leaves[path]), path
            for mesh in (MESH_2D, MESH_3D):
                names = tuple(mesh)
                assert _same(sh.logical_to_spec(leaf.axes, rules, names),
                             ref_sh.logical_to_spec(leaf.axes, ref_rules,
                                                    names)), path
                assert _same(
                    sh.shape_aware_spec(leaf.axes, leaf.shape, rules, mesh),
                    ref_sh.shape_aware_spec(leaf.axes, leaf.shape, ref_rules,
                                            mesh)), path


def _flat(tree, prefix=()):
    """{path: leaf} of a tree of dicts and lists (tuples and LeafSpecs are
    leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


class TestCacheSpecs:
    @pytest.mark.parametrize("slots", (1, 8, 32))
    @pytest.mark.parametrize("mesh", CACHE_MESHES,
                             ids=("data2", "data2model2", "pod2data16model16"))
    @pytest.mark.parametrize("arch", [a for a in LM_ARCHS
                                      if a != "hubert-xlarge"])
    def test_cache_specs_on_mesh(self, arch, mesh, slots):
        cfg = port_configs.get_config(arch)
        structs = port_lm.make_caches(cfg, slots, 1024, device="meta")
        port_axes = _flat(port_lm.cache_specs(cfg))
        ref_axes = _flat(ref_lm.cache_specs(ref_configs.get_config(arch)))
        assert sorted(port_axes) == sorted(ref_axes)
        for path, s in _flat(structs).items():
            axes = port_axes[path]
            assert tuple(axes) == tuple(ref_axes[path]), path
            for rules, ref_rules in ((sh.DEFAULT_RULES, ref_sh.DEFAULT_RULES),
                                     (sh.rules_for_arch(arch),
                                      ref_sh.rules_for_arch(arch))):
                got = sh.shape_aware_spec(axes, tuple(s.shape), rules, mesh)
                want = ref_sh.shape_aware_spec(axes, tuple(s.shape),
                                               ref_rules, mesh)
                assert _same(got, want), (path, got, want)

    @pytest.mark.parametrize("family_arch", (
        "llama3.2-1b", "llama-3.2-vision-90b", "xlstm-1.3b", "zamba2-1.2b",
        "deepseek-moe-16b"))
    def test_cache_shardings_split_the_slot_axis(self, family_arch):
        """``lm.cache_shardings`` on a 2-entry data mesh puts ``data`` on
        every leaf's slot axis when the slots divide it."""
        cfg = port_configs.reduced(port_configs.get_config(family_arch))
        mesh = mesh_lib.make_mesh((2,), ("data",), devices=["cpu", "cpu"])
        caches = port_lm.make_caches(cfg, 4, 32, device="meta")
        out = port_lm.cache_shardings(cfg, caches, mesh)
        specs = _flat(port_lm.cache_specs(cfg))
        for path, s in _flat(out).items():
            assert s.mesh is mesh
            ax = specs[path].index("batch")
            assert len(s.spec) > ax and s.spec[ax] == "data", (path, s.spec)
        # 3 slots do not divide: the slot axis replicates
        odd = port_lm.cache_shardings(
            cfg, port_lm.make_caches(cfg, 3, 32, device="meta"), mesh)
        for path, s in _flat(odd).items():
            ax = specs[path].index("batch")
            assert len(s.spec) <= ax or s.spec[ax] != "data"


class TestDisjointSubmeshes:
    @pytest.mark.parametrize("n", (1, 2, 3, 4))
    @pytest.mark.parametrize("d", (1, 3, 8))
    def test_groups_equal_reference(self, monkeypatch, n, d):
        """The reference's groups, read through a stand-in for its Mesh
        (a JAX mesh needs real devices; the grouping is what is held)."""
        class Recorder:
            def __init__(self, devices, axis_names):
                self.devices, self.axis_names = devices, axis_names

        monkeypatch.setattr(ref_sh, "Mesh", Recorder)
        names = [f"dev{i}" for i in range(d)]
        want = [list(m.devices) for m in
                ref_sh.disjoint_submeshes(n, devices=names)]
        devs = [torch.device("cpu", i) for i in range(d)]
        got = sh.disjoint_submeshes(n, devices=devs)
        assert len(got) == n
        assert [[names[x.index] for x in m.device_list] for m in got] == want
        assert all(m.axis_names == ("data",) for m in got)

    def test_refuses_bad_counts(self):
        with pytest.raises(ValueError, match="positive"):
            sh.disjoint_submeshes(0, devices=["cpu"])
        with pytest.raises(ValueError, match="no devices"):
            sh.disjoint_submeshes(2, devices=[])

    def test_default_is_the_cards(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the default takes it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sh.disjoint_submeshes(2)


class TestAdamWStateSpecs:
    @pytest.mark.parametrize("arch", ("llama3.2-1b", "deepseek-moe-16b"))
    def test_equal_reference(self, arch):
        axes = ref_lm.specs(ref_configs.get_config(arch))
        got = port_adamw.state_specs(axes)
        want = ref_adamw.state_specs(axes)
        assert got == want
        assert got["step"] is None and got["m"] is axes and got["v"] is axes

    def test_moments_shard_like_their_parameters(self):
        cfg = port_configs.reduced(port_configs.get_config("llama3.2-1b"))
        specs = port_lm.specs(cfg)
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"),
                                  devices=["cpu"] * 4)
        params = sh.shardings_for(specs, specs, sh.DEFAULT_RULES, mesh)
        st_axes = port_adamw.state_specs(specs)
        structs = {"m": specs, "v": specs, "step": torch.zeros(())}
        out = sh.shardings_for(structs, st_axes, sh.DEFAULT_RULES, mesh)
        assert out["m"] == params and out["v"] == params
        assert out["step"].spec == P()


class TestMesh:
    def test_make_mesh_over_repeated_devices(self):
        m = mesh_lib.make_mesh((2,), ("data",), devices=["cpu", "cpu"])
        assert m.shape == {"data": 2} and m.size == 2
        assert m.device_list == [torch.device("cpu")] * 2

    def test_shape_and_names_checked(self):
        with pytest.raises(ValueError, match="needs 4 devices"):
            mesh_lib.make_mesh((2, 2), ("data", "model"), devices=["cpu"])
        with pytest.raises(ValueError, match="one name per axis"):
            mesh_lib.Mesh(np.array([torch.device("cpu")], dtype=object),
                          ("data", "model"))

    def test_default_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the default takes it")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_lib.make_mesh((1,), ("data",))

    def test_host_mesh_and_context(self):
        m = mesh_lib.make_host_mesh("cpu")
        assert m.shape == {"data": 1, "model": 1}
        with mesh_lib.mesh_context(m) as got:
            assert got is m

    def test_batch_devices(self):
        devs = [torch.device("cpu", i) for i in range(4)]
        m = mesh_lib.make_mesh((2, 2), ("data", "model"), devices=devs)
        # batch -> data: the first device of each data row
        assert sh.batch_devices(m) == (devs[0], devs[2])
        # the no-TP rules put batch on (data, model): every device
        assert sh.batch_devices(m, sh.rules_for_arch("llama3.2-1b")) == \
            tuple(devs)
        assert sh.batch_devices(m, sh.REPLICATED_RULES) == (devs[0],)


def test_reference_partition_spec_is_canonical_too():
    """The comparison above reads a JAX spec as a tuple: trailing Nones are
    gone on both sides."""
    assert tuple(ref_sh.logical_to_spec(("batch", None), ref_sh.DEFAULT_RULES,
                                        ("data",))) == ("data",)
    assert tuple(JP("data")) == ("data",)
    assert jax.device_count() >= 1
