"""Port parity: ``repro_torch.core.capsnet`` against ``repro.core.capsnet``
on converted parameters at a small size (conv1_channels=8, caps_types=4)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import capsnet as ref_cn
from repro.deploy import RoutingSpec as RefSpec
from repro_torch import convert
from repro_torch.core import capsnet as port_cn
from repro_torch.deploy import RoutingSpec
from repro_torch.models.common import ParamDef, fanin_init, init_params
from torch_testlib import (SMALL, f32, images, paired_params, small_cfgs,
                           to_jax, to_torch)

torch.set_num_threads(1)

# float32 convolutions, an einsum and three routing iterations in two
# frameworks: sums in another order, values of order 0.1 to 1
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    ref_cfg, port_cfg = small_cfgs()
    ref_params, port_params = paired_params(ref_cfg, seed=0)
    return ref_cfg, port_cfg, ref_params, port_params


class TestConfig:
    def test_fields_match_reference(self):
        ours = {f.name: f.default for f in dataclasses.fields(port_cn.CapsNetConfig)}
        theirs = {f.name: f.default for f in dataclasses.fields(ref_cn.CapsNetConfig)}
        assert ours == theirs

    @pytest.mark.parametrize("kw", [{}, SMALL, {"caps_types": 7,
                                                "conv1_channels": 103}])
    def test_derived_sizes(self, kw):
        a, b = ref_cn.CapsNetConfig(**kw), port_cn.CapsNetConfig(**kw)
        for prop in ("conv1_out_hw", "caps_out_hw", "n_primary_caps",
                     "primary_conv_channels"):
            assert getattr(a, prop) == getattr(b, prop)

    def test_published_width(self):
        cfg = port_cn.CapsNetConfig()
        assert (cfg.n_primary_caps, cfg.n_classes, cfg.digit_dim) == (1152, 10, 16)

    def test_default_routing_is_reference(self):
        assert port_cn.CapsNetConfig().routing_spec() == RoutingSpec.reference()


class TestParams:
    def test_defs_have_reference_shapes(self, model):
        ref_cfg, port_cfg, _, _ = model
        flat = lambda d: {(k, kk): v.shape for k, sub in d.items()  # noqa: E731
                          for kk, v in sub.items()}
        assert flat(port_cn.capsnet_defs(port_cfg)) == flat(
            ref_cn.capsnet_defs(ref_cfg))

    def test_init_is_seeded_truncated_and_scaled(self):
        _, port_cfg = small_cfgs()
        g = torch.Generator().manual_seed(3)
        p1 = port_cn.init(port_cfg, g)
        p2 = port_cn.init(port_cfg, torch.Generator().manual_seed(3))
        p3 = port_cn.init(port_cfg, torch.Generator().manual_seed(4))
        assert torch.equal(p1["conv2"]["w"], p2["conv2"]["w"])
        assert not torch.equal(p1["conv2"]["w"], p3["conv2"]["w"])
        w = p1["conv2"]["w"]
        std = 1.0 / np.sqrt(8 * 81)
        assert float(w.abs().max()) <= 2.0 * std + 1e-7
        assert abs(float(w.std()) - 0.88 * std) < 0.05 * std
        assert float(p1["conv1"]["b"].abs().max()) == 0.0
        assert w.dtype == torch.float32

    def test_init_params_walks_nested_defs(self):
        defs = {"a": {"w": ParamDef((4, 3), (None, None), fanin_init())},
                "b": ParamDef((2,), (None,), fanin_init(9))}
        out = init_params(defs, torch.Generator().manual_seed(0), torch.float32)
        assert out["a"]["w"].shape == (4, 3) and out["b"].shape == (2,)

    def test_paramdef_rank_mismatch_raises(self):
        with pytest.raises(ValueError, match="rank"):
            ParamDef((2, 3), (None,), fanin_init())

    def test_param_count(self, model):
        _, _, ref_params, port_params = model
        assert port_cn.param_count(port_params) == ref_cn.param_count(ref_params)

    def test_convert_roundtrip(self, model):
        _, _, ref_params, port_params = model
        back = convert.params_to_numpy(port_params)
        want = jax.tree.map(np.asarray, ref_params)
        for k, sub in want.items():
            for kk, v in sub.items():
                np.testing.assert_array_equal(back[k][kk], v)
        # a copy, not a view of the numpy leaves
        leaf = np.zeros((2, 2), np.float32)
        t = convert.params_from_numpy({"x": leaf})["x"]
        leaf[0, 0] = 1.0
        assert float(t[0, 0]) == 0.0


class TestForward:
    def test_primary_capsules(self, model):
        ref_cfg, port_cfg, ref_params, port_params = model
        x = images(1, 5, ref_cfg)
        want = f32(ref_cn.primary_capsules(ref_params, ref_cfg, to_jax(x)))
        got = f32(port_cn.primary_capsules(port_params, port_cfg, to_torch(x)))
        assert got.shape == want.shape == (5, ref_cfg.n_primary_caps, 8)
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_capsule_order_is_type_y_x(self, model):
        """Fails when capsules are ordered (y, x, type) or their 8 values are
        taken from the wrong axis: every shape check would still pass."""
        ref_cfg, port_cfg, ref_params, port_params = model
        x = images(2, 3, ref_cfg)
        want = f32(ref_cn.primary_capsules(ref_params, ref_cfg, to_jax(x)))
        got = f32(port_cn.primary_capsules(port_params, port_cfg, to_torch(x)))
        hw, t, d = ref_cfg.caps_out_hw, ref_cfg.caps_types, ref_cfg.caps_dim
        wrong_order = (want.reshape(3, t, hw, hw, d).transpose(0, 2, 3, 1, 4)
                       .reshape(3, -1, d))
        assert np.abs(want - wrong_order).max() > 1e-2   # the orders differ
        assert np.abs(got - want).max() < ATOL
        assert np.abs(got - wrong_order).max() > 1e-2
        # capsule i = type * hw^2 + y * hw + x: the first hw^2 capsules depend
        # only on the conv2 channels of type 0
        p2 = {k: dict(v) for k, v in port_params.items()}
        w2 = port_params["conv2"]["w"].clone()
        w2[d:] = 0.0
        p2["conv2"]["w"] = w2
        only_type0 = f32(port_cn.primary_capsules(p2, port_cfg, to_torch(x)))
        np.testing.assert_allclose(only_type0[:, :hw * hw], got[:, :hw * hw],
                                   atol=1e-6)
        assert np.abs(only_type0[:, hw * hw:]).max() < 1e-6

    def test_predictions(self, model):
        ref_cfg, _, ref_params, port_params = model
        u = np.random.RandomState(3).randn(4, ref_cfg.n_primary_caps, 8
                                           ).astype(np.float32) * 0.3
        want = f32(ref_cn.predictions(ref_params, to_jax(u)))
        got = f32(port_cn.predictions(port_params, to_torch(u)))
        assert got.shape == (4, ref_cfg.n_primary_caps, 10, 16)
        np.testing.assert_allclose(got, want, atol=ATOL)

    @pytest.mark.parametrize("name,ref_name", [("reference", "reference"),
                                               ("optimized", "optimized"),
                                               ("cuda", "pallas")])
    def test_forward(self, model, name, ref_name):
        ref_cfg, port_cfg, ref_params, port_params = model
        ref_cfg = dataclasses.replace(ref_cfg, routing=RefSpec.named(ref_name))
        port_cfg = dataclasses.replace(port_cfg,
                                       routing=RoutingSpec.named(name))
        x = images(4, 6, ref_cfg)
        len_ref, v_ref = ref_cn.forward(ref_params, ref_cfg, to_jax(x))
        len_port, v_port = port_cn.forward(port_params, port_cfg, to_torch(x))
        assert tuple(len_port.shape) == (6, 10)
        assert tuple(v_port.shape) == (6, 10, 16)
        np.testing.assert_allclose(f32(len_port), f32(len_ref), atol=ATOL)
        np.testing.assert_allclose(f32(v_port), f32(v_ref), atol=ATOL)
        np.testing.assert_array_equal(f32(len_port).argmax(-1),
                                      f32(len_ref).argmax(-1))

    def test_digit_capsules(self, model):
        ref_cfg, port_cfg, ref_params, port_params = model
        u = np.random.RandomState(5).randn(3, ref_cfg.n_primary_caps, 8
                                           ).astype(np.float32) * 0.3
        v_ref, c_ref = ref_cn.digit_capsules(ref_params, ref_cfg, to_jax(u))
        v, c = port_cn.digit_capsules(port_params, port_cfg, to_torch(u))
        np.testing.assert_allclose(f32(v), f32(v_ref), atol=ATOL)
        np.testing.assert_allclose(f32(c), f32(c_ref), atol=ATOL)

    def test_conv_chain_and_dense_digit_weights(self, model):
        ref_cfg, _, ref_params, port_params = model
        chain = port_cn.conv_chain(port_params)
        assert [tuple(w.shape) for w in chain] == [
            tuple(w.shape) for w in ref_cn.conv_chain(ref_params)]
        want = f32(ref_cn.digit_w_as_dense(
            ref_params["digit"]["w"], ref_cfg.caps_types, ref_cfg.caps_dim,
            ref_cfg.caps_out_hw))
        got = f32(port_cn.digit_w_as_dense(
            port_params["digit"]["w"], ref_cfg.caps_types, ref_cfg.caps_dim,
            ref_cfg.caps_out_hw))
        assert got.shape == (ref_cfg.primary_conv_channels, 160)
        np.testing.assert_allclose(got, want, rtol=1e-5)
