"""Port parity: routing variants (``repro_torch.core.routing`` and the
``repro_torch.deploy`` registry) against the reference's on the same numpy
``u_hat`` (CPU tensors; variant ``cuda`` runs its kernel's plain version
there, the reference's ``pallas`` variant runs in interpret mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import routing as ref_routing
from repro.deploy import RoutingSpec as RefSpec
from repro.deploy import resolve as ref_resolve
from repro_torch.core import routing as port_routing
from repro_torch.deploy import (RoutingRegistry, RoutingSpec, RoutingVariant,
                                normalize, registry, resolve)
from torch_testlib import f32, rand, to_jax, to_torch

torch.set_num_threads(1)

SHAPES = [(2, 24, 10, 16), (3, 36, 5, 8), (1, 252, 10, 16)]


def _both(u, ref_fn, port_fn, **kw):
    v_ref, c_ref = ref_fn(to_jax(u), **kw)
    v, c = port_fn(to_torch(u), **kw)
    return (f32(v), f32(c)), (f32(v_ref), f32(c_ref))


@pytest.mark.parametrize("shape", SHAPES)
def test_route_reference(shape):
    u = rand(0, shape, 0.2)
    got, want = _both(u, ref_routing.route_reference,
                      port_routing.route_reference, n_iters=3)
    # exact softmax and sqrt on both sides; only the sums' order differs
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode,atol", [("exact", 1e-5), ("taylor", 1e-4)])
def test_route_optimized(shape, mode, atol):
    u = rand(1, shape, 0.2)
    got, want = _both(u, ref_routing.route_optimized,
                      port_routing.route_optimized, n_iters=3,
                      softmax_mode=mode)
    np.testing.assert_allclose(got[0], want[0], atol=atol)
    np.testing.assert_allclose(got[1], want[1], atol=atol)


def test_route_optimized_div_exp_log():
    u = rand(2, (2, 24, 10, 16), 0.2)
    got, want = _both(u, ref_routing.route_optimized,
                      port_routing.route_optimized, n_iters=3,
                      softmax_mode="taylor", use_div_exp_log=True)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode,atol", [("exact", 1e-5), ("taylor", 1e-4)])
def test_kernel_variant_on_cpu_tensors(shape, mode, atol):
    """Variant ``cuda`` (plain version on the CPU) against the reference's
    ``pallas`` variant (interpret mode)."""
    u = rand(3, shape, 0.2)
    got, want = _both(u, ref_routing.route_pallas, port_routing.route_cuda,
                      n_iters=3, softmax_mode=mode)
    np.testing.assert_allclose(got[0], want[0], atol=atol)
    np.testing.assert_allclose(got[1], want[1], atol=atol)


def test_two_squashes_and_last_agreement_do_not_change_v_or_c():
    """``route_reference`` squashes with sqrt and runs the agreement step on
    the last iteration too; the kernel variant uses one rsqrt and skips it.
    Neither changes what is returned beyond rounding."""
    u = to_torch(rand(4, (2, 30, 10, 16), 0.2))
    v_ref, c_ref = port_routing.route_reference(u, n_iters=3)
    v_k, c_k = port_routing.route_cuda(u, n_iters=3, softmax_mode="exact")
    np.testing.assert_allclose(f32(v_k), f32(v_ref), atol=1e-5)
    np.testing.assert_allclose(f32(c_k), f32(c_ref), atol=1e-5)


def test_coupling_rows_sum_to_one():
    u = to_torch(rand(5, (2, 24, 10, 16), 0.2))
    for fn in (port_routing.route_reference, port_routing.route_optimized,
               port_routing.route_cuda):
        _, c = fn(u, n_iters=3)
        np.testing.assert_allclose(f32(c).sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("args", [(1, 1152, 10, 16, 3), (32, 252, 10, 16, 3),
                                  (4, 36, 5, 8, 1)])
def test_routing_flops(args):
    assert port_routing.routing_flops(*args) == ref_routing.routing_flops(*args)


class TestRoutingRegistry:
    def test_variants(self):
        assert registry.names() == ["cuda", "optimized", "reference"]

    def test_named_specs(self):
        assert RoutingSpec.named("reference") == RoutingSpec.reference()
        assert RoutingSpec.named("optimized") == RoutingSpec(
            mode="optimized", softmax="taylor")
        assert RoutingSpec.named("cuda") == RoutingSpec.cuda(softmax="taylor")
        assert RoutingSpec.cuda().mode == "cuda"

    def test_spec_has_no_interpret_field(self):
        names = {f.name for f in dataclasses.fields(RoutingSpec)}
        assert names == {"mode", "softmax", "div_exp_log"}

    def test_unknown_variant_raises(self):
        with pytest.raises(ValueError, match="unknown routing variant"):
            RoutingSpec.named("pallas")
        with pytest.raises(ValueError, match="unknown routing mode"):
            resolve(RoutingSpec(mode="pallas"))

    def test_bad_softmax_rejected(self):
        with pytest.raises(ValueError, match="softmax must be one of"):
            RoutingSpec(softmax="fast")

    def test_normalize_never_changes_variant(self):
        """No fallback: variant ``cuda`` stays ``cuda`` on a host without a
        card and resolves to the kernel's wrapper."""
        spec = RoutingSpec.cuda()
        assert normalize(spec) is spec
        fn = resolve(spec)
        assert fn.func is port_routing.route_cuda
        assert fn.keywords == {"softmax_mode": "taylor"}
        assert not hasattr(RoutingVariant("x", lambda s: None), "fallback")

    def test_custom_registry(self):
        reg = RoutingRegistry()
        reg.register(RoutingVariant("mine", lambda spec: "fn"))
        assert reg.resolve(RoutingSpec(mode="mine")) == "fn"

    @pytest.mark.parametrize("name,ref_name", [("reference", "reference"),
                                               ("optimized", "optimized"),
                                               ("cuda", "pallas")])
    def test_resolved_variants_match_reference(self, name, ref_name):
        u = rand(6, (2, 24, 10, 16), 0.2)
        v_ref, c_ref = ref_resolve(RefSpec.named(ref_name))(to_jax(u),
                                                            n_iters=3)
        v, c = resolve(RoutingSpec.named(name))(to_torch(u), n_iters=3)
        np.testing.assert_allclose(f32(v), f32(v_ref), atol=1e-4)
        np.testing.assert_allclose(f32(c), f32(c_ref), atol=1e-4)
