"""The backward of row 2 (``taylor_softmax``) on the CPU, against
``jax.grad`` of the reference.

The reference trains its ``optimized`` routing through plain ``jnp``
(``repro/core/approx_math.py`` ``taylor_softmax``); the port sends that
softmax through the kernel's wrapper, whose backward is a kernel of its own
(``taylor_softmax_bwd``).  Here its plain version, the wrapper's autograd
path on CPU tensors, ``route_optimized`` and the CapsNet loss through
``RoutingSpec.optimized()`` are held against the reference's gradients on
the same numpy inputs, the clip edge (``x - max(x) = -32`` exactly, where
``jax.grad`` of ``jnp.clip`` gives 1/2) included.  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import approx_math as ref_am
from repro.core import capsnet as ref_cn
from repro.core import routing as ref_routing
from repro.deploy import RoutingSpec as RefRoutingSpec
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.training import Trainer as RefTrainer
from repro.training import TrainerConfig as RefTrainerConfig
from repro_torch import kernels
from repro_torch.core import approx_math
from repro_torch.core import capsnet as cn
from repro_torch.core import routing
from repro_torch.deploy import RoutingSpec
from repro_torch.kernels.registry import registry
from repro_torch.kernels.routing.routing_kernel import fused_routing_cuda
from repro_torch.kernels.softmax import kernel as softmax_kernel
from repro_torch.kernels.softmax import ref as softmax_ref
from repro_torch.optim import AdamWConfig
from repro_torch.training import Trainer, TrainerConfig
from torch_testlib import f32, images, paired_params, small_cfgs

torch.set_num_threads(1)

# float32 Horner and squarings in two frameworks, sums in another order
BWD_ATOL = 1e-6
# the CapsNet loss and trainer: the tolerances of test_torch_train.py
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_TOL = 1e-5


def _jax_vjp(x: np.ndarray, g: np.ndarray) -> np.ndarray:
    """jax.grad of <taylor_softmax(x), g> in float32."""
    return np.asarray(jax.grad(
        lambda a: jnp.sum(ref_am.taylor_softmax(a) * jnp.asarray(g)))(
            jnp.asarray(x)))


def _edge_rows(seed: int, shape) -> np.ndarray:
    """Rows whose maximum is 0, with an entry exactly at -32 (the clip's
    edge) and one past it."""
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    x = np.clip(x * 8, -31.0, -1e-3)
    x[..., 0] = 0.0
    x[..., 1] = -32.0
    x[..., 2] = -40.0
    return x


def _inputs(seed, shape, scale):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, g


class TestPlainBackward:
    @pytest.mark.parametrize("shape,scale", [
        ((8, 16), 5.0), ((33, 250), 5.0), ((4, 7, 64), 5.0), ((1, 1024), 5.0),
        ((32, 36, 10), 1.0), ((6, 10), 40.0)])
    def test_matches_jax_grad(self, shape, scale):
        x, g = _inputs(0, shape, scale)
        got = softmax_ref.taylor_softmax_bwd_ref(torch.from_numpy(x),
                                                 torch.from_numpy(g))
        np.testing.assert_allclose(f32(got), _jax_vjp(x, g), atol=BWD_ATOL)

    def test_clip_edge_takes_half(self):
        """At x - max(x) = -32 exactly the reference's derivative is half
        the one inside the clip; past it, zero.  The values there are tiny
        (p(-1)^31), so they are held relatively."""
        x = _edge_rows(1, (6, 10))
        g = np.random.RandomState(2).standard_normal((6, 10)).astype(
            np.float32)
        got = f32(softmax_ref.taylor_softmax_bwd_ref(torch.from_numpy(x),
                                                     torch.from_numpy(g)))
        want = _jax_vjp(x, g)
        np.testing.assert_allclose(got, want, atol=BWD_ATOL)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5)
        assert np.all(got[:, 2] == 0.0) and np.all(want[:, 2] == 0.0)
        assert np.all(want[:, 1] != 0.0)
        # autograd of torch.clamp takes 1 on the edge: twice the reference
        xt = torch.from_numpy(x).requires_grad_(True)
        (approx_math.taylor_softmax(xt) * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(f32(xt.grad)[:, 1], 2 * want[:, 1],
                                   rtol=1e-5)

    def test_bfloat16_in_and_out(self):
        x, g = _inputs(3, (16, 64), 3.0)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        gb = torch.from_numpy(g).to(torch.bfloat16)
        got = softmax_ref.taylor_softmax_bwd_ref(xb, gb)
        assert got.dtype == torch.bfloat16
        want = _jax_vjp(f32(xb), f32(gb))
        np.testing.assert_allclose(f32(got), want, atol=1e-2)


class TestWrapperAutograd:
    def test_gradient_flows_through_the_wrapper(self):
        x, g = _inputs(4, (5, 7, 10), 2.0)
        xt = torch.from_numpy(x).requires_grad_(True)
        before = (softmax_kernel.taylor_softmax_cuda.launches,
                  softmax_kernel.taylor_softmax_bwd_cuda.launches)
        out = kernels.taylor_softmax(xt)
        assert out.grad_fn is not None
        (out * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(f32(xt.grad), _jax_vjp(x, g),
                                   atol=BWD_ATOL)
        want = softmax_ref.taylor_softmax_bwd_ref(torch.from_numpy(x),
                                                  torch.from_numpy(g))
        assert torch.equal(xt.grad, want)
        # the plain versions ran: no kernel launch was counted
        assert (softmax_kernel.taylor_softmax_cuda.launches,
                softmax_kernel.taylor_softmax_bwd_cuda.launches) == before

    def test_forward_unchanged_by_autograd(self):
        x, _ = _inputs(5, (9, 10), 2.0)
        plain = softmax_kernel.taylor_softmax_cuda(torch.from_numpy(x))
        live = softmax_kernel.taylor_softmax_cuda(
            torch.from_numpy(x).requires_grad_(True))
        assert torch.equal(live.detach(), plain)

    def test_backward_wrapper_checks_its_inputs(self):
        x = torch.zeros(4, 10)
        with pytest.raises(ValueError, match="does not match"):
            softmax_kernel.taylor_softmax_bwd_cuda(x, torch.zeros(4, 9))
        with pytest.raises(ValueError, match="does not match"):
            softmax_kernel.taylor_softmax_bwd_cuda(
                x, torch.zeros(4, 10, dtype=torch.bfloat16))

    def test_fused_routing_still_refuses(self):
        u = torch.randn(2, 6, 3, 4, requires_grad=True)
        with pytest.raises(RuntimeError, match="fused_routing"):
            fused_routing_cuda(u)


class TestRegistryRow:
    CASES = [pytest.param(i, id=f"case{i}") for i in range(
        len(registry.get("taylor_softmax_bwd").example_cases))]

    @pytest.mark.parametrize("idx", CASES)
    def test_plain_version_vs_jax_grad(self, idx):
        spec = registry.get("taylor_softmax_bwd")
        case = spec.example_cases[idx]
        (x, g), _ = spec.make_example(case, device="cpu")
        got = spec.ref_call(x, g)
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_allclose(f32(got), _jax_vjp(f32(x), f32(g)),
                                   atol=case["atol"])

    @pytest.mark.parametrize("idx", CASES)
    def test_wrapper_on_cpu_tensor_is_the_plain_version(self, idx):
        spec = registry.get("taylor_softmax_bwd")
        (x, g), kw = spec.make_example(spec.example_cases[idx], device="cpu")
        before = spec.build().launches
        assert torch.equal(registry.call("taylor_softmax_bwd", x, g, **kw),
                           spec.ref_call(x, g))
        assert spec.build().launches == before

    def test_edge_case_hits_the_edge(self):
        spec = registry.get("taylor_softmax_bwd")
        case = next(c for c in spec.example_cases if c.get("edge"))
        (x, _), _ = spec.make_example(case)
        z = x - x.amax(-1, keepdim=True)
        assert bool((z == -32.0).any()) and bool((z < -32.0).any())


class TestOptimizedRoutingTrains:
    @pytest.mark.parametrize("n_iters", (1, 2, 3))
    def test_route_optimized_grads_match_reference(self, n_iters):
        rng = np.random.RandomState(n_iters)
        u = (rng.standard_normal((3, 24, 10, 16)) * 0.2).astype(np.float32)
        wv = rng.standard_normal((3, 10, 16)).astype(np.float32)
        wc = rng.standard_normal((3, 24, 10)).astype(np.float32)

        def ref_obj(a):
            v, c = ref_routing.route_optimized(a, n_iters=n_iters)
            return jnp.sum(v * wv) + jnp.sum(c * wc)

        want = np.asarray(jax.grad(ref_obj)(jnp.asarray(u)))
        ut = torch.from_numpy(u).requires_grad_(True)
        v, c = routing.route_optimized(ut, n_iters=n_iters)
        (torch.sum(v * torch.from_numpy(wv))
         + torch.sum(c * torch.from_numpy(wc))).backward()
        np.testing.assert_allclose(f32(ut.grad), want, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)

    def test_first_iteration_needs_no_backward(self, monkeypatch):
        """b = 0 on the first iteration needs no gradient: of three softmax
        calls, two reach the backward."""
        calls = []
        real = softmax_kernel.taylor_softmax_bwd_ref
        monkeypatch.setattr(softmax_kernel, "taylor_softmax_bwd_ref",
                            lambda x, g: calls.append(1) or real(x, g))
        u = torch.randn(2, 12, 10, 16, requires_grad=True)
        v, _ = routing.route_optimized(u, n_iters=3)
        v.sum().backward()
        assert len(calls) == 2

    @pytest.fixture(scope="class")
    def model(self):
        ref_cfg, port_cfg = small_cfgs(conv1_channels=16)
        ref_params, port_params = paired_params(ref_cfg, seed=0)
        return (dataclasses.replace(ref_cfg,
                                    routing=RefRoutingSpec.optimized()),
                dataclasses.replace(port_cfg, routing=RoutingSpec.optimized()),
                ref_params, port_params)

    @pytest.mark.parametrize("seed", (0, 4))
    def test_capsnet_loss_grads_match_reference(self, model, seed):
        ref_cfg, port_cfg, ref_p, port_p = model
        x = images(seed, 6, ref_cfg)
        y = np.random.RandomState(seed + 1).randint(0, 10, 6).astype(np.int32)
        want = jax.grad(lambda p: ref_cn.loss_fn(
            p, ref_cfg, jnp.asarray(x), jnp.asarray(y))[0])(ref_p)
        live = {k: {kk: v.clone().requires_grad_(True)
                    for kk, v in sub.items()} for k, sub in port_p.items()}
        loss, _ = cn.loss_fn(live, port_cfg, torch.from_numpy(x),
                             torch.from_numpy(y))
        loss.backward()
        for k in want:
            for kk in want[k]:
                np.testing.assert_allclose(
                    f32(live[k][kk].grad), np.asarray(want[k][kk]),
                    atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=f"{k}/{kk}")

    def test_trainer_through_optimized_matches_reference(self, model):
        """Three steps of the Trainer through RoutingSpec.optimized() from
        converted params on the same batches."""
        ref_cfg, port_cfg, ref_p, port_p = model
        kw = dict(lr=1e-3, weight_decay=0.0, warmup_steps=1, total_steps=3)
        rng = np.random.RandomState(7)
        batches = [{"images": images(10 + i, 4, ref_cfg),
                    "labels": rng.randint(0, 10, 4).astype(np.int32)}
                   for i in range(3)]
        ref = RefTrainer(
            RefTrainerConfig(optim=RefAdamWConfig(**kw), log_every=1),
            lambda p, b: ref_cn.loss_fn(p, ref_cfg, b["images"], b["labels"]),
            lambda k: ref_p).run(iter(batches), 3)
        got = Trainer(
            TrainerConfig(optim=AdamWConfig(**kw), log_every=1),
            lambda p, b: cn.loss_fn(p, port_cfg, b["images"], b["labels"]),
            lambda g: port_p, device="cpu").run(iter(batches), 3)
        assert got.step == ref.step == 3
        want = jax.tree.map(np.asarray, ref.params)
        for k in want:
            for kk in want[k]:
                np.testing.assert_allclose(f32(got.params[k][kk]),
                                           want[k][kk], atol=PARAM_TOL,
                                           err_msg=f"{k}/{kk}")
        for a, b in zip(got.history, ref.history):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4,
                                       atol=1e-5)
