"""Port parity: ``repro_torch.optim.adamw`` against ``repro.optim.adamw`` on
the same numpy params and gradients — schedules, clipping, weight decay and
a pruning ``mask_fn``; params, moments and lr within 1e-6 over a few
steps."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as ref_pruning
from repro.optim import adamw as ref_adamw
from repro_torch import convert
from repro_torch.core import pruning as port_pruning
from repro_torch.optim import adamw as port_adamw
from torch_testlib import rand

torch.set_num_threads(1)

ATOL = 1e-6
SHAPES = {"conv1": {"w": (4, 1, 3, 3), "b": (4,)},
          "conv2": {"w": (6, 4, 3, 3), "b": (6,)},
          "digit": {"w": (5, 3, 2, 4)}}


def _tree(seed, scale=1.0):
    out, i = {}, 0
    for k, sub in SHAPES.items():
        out[k] = {}
        for kk, shape in sub.items():
            out[k][kk] = rand(seed * 100 + i, shape, scale)
            i += 1
    return out


def _masks(seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(4, 1) > 0.4).astype(np.float32),
            (rng.rand(6, 4) > 0.5).astype(np.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(port_tree, ref_tree, what):
    ref = _np(ref_tree)
    port = convert.params_to_numpy(port_tree)
    for k in ref:
        for kk in ref[k]:
            np.testing.assert_allclose(port[k][kk], ref[k][kk], rtol=0,
                                       atol=ATOL, err_msg=f"{what} {k}/{kk}")


CASES = list(itertools.product(("cosine", "linear", "constant"),
                               (1.0, 0.0), (0.0, 0.1), (False, True)))


@pytest.mark.parametrize("schedule,clip,wd,masked", CASES,
                         ids=[f"{s}-clip{c}-wd{w}-{'mask' if m else 'nomask'}"
                              for s, c, w, m in CASES])
def test_apply_updates_matches_reference(schedule, clip, wd, masked):
    cfg_kw = dict(lr=1e-2, weight_decay=wd, grad_clip=clip,
                  schedule=schedule, warmup_steps=2, total_steps=6)
    ref_cfg = ref_adamw.AdamWConfig(**cfg_kw)
    port_cfg = port_adamw.AdamWConfig(**cfg_kw)
    params = _tree(0)
    ref_p = jax.tree.map(jnp.asarray, params)
    port_p = convert.params_from_numpy(params)
    ref_s = ref_adamw.init_state(ref_p)
    port_s = port_adamw.init_state(port_p)
    m1, m2 = _masks()
    ref_mask = port_mask = None
    if masked:
        ref_masks = (jnp.asarray(m1), jnp.asarray(m2))
        port_masks = (torch.from_numpy(m1), torch.from_numpy(m2))
        ref_mask = lambda g: ref_pruning.mask_gradients(g, ref_masks)  # noqa: E731
        port_mask = lambda g: port_pruning.mask_gradients(g, port_masks)  # noqa: E731
    for step in range(7):
        # gradients of norm about 2 to 8: the clip at 1.0 takes every step
        grads = _tree(step + 1, scale=0.5 + step)
        ref_p, ref_s, ref_m = ref_adamw.apply_updates(
            ref_p, jax.tree.map(jnp.asarray, grads), ref_s, ref_cfg,
            mask_fn=ref_mask)
        port_p, port_s, port_m = port_adamw.apply_updates(
            port_p, convert.params_from_numpy(grads), port_s, port_cfg,
            mask_fn=port_mask)
        _close(port_p, ref_p, f"params at step {step}")
        _close(port_s["m"], ref_s["m"], f"m at step {step}")
        _close(port_s["v"], ref_s["v"], f"v at step {step}")
        assert port_s["step"].dtype == torch.int32
        assert int(port_s["step"]) == int(ref_s["step"]) == step + 1
        assert abs(float(port_m["lr"]) - float(ref_m["lr"])) <= ATOL
        np.testing.assert_allclose(float(port_m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("wd", (0.0, 0.1))
def test_masked_kernels_stay_zero(wd):
    cfg = port_adamw.AdamWConfig(lr=1e-2, weight_decay=wd, warmup_steps=1,
                                 total_steps=5)
    m1, m2 = _masks(1)
    masks = (torch.from_numpy(m1), torch.from_numpy(m2))
    params = convert.params_from_numpy(_tree(0))
    params = {**params,
              "conv1": {**params["conv1"],
                        "w": params["conv1"]["w"] * masks[0][:, :, None, None]},
              "conv2": {**params["conv2"],
                        "w": params["conv2"]["w"] * masks[1][:, :, None, None]}}
    state = port_adamw.init_state(params)
    for step in range(5):
        params, state, _ = port_adamw.apply_updates(
            params, convert.params_from_numpy(_tree(step + 1)), state, cfg,
            mask_fn=lambda g: port_pruning.mask_gradients(g, masks))
    for name, m in (("conv1", m1), ("conv2", m2)):
        w = params[name]["w"].numpy()
        assert (w[m == 0] == 0).all(), name
        assert (np.abs(w[m == 1]).sum(axis=(1, 2)) > 0).all(), name


@pytest.mark.parametrize("schedule", ("cosine", "linear", "constant"))
@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (10, 10),
                                          (4, 1)])
def test_schedule_matches_reference(schedule, warmup, total):
    kw = dict(lr=3e-4, schedule=schedule, warmup_steps=warmup,
              total_steps=total, min_lr_frac=0.1)
    for s in range(0, 14):
        want = float(ref_adamw.schedule_lr(ref_adamw.AdamWConfig(**kw),
                                           jnp.int32(s)))
        got = port_adamw.schedule_lr(port_adamw.AdamWConfig(**kw),
                                     torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-9, (s, float(got), want)


@pytest.mark.parametrize("max_norm", (0.5, 1.0, 1e6))
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(5, scale=0.3)
    ref_g, ref_n = ref_adamw.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), max_norm)
    port_g, port_n = port_adamw.clip_by_global_norm(
        convert.params_from_numpy(g), max_norm)
    np.testing.assert_allclose(float(port_n), float(ref_n), rtol=1e-6)
    np.testing.assert_allclose(
        float(port_adamw.global_norm(convert.params_from_numpy(g))),
        float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, g))),
        rtol=1e-6)
    _close(port_g, ref_g, "clipped grads")


def test_init_state_layout():
    params = convert.params_from_numpy(_tree(0))
    params["digit"]["w"] = params["digit"]["w"].to(torch.bfloat16)
    state = port_adamw.init_state(params)
    assert set(state) == {"m", "v", "step"}
    assert state["step"].shape == () and state["step"].dtype == torch.int32
    for k in SHAPES:
        for kk, shape in SHAPES[k].items():
            for mom in ("m", "v"):
                leaf = state[mom][k][kk]
                assert leaf.shape == shape and leaf.dtype == torch.float32
                assert not leaf.any()
    assert state["m"]["conv1"]["w"] is not state["v"]["conv1"]["w"]


def test_apply_updates_leaves_its_inputs():
    params = convert.params_from_numpy(_tree(0))
    before = convert.params_to_numpy(params)
    state = port_adamw.init_state(params)
    new, new_state, _ = port_adamw.apply_updates(
        params, convert.params_from_numpy(_tree(1)), state,
        port_adamw.AdamWConfig())
    after = convert.params_to_numpy(params)
    for k in before:
        for kk in before[k]:
            np.testing.assert_array_equal(after[k][kk], before[k][kk])
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert not state["m"]["conv1"]["w"].any()
