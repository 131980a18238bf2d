"""Port parity: LAKP scoring, masking and compaction
(``repro_torch.core.lakp`` and the pruning half of
``repro_torch.core.capsnet``) against the reference's.  Masks, index vectors
and compacted shapes must be identical, not merely close; scores are float32
products and sums computed on the CPU on both sides, so only the order of the
sums differs (1e-5 relative)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capsnet as ref_cn
from repro.core import lakp as ref_lakp
from repro_torch.core import capsnet as port_cn
from repro_torch.core import lakp as port_lakp
from torch_testlib import f32, paired_params, rand, small_cfgs, to_jax, to_torch

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    ref_cfg, port_cfg = small_cfgs()
    ref_params, port_params = paired_params(ref_cfg, seed=1)
    return ref_cfg, port_cfg, ref_params, port_params


def test_small_worked_example():
    """A 2x2x3x3 layer between two neighbours, in the shape of the paper's
    Fig. 7 example: same scores and same 50 % mask as the reference."""
    w_prev = torch.tensor([1.0, 2.0]).reshape(2, 1, 1, 1) * torch.ones(2, 3, 1, 1)
    w_i = torch.tensor([[17.0, 8.0], [17.0, 10.0]]).reshape(2, 2, 1, 1) \
        * torch.ones(2, 2, 3, 3) / 9.0
    w_next = torch.tensor([[4.0, 7.0], [5.0, 8.0], [6.0, 10.0]]
                          ).reshape(3, 2, 1, 1)
    ours = port_lakp.lakp_kernel_scores(w_i, w_prev, w_next)
    theirs = ref_lakp.lakp_kernel_scores(
        to_jax(w_i.numpy()), to_jax(w_prev.numpy()), to_jax(w_next.numpy()))
    np.testing.assert_allclose(f32(ours), f32(theirs), rtol=RTOL)
    np.testing.assert_array_equal(
        f32(port_lakp.mask_from_scores(ours, 0.5)),
        f32(ref_lakp.mask_from_scores(theirs, 0.5)))


@pytest.mark.parametrize("norm", ["l1", "fro"])
@pytest.mark.parametrize("neighbours", ["both", "prev", "next", "none",
                                        "dense_next"])
def test_lakp_kernel_scores(norm, neighbours):
    w_i = rand(0, (6, 4, 3, 3))
    w_prev = rand(1, (4, 2, 5, 5)) if neighbours in ("both", "prev") else None
    w_next = rand(2, (5, 6, 3, 3)) if neighbours in ("both", "next") else None
    if neighbours == "dense_next":
        w_next = rand(3, (6, 7))                  # dense (in, out)
    j = lambda a: None if a is None else to_jax(a)     # noqa: E731
    t = lambda a: None if a is None else to_torch(a)   # noqa: E731
    want = f32(ref_lakp.lakp_kernel_scores(j(w_i), j(w_prev), j(w_next),
                                           norm=norm))
    got = f32(port_lakp.lakp_kernel_scores(t(w_i), t(w_prev), t(w_next),
                                           norm=norm))
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_kp_scores_and_unstructured_mask():
    w = rand(4, (5, 3, 3, 3))
    np.testing.assert_allclose(f32(port_lakp.kp_scores(to_torch(w))),
                               f32(ref_lakp.kp_scores(to_jax(w))), rtol=RTOL)
    np.testing.assert_array_equal(
        f32(port_lakp.unstructured_mask(to_torch(w), 0.37)),
        f32(ref_lakp.unstructured_mask(to_jax(w), 0.37)))


@pytest.mark.parametrize("sparsity", [0.0, 0.1, 0.5, 0.9, 0.999, 1.0])
def test_mask_from_scores_identical(sparsity):
    s = np.abs(rand(5, (16, 9)))
    want = f32(ref_lakp.mask_from_scores(to_jax(s), sparsity))
    got = port_lakp.mask_from_scores(to_torch(s), sparsity)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(f32(got), want)
    assert int((f32(got) == 0).sum()) == min(int(sparsity * s.size), s.size)


def test_mask_from_scores_breaks_ties_by_index():
    """Many equal scores: the stable sort prunes the lowest flat indices
    first, exactly as the reference does."""
    s = np.ones((8, 8), np.float32)
    s[3, :] = 0.5
    s[:, 2] = 0.5
    want = f32(ref_lakp.mask_from_scores(to_jax(s), 0.4))
    got = f32(port_lakp.mask_from_scores(to_torch(s), 0.4))
    np.testing.assert_array_equal(got, want)


def test_apply_kernel_mask():
    w = rand(6, (4, 3, 3, 3))
    m = (rand(7, (4, 3)) > 0).astype(np.float32)
    np.testing.assert_array_equal(
        f32(port_lakp.apply_kernel_mask(to_torch(w), to_torch(m))),
        f32(ref_lakp.apply_kernel_mask(to_jax(w), to_jax(m))))
    d = rand(8, (3, 4))
    np.testing.assert_array_equal(
        f32(port_lakp.apply_kernel_mask(to_torch(d), to_torch(m))),
        f32(ref_lakp.apply_kernel_mask(to_jax(d), to_jax(m))))
    with pytest.raises(ValueError, match="unsupported weight ndim"):
        port_lakp.apply_kernel_mask(torch.zeros(3), torch.zeros(3))


@pytest.mark.parametrize("prune_fn", ["lakp_prune", "kp_prune"])
def test_chain_pruning(prune_fn):
    ws = [rand(10, (4, 1, 3, 3)), rand(11, (6, 4, 3, 3)), rand(12, (5, 6, 3, 3))]
    sp = [0.25, 0.5, 0.4]
    want = getattr(ref_lakp, prune_fn)([to_jax(w) for w in ws], sp)
    got = getattr(port_lakp, prune_fn)([to_torch(w) for w in ws], sp)
    for a, b in zip(got.masks, want.masks):
        np.testing.assert_array_equal(f32(a), f32(b))
    for a, b in zip(got.weights, want.weights):
        np.testing.assert_array_equal(f32(a), f32(b))
    for a, b in zip(got.scores, want.scores):
        np.testing.assert_allclose(f32(a), f32(b), rtol=RTOL)


def test_bookkeeping():
    m1 = (rand(13, (8, 3)) > 0.3).astype(np.float32)
    m1[2] = 0.0
    m2 = (rand(14, (16, 8)) > 0.8).astype(np.float32)
    m2[4:8] = 0.0
    ws = [rand(15, (8, 3, 3, 3)), rand(16, (16, 8, 5, 5))]
    for group in (1, 4):
        np.testing.assert_array_equal(
            port_lakp.surviving_channel_index(to_torch(m2), group).numpy(),
            np.asarray(ref_lakp.surviving_channel_index(to_jax(m2), group)))
    assert port_lakp.index_overhead_bytes(
        [to_torch(m1), to_torch(m2)]) == ref_lakp.index_overhead_bytes(
        [to_jax(m1), to_jax(m2)])
    assert port_lakp.effective_compression(
        [to_torch(m1), to_torch(m2)], [to_torch(w) for w in ws]
    ) == pytest.approx(ref_lakp.effective_compression(
        [to_jax(m1), to_jax(m2)], [to_jax(w) for w in ws]), abs=1e-12)


@pytest.mark.parametrize("method", ["lakp", "kp"])
@pytest.mark.parametrize("s1,s2,type_keep", [(0.5, 0.5, None), (0.6, 0.9, 2),
                                             (0.25, 0.7, 1), (0.6, 0.9, 3)])
def test_lakp_masks_identical(model, method, s1, s2, type_keep):
    ref_cfg, port_cfg, ref_params, port_params = model
    want = ref_cn.lakp_masks(ref_params, ref_cfg, s1, s2, method=method,
                             type_keep=type_keep)
    got = port_cn.lakp_masks(port_params, port_cfg, s1, s2, method=method,
                             type_keep=type_keep)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(f32(g), f32(w))


def test_lakp_masks_rejects_unknown_method(model):
    _, port_cfg, _, port_params = model
    with pytest.raises(ValueError):
        port_cn.lakp_masks(port_params, port_cfg, 0.5, 0.5, method="magic")


def test_eliminate_capsule_types_ties_rank_by_index():
    ref_cfg, port_cfg = small_cfgs()
    scores = np.zeros((ref_cfg.primary_conv_channels, 8), np.float32)
    scores[0:8] = 1.0          # type 0
    scores[8:16] = 1.0         # type 1 ties with type 0
    scores[24:32] = 1.0        # type 3 ties too
    want = f32(ref_cn.eliminate_capsule_types(to_jax(scores), ref_cfg, 2))
    got = f32(port_cn.eliminate_capsule_types(to_torch(scores), port_cfg, 2))
    np.testing.assert_array_equal(got, want)
    assert got[0:16].all() and not got[16:].any()


@pytest.mark.parametrize("s1,s2,type_keep", [(0.6, 0.9, 2), (0.5, 0.8, 1),
                                             (0.3, 0.5, None)])
def test_apply_masks_and_compact_identical(model, s1, s2, type_keep):
    ref_cfg, port_cfg, ref_params, port_params = model
    ref_masks = ref_cn.lakp_masks(ref_params, ref_cfg, s1, s2,
                                  type_keep=type_keep)
    port_masks = port_cn.lakp_masks(port_params, port_cfg, s1, s2,
                                    type_keep=type_keep)
    ref_pruned = ref_cn.apply_masks(ref_params, ref_masks)
    port_pruned = port_cn.apply_masks(port_params, port_masks)
    for layer in ("conv1", "conv2"):
        np.testing.assert_array_equal(f32(port_pruned[layer]["w"]),
                                      f32(ref_pruned[layer]["w"]))
    # the input tree was not modified
    assert float(port_params["conv2"]["w"].abs().min()) > 0.0

    ref_c, ref_cfg2, ref_idx = ref_cn.compact(ref_pruned, ref_cfg, ref_masks)
    port_c, port_cfg2, port_idx = port_cn.compact(port_pruned, port_cfg,
                                                  port_masks)
    for k in ("conv1_out", "caps_types"):
        np.testing.assert_array_equal(port_idx[k].numpy(),
                                      np.asarray(ref_idx[k]))
        assert (np.diff(port_idx[k].numpy()) > 0).all()        # ascending
    assert port_cfg2.conv1_channels == ref_cfg2.conv1_channels
    assert port_cfg2.caps_types == ref_cfg2.caps_types
    assert port_cfg2.n_primary_caps == ref_cfg2.n_primary_caps
    for layer, leaf in (("conv1", "w"), ("conv1", "b"), ("conv2", "w"),
                        ("conv2", "b"), ("digit", "w")):
        a, b = port_c[layer][leaf], ref_c[layer][leaf]
        assert tuple(a.shape) == tuple(b.shape), (layer, leaf)
        np.testing.assert_array_equal(f32(a), f32(b))
    assert port_cn.param_count(port_c) == ref_cn.param_count(ref_c)
    if type_keep is not None:
        assert port_cfg2.caps_types == type_keep


def test_paper_setting_compacts_1152_to_252():
    """Full-width shapes, random weights: 7 of 32 types survive, so the
    routing sees 252 capsules (index arithmetic only; nothing is run)."""
    cfg = port_cn.CapsNetConfig()
    g = torch.Generator().manual_seed(0)
    params = {"conv1": {"w": torch.randn(256, 1, 9, 9, generator=g),
                        "b": torch.zeros(256)},
              "conv2": {"w": torch.randn(256, 256, 1, 1, generator=g
                                         ).expand(256, 256, 9, 9),
                        "b": torch.zeros(256)},
              "digit": {"w": torch.randn(1152, 10, 8, 16, generator=g)},
              "decoder": {}}
    masks = port_cn.lakp_masks(params, cfg, 0.6, 0.9, type_keep=7)
    compacted, new_cfg, index = port_cn.compact(
        port_cn.apply_masks(params, masks), cfg, masks)
    assert new_cfg.caps_types == 7 and new_cfg.n_primary_caps == 252
    assert compacted["digit"]["w"].shape == (252, 10, 8, 16)
    assert compacted["conv2"]["w"].shape[0] == 56
    assert compacted["conv1"]["w"].shape[0] == int(index["conv1_out"].numel())
    assert dataclasses.replace(cfg, caps_types=7).n_primary_caps == 252
