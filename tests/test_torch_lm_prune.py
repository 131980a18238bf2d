"""Port parity for the LM halves of pruning: LAKP's block scores,
``prune_blocks`` and ``compact_blocks`` (``repro_torch.core.lakp``) and
``prune_lm_ffn``, ``prune_lm_heads`` and ``prune_moe_experts``
(``repro_torch.core.pruning``) against the reference's, on random weights
and on weights whose blocks tie.

Masks, surviving indices and the pruned weights' zero pattern must be
identical, not merely close: both packages rank with a stable argsort, so
tied scores prune the lower block first.  Scores are float32 sums taken in
another order on the two sides (1e-5 relative); the pruned weights are the
inputs times 0 or 1, so they are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import lakp as ref_lakp
from repro.core import pruning as ref_pruning
from repro.models import lm as ref_lm
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.core import lakp as port_lakp
from repro_torch.core import pruning as port_pruning
from repro_torch.models import lm as port_lm
from torch_testlib import f32, rand, to_jax, to_torch

torch.set_num_threads(1)

RTOL = 1e-5
D, F, NB = 12, 32, 8


def tied(seed, shape, n_blocks, axis):
    """Weights whose ``n_blocks`` blocks along ``axis`` come in equal pairs
    (blocks 2i and 2i+1 hold the same values), so the scores tie."""
    w = rand(seed, shape)
    blocks = np.split(w, n_blocks, axis=axis)
    for i in range(1, n_blocks, 2):
        blocks[i] = blocks[i - 1]
    return np.ascontiguousarray(np.concatenate(blocks, axis=axis))


def pair(kind, seed=0):
    if kind == "random":
        return rand(seed, (D, F)), rand(seed + 1, (F, D))
    return tied(seed, (D, F), NB, 1), tied(seed + 1, (F, D), NB, 0)


def both(fn_ref, fn_port, *arrays, **kw):
    return (fn_ref(*[to_jax(a) for a in arrays], **kw),
            fn_port(*[to_torch(a) for a in arrays], **kw))


class TestBlockScores:
    @pytest.mark.parametrize("kind", ["random", "tied"])
    @pytest.mark.parametrize("norm", ["l1", "fro"])
    def test_lookahead_scores(self, kind, norm):
        w_in, w_out = pair(kind)
        want, got = both(ref_lakp.block_lookahead_scores,
                         port_lakp.block_lookahead_scores, w_in, w_out,
                         n_blocks=NB, norm=norm)
        np.testing.assert_allclose(f32(got), f32(want), rtol=RTOL)
        if kind == "tied":
            assert np.array_equal(f32(got)[0::2], f32(got)[1::2])

    @pytest.mark.parametrize("kind", ["random", "tied"])
    def test_magnitude_scores(self, kind):
        w_in, w_out = pair(kind, seed=4)
        want, got = both(ref_lakp.block_magnitude_scores,
                         port_lakp.block_magnitude_scores, w_in, w_out,
                         n_blocks=NB)
        np.testing.assert_allclose(f32(got), f32(want), rtol=RTOL)

    def test_mismatched_pair_raises(self):
        with pytest.raises(ValueError):
            port_lakp.block_lookahead_scores(torch.ones(4, 8),
                                             torch.ones(6, 4), 2)
        with pytest.raises(ValueError):
            port_lakp.block_lookahead_scores(torch.ones(4, 8),
                                             torch.ones(8, 4), 3)


class TestPruneAndCompactBlocks:
    @pytest.mark.parametrize("kind", ["random", "tied"])
    @pytest.mark.parametrize("method", ["lakp", "kp"])
    @pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.5, 0.875])
    def test_prune_blocks(self, kind, method, sparsity):
        w_in, w_out = pair(kind, seed=2)
        (wi_r, wo_r, m_r), (wi_p, wo_p, m_p) = both(
            ref_lakp.prune_blocks, port_lakp.prune_blocks, w_in, w_out,
            n_blocks=NB, sparsity=sparsity, method=method)
        np.testing.assert_array_equal(f32(m_p), f32(m_r))
        np.testing.assert_array_equal(f32(wi_p), f32(wi_r))
        np.testing.assert_array_equal(f32(wo_p), f32(wo_r))
        assert int(f32(m_p).sum()) == NB - int(sparsity * NB)

    def test_tied_scores_prune_the_lower_block_first(self):
        """Blocks 2i and 2i+1 tie; at sparsity 1/8 only block 2i of the
        lowest pair goes, as the reference's stable argsort has it."""
        w_in, w_out = pair("tied", seed=6)
        m = f32(port_lakp.prune_blocks(to_torch(w_in), to_torch(w_out), NB,
                                       1 / NB)[2])
        lowest = int(np.argmin(f32(port_lakp.block_lookahead_scores(
            to_torch(w_in), to_torch(w_out), NB))))
        assert lowest % 2 == 0
        assert m[lowest] == 0 and m.sum() == NB - 1

    def test_unknown_method_raises(self):
        w_in, w_out = pair("random")
        with pytest.raises(ValueError):
            port_lakp.prune_blocks(to_torch(w_in), to_torch(w_out), NB, 0.5,
                                   method="random")

    @pytest.mark.parametrize("kind", ["random", "tied"])
    def test_compact_blocks(self, kind):
        w_in, w_out = pair(kind, seed=8)
        _, _, mask = ref_lakp.prune_blocks(to_jax(w_in), to_jax(w_out), NB,
                                           0.5)
        want = ref_lakp.compact_blocks(to_jax(w_in), to_jax(w_out), mask)
        got = port_lakp.compact_blocks(to_torch(w_in), to_torch(w_out),
                                       to_torch(f32(mask)))
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        # the compacted pair computes what the masked pair computes
        x = rand(9, (3, D))
        wi_m, wo_m, _ = port_lakp.prune_blocks(to_torch(w_in),
                                               to_torch(w_out), NB, 0.5)
        np.testing.assert_allclose(
            f32(to_torch(x) @ got[0] @ got[1]),
            f32(to_torch(x) @ wi_m @ wo_m), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The LM pruning functions on the reduced configs' layers
# ---------------------------------------------------------------------------


_LAYERS = {}


def layer(arch, part):
    """Layer 0's ``part`` ("ffn" or "attn") of the reduced ``arch``, from
    the reference's init: (reference dict, port dict)."""
    key = (arch, part)
    if key not in _LAYERS:
        cfg = ref_configs.reduced(ref_configs.get_config(arch))
        units = ref_lm.init(cfg, jax.random.key(0))["units"]
        p = {k: v[0] for k, v in units["block"][part].items()
             if not isinstance(v, dict)}
        _LAYERS[key] = (p, convert.params_from_numpy(
            jax.tree.map(np.asarray, p)))
    return _LAYERS[key]


def assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == getattr(torch, str(want[k].dtype)), k
        np.testing.assert_array_equal(f32(got[k]), f32(want[k]), err_msg=k)


@pytest.mark.parametrize("method", ["lakp", "kp"])
@pytest.mark.parametrize("arch,n_blocks,sparsity", [
    ("llama3.2-1b", 8, 0.5), ("qwen3-1.7b", 4, 0.25),
    ("hubert-xlarge", 8, 0.5)])
def test_prune_lm_ffn(arch, n_blocks, sparsity, method):
    """SwiGLU FFNs (``wg`` masked with ``wi``) and hubert's plain GELU MLP
    (no ``wg``; its biases pass through)."""
    ref_p, port_p = layer(arch, "ffn")
    want, m_r = ref_pruning.prune_lm_ffn(ref_p, n_blocks, sparsity, method)
    got, m_p = port_pruning.prune_lm_ffn(port_p, n_blocks, sparsity, method)
    np.testing.assert_array_equal(f32(m_p), f32(m_r))
    assert_dicts_equal(got, want)
    assert ("wg" in got) == (arch != "hubert-xlarge")
    assert got is not port_p and port_p["wi"].abs().sum() > got["wi"].abs(
        ).sum()


@pytest.mark.parametrize("method", ["lakp", "kp"])
@pytest.mark.parametrize("arch,sparsity", [
    ("llama3.2-1b", 0.5), ("qwen3-1.7b", 0.5), ("zamba2-1.2b", 0.25),
    ("deepseek-moe-16b", 0.5)])
def test_prune_lm_heads(arch, sparsity, method):
    """At KV-group granularity: a pruned group's query heads, its K and V
    heads and its rows of ``wo`` all go; GQA (several query heads a KV
    head) and MHA configs."""
    cfg = port_configs.reduced(port_configs.get_config(arch))
    if arch == "zamba2-1.2b":
        key = ("shared", arch)
        if key not in _LAYERS:
            jcfg = ref_configs.reduced(ref_configs.get_config(arch))
            p = ref_lm.init(jcfg, jax.random.key(0))["shared"]["attn"]
            _LAYERS[key] = (p, convert.params_from_numpy(
                jax.tree.map(np.asarray, p)))
        ref_p, port_p = _LAYERS[key]
    else:
        ref_p, port_p = layer(arch, "attn")
    want, m_r = ref_pruning.prune_lm_heads(ref_p, cfg.n_heads,
                                           cfg.n_kv_heads, sparsity, method)
    got, m_p = port_pruning.prune_lm_heads(port_p, cfg.n_heads,
                                           cfg.n_kv_heads, sparsity, method)
    np.testing.assert_array_equal(f32(m_p), f32(m_r))
    assert m_p.shape == (cfg.n_kv_heads,)
    assert_dicts_equal(got, want)
    dead = np.flatnonzero(f32(m_p) == 0)
    g = cfg.n_heads // cfg.n_kv_heads
    for kv in dead:
        assert not got["wk"][:, kv].any() and not got["wv"][:, kv].any()
        assert not got["wq"][:, kv * g:(kv + 1) * g].any()
        assert not got["wo"][kv * g:(kv + 1) * g].any()


@pytest.mark.parametrize("method", ["lakp", "kp"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("kind", ["random", "tied"])
def test_prune_moe_experts(method, with_bias, kind):
    """Whole experts: weights zeroed and ``router_b`` lowered by 1e9 where
    the mask is 0 (made when the layer has none), on the reduced
    deepseek-moe-16b layer and on one whose experts come in equal pairs."""
    ref_p, _ = layer("deepseek-moe-16b", "ffn")
    p = {k: np.asarray(v) for k, v in ref_p.items()}
    if kind == "tied":
        e = p["wi"].shape[0]
        for k in ("wi", "wg", "wo"):
            p[k] = np.repeat(p[k][0::2], 2, axis=0)[:e]
    if not with_bias:
        p.pop("router_b")
    want, m_r = ref_pruning.prune_moe_experts(
        {k: jnp.asarray(v) for k, v in p.items()}, 0.5, method)
    got, m_p = port_pruning.prune_moe_experts(
        convert.params_from_numpy(p), 0.5, method)
    np.testing.assert_array_equal(f32(m_p), f32(m_r))
    assert_dicts_equal(got, want)
    dead = f32(m_p) == 0
    assert dead.sum() == len(dead) // 2
    assert (f32(got["router_b"])[dead] <= -1e9 + 1).all()


def test_pruned_experts_are_never_routed():
    """After prune_moe_experts the reduced moe LM routes no token to a
    pruned expert: the forward equals the reference's on the pruned
    parameters, and the router's top-k skips the suppressed experts."""
    arch = "deepseek-moe-16b"
    jcfg = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config(arch)), compute_dtype="float32")
    pcfg = dataclasses.replace(port_configs.reduced(
        port_configs.get_config(arch)), compute_dtype="float32")
    jp = ref_lm.init(jcfg, jax.random.key(0))
    pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    n = jcfg.n_layers
    ffn_j, ffn_p = jp["units"]["block"]["ffn"], pp["units"]["block"]["ffn"]
    outs_j, outs_p = [], []
    for i in range(n):
        lj = {k: v[i] for k, v in ffn_j.items() if not isinstance(v, dict)}
        lp = {k: v[i] for k, v in ffn_p.items() if not isinstance(v, dict)}
        outs_j.append(ref_pruning.prune_moe_experts(lj, 0.5)[0])
        outs_p.append(port_pruning.prune_moe_experts(lp, 0.5)[0])
    for k in outs_p[0]:
        ffn_j = dict(ffn_j, **{k: jnp.stack([o[k] for o in outs_j])})
        ffn_p = dict(ffn_p, **{k: torch.stack([o[k] for o in outs_p])})
    jp["units"]["block"] = dict(jp["units"]["block"], ffn=ffn_j)
    pp["units"]["block"] = dict(pp["units"]["block"], ffn=ffn_p)
    tokens = np.random.RandomState(3).randint(1, 128, (2, 12)).astype(
        np.int32)
    xj, _, _ = ref_lm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    xp, _, _ = port_lm.forward(pp, pcfg, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(f32(xp), f32(xj), atol=1e-4)
    h = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (24, pcfg.d_model)).astype(np.float32))
    for i in range(n):
        logits = h @ ffn_p["router"][i] + ffn_p["router_b"][i]
        top = torch.topk(logits, pcfg.moe.top_k, dim=-1).indices
        dead = torch.nonzero(ffn_p["router_b"][i] < -1e8)[:, 0]
        assert not torch.isin(top, dead).any()
