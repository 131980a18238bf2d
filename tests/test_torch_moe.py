"""Port parity for the mixture-of-experts layer (``repro_torch.models.moe``)
and the moe LM on the CPU.

Inputs are drawn with numpy from a seed; parameters are the reference's
(``repro.models.moe``), converted leaf by leaf.  ``moe_apply`` is held to
the reference at float32 within 1e-5 (y) and 1e-6 (the aux loss), for both
dispatches, with and without a ``token_mask``, with and without shared
experts, through the flattened decode dispatch and where capacity binds.
The properties of the reference's ``tests/test_moe.py`` that concern
serving are re-run on the port: the explicit top-k mixture at ample
capacity, partial drops, onehot equal to scatter (drops included) and
global decode dispatch.  The reduced ``deepseek-moe-16b`` LM is held to the
reference's logits within 1e-4 through a ragged prefill (the token mask
keeps pad tokens out of routing) and a decode step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.common import LMConfig as RefLMConfig
from repro.models.common import MoEConfig as RefMoEConfig
from repro.models.common import init_params as ref_init_params
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import lm as port_lm
from repro_torch.models import moe as port_moe
from repro_torch.models.common import LMConfig, MoEConfig, tree_leaves
from torch_testlib import f32, lm_parity_bf16

torch.set_num_threads(1)

D, F = 16, 8


def cfgs(e=8, k=2, cap=8.0, shared=0, **moe_kw):
    """The same one-layer moe config for both packages (float32)."""
    base = dict(arch_id="moe-test", family="moe", n_layers=1, d_model=D,
                n_heads=2, n_kv_heads=2, d_ff=F, vocab=32,
                compute_dtype="float32", param_dtype="float32")
    moe = dict(n_experts=e, top_k=k, d_expert=F, n_shared=shared,
               capacity_factor=cap, **moe_kw)
    return (RefLMConfig(**base, moe=RefMoEConfig(**moe)),
            LMConfig(**base, moe=MoEConfig(**moe)))


def params(ref_cfg, seed=0):
    jp = ref_init_params(ref_moe.moe_defs(ref_cfg), jax.random.key(seed),
                         jnp.float32)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def rand(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


MASK = np.array([[1] * 16, [1] * 9 + [0] * 7, [1] * 3 + [0] * 13], bool)


def both(ref_cfg, cfg, jp, pp, x, mask=None):
    yj, aj = ref_moe.moe_apply(jp, ref_cfg, jnp.asarray(x),
                               token_mask=None if mask is None
                               else jnp.asarray(mask))
    yp, ap = port_moe.moe_apply(pp, cfg, torch.from_numpy(x),
                                token_mask=None if mask is None
                                else torch.from_numpy(mask))
    return f32(yj), float(aj), f32(yp), float(ap)


class TestParity:
    @pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("shared", [0, 2])
    @pytest.mark.parametrize("cap", [8.0, 0.5])
    def test_moe_apply_matches_reference(self, dispatch, masked, shared,
                                         cap):
        """cap 8.0: nothing drops; cap 0.5: capacity binds (the effective
        capacity of a masked row comes from its real token count)."""
        ref_cfg, cfg = cfgs(cap=cap, shared=shared, dispatch=dispatch)
        jp, pp = params(ref_cfg, seed=1)
        x = rand(2, (3, 16, D))
        yj, aj, yp, ap = both(ref_cfg, cfg, jp, pp, x,
                              MASK if masked else None)
        np.testing.assert_allclose(yp, yj, atol=1e-5)
        assert abs(ap - aj) < 1e-6

    @pytest.mark.parametrize("dispatch", ["onehot", "scatter"])
    @pytest.mark.parametrize("cap", [8.0, 0.5])
    def test_flattened_decode_dispatch_matches_reference(self, dispatch,
                                                         cap):
        """A one-token step of 8 rows routes as one row of 8 tokens (the
        capacity floor of 8 applies once), and returns (8, 1, d)."""
        ref_cfg, cfg = cfgs(e=4, k=2, cap=cap, shared=1, dispatch=dispatch)
        jp, pp = params(ref_cfg, seed=3)
        x = rand(4, (8, 1, D))
        yj, aj, yp, ap = both(ref_cfg, cfg, jp, pp, x)
        assert yp.shape == (8, 1, D)
        np.testing.assert_allclose(yp, yj, atol=1e-5)
        assert abs(ap - aj) < 1e-6

    def test_capacity_rules_match_reference(self):
        for e, k, cf in ((8, 2, 1.25), (64, 6, 1.25), (16, 4, 0.5),
                         (4, 1, 3.0)):
            ref_m = RefMoEConfig(n_experts=e, top_k=k, d_expert=8,
                                 capacity_factor=cf)
            m = MoEConfig(n_experts=e, top_k=k, d_expert=8,
                          capacity_factor=cf)
            for s in (1, 7, 8, 100, 1024, 4096):
                assert port_moe._capacity(s, m) == ref_moe._capacity(s, ref_m)
            n = np.array([0, 1, 5, 64, 700, 1024], np.int32)
            np.testing.assert_array_equal(
                port_moe._capacity_dyn(torch.from_numpy(n), m).numpy(),
                np.asarray(ref_moe._capacity_dyn(jnp.asarray(n), ref_m)))

    def test_rank_within_expert_matches_reference(self):
        ids = np.random.RandomState(5).randint(0, 6, (2, 40, 3))
        got = port_moe._rank_within_expert(torch.from_numpy(ids), 6)
        want = jax.vmap(lambda i: ref_moe._rank_within_expert(i, 6))(
            jnp.asarray(ids))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_top_k_ties_pick_the_lower_id_as_lax_top_k(self):
        x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
        vals, ids = port_moe.top_k(torch.from_numpy(x), 4)
        jvals, jids = jax.lax.top_k(jnp.asarray(x), 4)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def dense_mixture(pp, cfg, x):
    """The explicit per-token top-k mixture (no capacity, no dispatch)."""
    m = cfg.moe
    logits = x.float() @ pp["router"].float()
    vals, ids = torch.topk(logits, m.top_k, dim=-1)
    w = torch.softmax(vals, -1)
    out = torch.zeros_like(x)
    for slot in range(m.top_k):
        e = ids[..., slot]
        h = (torch.nn.functional.silu(torch.einsum("bsd,bsdf->bsf", x,
                                                   pp["wg"][e]))
             * torch.einsum("bsd,bsdf->bsf", x, pp["wi"][e]))
        out = out + w[..., slot, None] * torch.einsum("bsf,bsfd->bsd", h,
                                                      pp["wo"][e])
    return out


class TestProperties:
    """``tests/test_moe.py``'s serving properties, on the port alone."""

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_dense_mixture_with_ample_capacity(self, seed):
        ref_cfg, cfg = cfgs(cap=8.0)
        _, pp = params(ref_cfg, seed)
        x = torch.from_numpy(rand(seed + 10, (2, 16, D)))
        y, _ = port_moe.moe_apply(pp, cfg, x)
        np.testing.assert_allclose(f32(y), f32(dense_mixture(pp, cfg, x)),
                                   atol=1e-4, rtol=1e-4)

    def test_capacity_drops_are_partial_not_corrupt(self):
        ref_cfg, cfg_t = cfgs(cap=0.5)
        _, cfg_a = cfgs(cap=8.0)
        _, pp = params(ref_cfg)
        x = torch.from_numpy(rand(3, (1, 32, D)))
        y_t, _ = port_moe.moe_apply(pp, cfg_t, x)
        y_a, _ = port_moe.moe_apply(pp, cfg_a, x)
        assert torch.isfinite(y_t).all()
        assert float(y_t.norm()) <= float(y_a.norm()) + 1e-3
        assert not torch.allclose(y_t, y_a)

    @pytest.mark.parametrize("cap", [8.0, 0.5])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_onehot_equals_scatter(self, cap, seed):
        """The same tokens kept and dropped by both dispatches (arrival
        order over (S, k))."""
        ref_cfg, cfg_o = cfgs(cap=cap, dispatch="onehot")
        _, cfg_s = cfgs(cap=cap, dispatch="scatter")
        _, pp = params(ref_cfg, seed)
        x = torch.from_numpy(rand(seed + 20, (2, 16, D)))
        y_o, a_o = port_moe.moe_apply(pp, cfg_o, x)
        y_s, a_s = port_moe.moe_apply(pp, cfg_s, x)
        np.testing.assert_allclose(f32(y_o), f32(y_s), atol=1e-5)
        assert abs(float(a_o) - float(a_s)) < 1e-6

    def test_global_decode_dispatch_equivalence(self):
        ref_cfg, cfg_g = cfgs(dispatch="onehot")
        _, cfg_n = cfgs(dispatch="onehot", global_decode_dispatch=False)
        _, pp = params(ref_cfg)
        x = torch.from_numpy(rand(10, (8, 1, D)))
        y_n, _ = port_moe.moe_apply(pp, cfg_n, x)
        y_g, _ = port_moe.moe_apply(pp, cfg_g, x)
        np.testing.assert_allclose(f32(y_n), f32(y_g), atol=1e-5)

    def test_masked_tokens_take_no_capacity(self):
        """A row padded with masked tokens gives its real tokens what the
        same tokens alone give (tight capacity, so a pad that routed would
        steal ranks)."""
        ref_cfg, cfg = cfgs(cap=0.5, dispatch="onehot")
        _, pp = params(ref_cfg, 7)
        x = torch.from_numpy(rand(8, (1, 16, D)))
        mask = torch.zeros((1, 16), dtype=torch.bool)
        mask[0, :9] = True
        y_m, _ = port_moe.moe_apply(pp, cfg, x, token_mask=mask)
        y_a, _ = port_moe.moe_apply(pp, cfg, x[:, :9])
        np.testing.assert_allclose(f32(y_m[:, :9]), f32(y_a), atol=1e-6)

    def test_unknown_dispatch_raises(self):
        ref_cfg, cfg = cfgs(dispatch="dense")
        _, pp = params(cfgs()[0])
        with pytest.raises(ValueError, match="dispatch"):
            port_moe.moe_apply(pp, cfg, torch.zeros((1, 4, D)))


# ---------------------------------------------------------------------------
# The moe LM: reduced deepseek-moe-16b in both packages
# ---------------------------------------------------------------------------

B, S, T = 3, 8, 16
LENGTHS = np.array([8, 5, 3], np.int32)


def lm_cfgs(**kw):
    arch = "deepseek-moe-16b"
    return (dataclasses.replace(ref_configs.reduced(
                ref_configs.get_config(arch)), compute_dtype="float32", **kw),
            dataclasses.replace(port_configs.reduced(
                port_configs.get_config(arch)), compute_dtype="float32", **kw))


_LM = {}


def lm_model():
    if "m" not in _LM:
        jcfg, pcfg = lm_cfgs()
        jp = ref_lm.init(jcfg, jax.random.key(0))
        pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
        _LM["m"] = (jcfg, pcfg, jp, pp)
    return _LM["m"]


class TestMoeLM:
    def test_forward_aux_prefill_and_decode_match_reference(self):
        jcfg, pcfg, jp, pp = lm_model()
        rng = np.random.RandomState(3)
        tokens = rng.randint(1, 128, (B, S)).astype(np.int32)
        nxt = rng.randint(1, 128, (B, 1)).astype(np.int32)
        t = torch.from_numpy

        xj, _, auxj = ref_lm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
        xp, _, auxp = port_lm.forward(pp, pcfg, {"tokens": t(tokens)})
        np.testing.assert_allclose(f32(xp), f32(xj), atol=1e-4)
        assert abs(float(auxp) - float(auxj)) < 1e-5
        assert float(auxp) > 0

        jl, jc = ref_lm.ragged_prefill_step(
            jp, jcfg, {"tokens": jnp.asarray(tokens),
                       "lengths": jnp.asarray(LENGTHS)},
            ref_lm.make_caches(jcfg, B, T))
        pl, pc = port_lm.ragged_prefill_step(
            pp, pcfg, {"tokens": t(tokens), "lengths": t(LENGTHS)},
            port_lm.make_caches(pcfg, B, T, device="cpu"))
        np.testing.assert_allclose(f32(pl), f32(jl), atol=1e-4)
        jl, _ = ref_lm.decode_step(jp, jcfg, {"tokens": jnp.asarray(nxt),
                                              "pos": jnp.asarray(LENGTHS)},
                                   jc)
        pl, _ = port_lm.decode_step(pp, pcfg, {"tokens": t(nxt),
                                               "pos": t(LENGTHS)}, pc)
        np.testing.assert_allclose(f32(pl), f32(jl), atol=1e-4)

    def test_ragged_prefill_equals_each_prompt_alone(self):
        """The token mask makes a padded row's routing its own: each
        prompt's last logits equal a prefill of that prompt alone."""
        _, pcfg, _, pp = lm_model()
        pcfg = dataclasses.replace(
            pcfg, moe=dataclasses.replace(pcfg.moe, capacity_factor=0.5))
        tokens = np.random.RandomState(4).randint(1, 128, (B, S)).astype(
            np.int32)
        t = torch.from_numpy
        together, _ = port_lm.ragged_prefill_step(
            pp, pcfg, {"tokens": t(tokens), "lengths": t(LENGTHS)},
            port_lm.make_caches(pcfg, B, T, device="cpu"))
        for i, n in enumerate(LENGTHS):
            alone, _ = port_lm.ragged_prefill_step(
                pp, pcfg, {"tokens": t(tokens[i:i + 1, :n]),
                           "lengths": t(LENGTHS[i:i + 1])},
                port_lm.make_caches(pcfg, 1, T, device="cpu"))
            np.testing.assert_allclose(f32(together[i]), f32(alone[0]),
                                       atol=1e-5)

    def test_compute_params_keeps_the_router_in_the_parameter_type(self):
        _, pcfg = lm_cfgs()
        pcfg = dataclasses.replace(pcfg, compute_dtype="bfloat16")
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(0), "cpu")
        cp = port_lm.compute_params(pcfg, pp)
        ffn = cp["units"]["block"]["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert ffn["router_b"].dtype == torch.float32
        assert torch.equal(ffn["router"], pp["units"]["block"]["ffn"]["router"])
        for name in ("wi", "wg", "wo"):
            assert ffn[name].dtype == torch.bfloat16
        assert ffn["shared"]["wi"].dtype == torch.bfloat16
        tokens = torch.from_numpy(np.random.RandomState(5).randint(
            1, 128, (B, S)).astype(np.int32))
        a, _, aux_a = port_lm.forward(pp, pcfg, {"tokens": tokens})
        b, _, aux_b = port_lm.forward(cp, pcfg, {"tokens": tokens})
        assert torch.equal(a, b) and float(aux_a) == float(aux_b)

    def test_param_bytes_counts_the_defs(self):
        for arch in ("deepseek-moe-16b", "llama-3.2-vision-90b"):
            cfg = port_configs.reduced(port_configs.get_config(arch))
            pp = port_lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
            assert port_lm.param_bytes(cfg) == sum(
                x.numel() * x.element_size() for x in tree_leaves(pp))
        full = port_configs.get_config("deepseek-moe-16b")
        # 16.9 B parameters: 67.5 GB in float32
        assert 67e9 < port_lm.param_bytes(full) < 68e9


def test_bfloat16_parameters_match_reference():
    """Reduced deepseek-moe-16b with bfloat16 parameters and compute, from
    the reference's bf16 parameters converted bit for bit: the forward, the
    prefill logits and a decode step's logits within four bf16 steps of
    each row's largest value (``torch_testlib.lm_parity_bf16``)."""
    arch = "deepseek-moe-16b"
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config(arch)), **kw)
    pcfg = dataclasses.replace(port_configs.reduced(
        port_configs.get_config(arch)), **kw)
    jp = ref_lm.init(jcfg, jax.random.key(0))
    pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    assert pp["units"]["block"]["ffn"]["router"].dtype == torch.bfloat16
    tokens = np.random.RandomState(3).randint(1, 128, (2, 13)).astype(
        np.int32)
    lm_parity_bf16(jcfg, pcfg, jp, pp, {"tokens": tokens})
