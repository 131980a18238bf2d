"""Port parity for the vision-language family (cross-attention units of
``repro_torch.models.lm``) on the CPU.

``reduced(llama-3.2-vision-90b)`` (one unit: 4 self-attention blocks and
one cross-attention block, 8 image tokens) runs in both packages on the
reference's parameters, converted leaf by leaf, with every cross gate set
to 0.5 and real image features (serving prompts carry none and the gate
starts at 0, so a serve run cannot see the cross path).  float32 compute;
logits within 1e-4, as ``test_torch_lm.py``.

The reference's forward returns the cross cache it projected in the
compute type; the port writes it in place into its bfloat16 cache, as the
reference's engines do when they scatter prefilled rows into their caches.
The decode step is therefore held against the reference's decode on its
caches cast to ``make_caches``' types.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.models import attention as port_attention
from repro_torch.models import lm as port_lm
from repro_torch.models.common import tree_leaves, tree_map
from torch_testlib import f32

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
B, S, T = 3, 8, 16
LENGTHS = np.array([8, 5, 3], np.int32)
GATE = 0.5


def cfgs(**kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(ref_configs.reduced(
                ref_configs.get_config(ARCH)), **kw),
            dataclasses.replace(port_configs.reduced(
                port_configs.get_config(ARCH)), **kw))


_MODEL = {}


def model():
    """Reference params with every cross gate at GATE, and their copy."""
    if "m" not in _MODEL:
        jcfg, pcfg = cfgs()
        jp = ref_lm.init(jcfg, jax.random.key(0))
        cross = jp["units"]["cross"]["attn"]
        cross["gate"] = jnp.full_like(cross["gate"], GATE)
        pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
        _MODEL["m"] = (jcfg, pcfg, jp, pp)
    return _MODEL["m"]


def inputs(seed=3):
    _, pcfg = cfgs()
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 128, (B, S)).astype(np.int32)
    nxt = rng.randint(1, 128, (B, 1)).astype(np.int32)
    img = rng.standard_normal((B, pcfg.n_image_tokens, pcfg.d_model)
                              ).astype(np.float32)
    return tokens, nxt, img


def as_cache_types(jcfg, caches):
    """The reference's caches cast to its make_caches types (bfloat16)."""
    like = ref_lm.make_caches(jcfg, B, T, as_structs=True)
    return jax.tree.map(lambda c, sd: c.astype(sd.dtype), caches, like)


_RUN = {}


def run():
    """Both packages: forward with image features, a ragged prefill with
    them into fresh caches, and a vector-pos decode reading the cached
    cross K/V."""
    if _RUN:
        return _RUN
    jcfg, pcfg, jp, pp = model()
    tokens, nxt, img = inputs()
    t = torch.from_numpy
    out = _RUN
    x, _, _ = ref_lm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens),
                                        "image_features": jnp.asarray(img)})
    out["j_forward"] = f32(ref_lm.common.unembed(jp["embed"], jcfg, x))
    x, _, aux = port_lm.forward(pp, pcfg, {"tokens": t(tokens),
                                           "image_features": t(img)})
    out["p_forward"] = f32(port_lm.common.unembed(pp["embed"], pcfg, x))
    out["p_aux"] = aux

    jl, jc = ref_lm.ragged_prefill_step(
        jp, jcfg, {"tokens": jnp.asarray(tokens),
                   "lengths": jnp.asarray(LENGTHS),
                   "image_features": jnp.asarray(img)},
        ref_lm.make_caches(jcfg, B, T))
    jc = as_cache_types(jcfg, jc)
    out["j_prefill"], out["j_cross_k"] = f32(jl), f32(
        jc["units"]["cross"]["k"])
    pl, pc = port_lm.ragged_prefill_step(
        pp, pcfg, {"tokens": t(tokens), "lengths": t(LENGTHS),
                   "image_features": t(img)},
        port_lm.make_caches(pcfg, B, T, device="cpu"))
    out["p_prefill"], out["p_cross_k"] = f32(pl), f32(
        pc["units"]["cross"]["k"])
    jl, _ = ref_lm.decode_step(jp, jcfg, {"tokens": jnp.asarray(nxt),
                                          "pos": jnp.asarray(LENGTHS)}, jc)
    pl, _ = port_lm.decode_step(pp, pcfg, {"tokens": t(nxt),
                                           "pos": t(LENGTHS)}, pc)
    out["j_decode"], out["p_decode"] = f32(jl), f32(pl)
    return out


class TestForward:
    def test_forward_with_image_features(self):
        r = run()
        np.testing.assert_allclose(r["p_forward"], r["j_forward"], atol=1e-4)
        assert r["p_aux"] == 0.0                 # no moe layer

    def test_prefill_logits_and_cross_cache(self):
        r = run()
        np.testing.assert_allclose(r["p_prefill"], r["j_prefill"], atol=1e-4)
        # the same projection rounded to bfloat16 in both
        np.testing.assert_allclose(r["p_cross_k"], r["j_cross_k"],
                                   rtol=1e-2, atol=1e-3)
        assert np.abs(r["p_cross_k"]).max() > 0

    def test_decode_reads_the_cached_cross_keys(self):
        r = run()
        np.testing.assert_allclose(r["p_decode"], r["j_decode"], atol=1e-4)

    def test_the_cross_path_moves_the_logits(self):
        """With gate 0.5 and an image the logits differ from the same model
        with gate 0 (what a serve run sees)."""
        _, pcfg, _, pp = model()
        tokens, _, img = inputs()
        closed = dict(pp)
        closed["units"] = tree_map(lambda a: a, pp["units"])
        closed["units"]["cross"]["attn"]["gate"] = torch.zeros_like(
            pp["units"]["cross"]["attn"]["gate"])
        t = torch.from_numpy
        a, _, _ = port_lm.forward(pp, pcfg, {"tokens": t(tokens),
                                             "image_features": t(img)})
        b, _, _ = port_lm.forward(closed, pcfg, {"tokens": t(tokens),
                                                 "image_features": t(img)})
        assert float((a - b).abs().max()) > 1e-3

    @pytest.mark.parametrize("impl", ["reference", "cuda"])
    def test_attn_impls_agree_with_chunked(self, impl):
        """The non-causal cross prefill through the flash kernel's plain
        version (``cuda``) or the full scores gives the chunked path's."""
        _, pcfg, _, pp = model()
        tokens, _, img = inputs()
        t = torch.from_numpy
        batch = {"tokens": t(tokens), "image_features": t(img)}
        want, _, _ = port_lm.forward(pp, pcfg, batch)
        got, _, _ = port_lm.forward(
            pp, dataclasses.replace(pcfg, attn_impl=impl), batch)
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-5)

    def test_cross_prefill_takes_the_flash_kernel_non_causal(self,
                                                             monkeypatch):
        from repro_torch import kernels

        _, pcfg, _, pp = model()
        pcfg = dataclasses.replace(pcfg, attn_impl="cuda")
        seen = []
        inner = kernels.flash_attention

        def spy(q, k, v, **kw):
            seen.append((k.shape[1], kw["causal"]))
            return inner(q, k, v, **kw)

        monkeypatch.setattr(kernels, "flash_attention", spy)
        tokens, _, img = inputs()
        port_lm.ragged_prefill_step(
            pp, pcfg, {"tokens": torch.from_numpy(tokens),
                       "lengths": torch.from_numpy(LENGTHS),
                       "image_features": torch.from_numpy(img)},
            port_lm.make_caches(pcfg, B, T, device="cpu"))
        n_self = pcfg.cross_attn_every * port_lm.n_units(pcfg)
        assert seen.count((S, True)) == n_self
        assert seen.count((pcfg.n_image_tokens, False)) == port_lm.n_units(
            pcfg)


class TestCaches:
    def test_make_caches_and_specs_equal_reference(self):
        jcfg, pcfg = cfgs()
        want = ref_lm.make_caches(jcfg, 2, 16, as_structs=True)
        got = port_lm.make_caches(pcfg, 2, 16, device="cpu")
        assert jax.tree.map(lambda sd: (tuple(sd.shape), str(sd.dtype)),
                            want) == tree_map(
            lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
            got)
        assert port_lm.cache_specs(pcfg) == ref_lm.cache_specs(jcfg)

    def test_gather_concat_scatter_round_trip_on_the_nested_tree(self):
        _, pcfg = cfgs()
        c = port_lm.make_caches(pcfg, 4, 8, device="cpu")
        gen = torch.Generator().manual_seed(5)
        for leaf in tree_leaves(c):
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
        a = port_lm.gather_cache_rows(pcfg, [1], c)
        b = port_lm.gather_cache_rows(pcfg, [3], c)
        rows = port_lm.concat_cache_rows(pcfg, [a, b])
        u = rows["units"]
        assert u["kv"]["k"].shape[2] == 2 and u["cross"]["v"].shape[1] == 2
        assert port_lm.cache_row_nbytes(rows) == 2 * port_lm.cache_row_nbytes(a)
        fresh = port_lm.make_caches(pcfg, 4, 8, device="cpu")
        port_lm.scatter_cache_rows(pcfg, np.array([2, 4]), rows, fresh)
        f = fresh["units"]
        assert torch.equal(f["kv"]["v"][:, :, 2], c["units"]["kv"]["v"][:, :, 1])
        assert torch.equal(f["cross"]["k"][:, 2], c["units"]["cross"]["k"][:, 1])
        assert not f["kv"]["k"][:, :, [0, 1, 3]].any()
        assert not f["cross"]["k"][:, [0, 1, 3]].any()

    def test_paged_tables_are_refused(self):
        _, pcfg, _, pp = model()
        c = port_lm.make_caches(pcfg, 1, 8, device="cpu")
        with pytest.raises(ValueError, match="paged_tables"):
            port_lm.forward(pp, pcfg, {"tokens": torch.ones((1, 1),
                                                            dtype=torch.int32)},
                            c, cache_index=torch.tensor([0]),
                            paged_tables=torch.zeros((1, 1)))


class TestParams:
    def test_init_tree_matches_reference_and_round_trips(self):
        jcfg, pcfg = cfgs()
        jp = jax.tree.map(np.asarray, ref_lm.init(jcfg, jax.random.key(0)))
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(0), "cpu")
        shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
        assert isinstance(pp["units"]["selfs"], list)
        assert jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            convert.params_to_numpy(pp)) == shapes
        back = convert.params_to_numpy(convert.params_from_numpy(jp))
        jax.tree.map(np.testing.assert_array_equal, back, jp)
        assert pp["embed"]["img_proj"].shape == (pcfg.d_model, pcfg.d_model)

    def test_compute_params_walks_the_list(self):
        _, pcfg = cfgs(compute_dtype="bfloat16")
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(1), "cpu")
        cp = port_lm.compute_params(pcfg, pp)
        sel = cp["units"]["selfs"]
        assert len(sel) == pcfg.cross_attn_every
        assert all(s["attn"]["wq"].dtype == torch.bfloat16 for s in sel)
        assert all(s["ln1"]["scale"].dtype == torch.float32 for s in sel)
        assert cp["units"]["cross"]["attn"]["gate"].dtype == torch.bfloat16
        assert cp["embed"]["img_proj"].dtype == torch.bfloat16
        l0 = port_lm.layer_params(cp, 0)
        assert l0["selfs"][1]["attn"]["wk"].shape == \
            cp["units"]["selfs"][1]["attn"]["wk"].shape[1:]

    def test_cross_attention_decode_reads_the_cache(self):
        """One-token cross attention with a cache and no features reads the
        cached K/V (chunked path), gated by tanh(gate)."""
        _, pcfg, _, pp = model()
        p = port_lm.layer_params(pp, 0)["cross"]["attn"]
        rng = np.random.RandomState(9)
        x = torch.from_numpy(rng.standard_normal((2, 1, pcfg.d_model))
                             .astype(np.float32))
        feats = torch.from_numpy(rng.standard_normal(
            (2, pcfg.n_image_tokens, pcfg.d_model)).astype(np.float32))
        shape = (2, pcfg.n_image_tokens, pcfg.n_kv_heads, pcfg.head_dim)
        cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
        want, cache = port_attention.cross_attention(p, pcfg, x, feats, cache)
        got, _ = port_attention.cross_attention(p, pcfg, x, None, cache)
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-6)
        assert cache["k"].abs().max() > 0


class TestPagePool:
    """The page pool on vlm's nested tree: the self-attention K/V page
    (``units/kv/*``), the cross cache stays a residual slot-axis leaf
    (``units/cross/*``), as in the reference."""

    @staticmethod
    def pools(quantize):
        from repro.serving import pages as ref_pages
        from repro_torch.serving import PagePool

        jcfg, pcfg = cfgs()
        return (ref_pages.PagePool(jcfg, 2, 16, 4, n_pages=12,
                                   quantize=quantize),
                PagePool(pcfg, 2, 16, 4, n_pages=12, quantize=quantize))

    @pytest.mark.parametrize("quantize", [False, True])
    def test_specs_and_structs_match_reference(self, quantize):
        ref, port = self.pools(quantize)
        assert port.pool_specs() == ref.pool_specs()
        assert port.residual_specs() == ref.residual_specs()
        assert sorted(port.residual_specs()) == ["units/cross/k",
                                                 "units/cross/v"]
        for got, want in ((port.init_pool_arrays("cpu"),
                           ref.init_pool_arrays()),
                          (port.init_residual_arrays("cpu"),
                           ref.init_residual_arrays())):
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
        assert {k: s for k, (s, _) in port.residual_rows_struct(3).items()} \
            == {k: tuple(v.shape)
                for k, v in ref.residual_rows_struct(3).items()}

    @pytest.mark.parametrize("quantize", [False, True])
    def test_continuation_caches_and_view_match_reference(self, quantize):
        """Continuation caches hold the dequantized prefix pages and a
        fresh zero cross cache; the decode view gathers the pages and
        passes the residual cross leaves through."""
        ref, port = self.pools(quantize)
        rng = np.random.RandomState(11)
        jpool, ppool = ref.init_pool_arrays(), port.init_pool_arrays("cpu")
        for key, arr in jpool.items():
            if arr.dtype == jnp.int8:
                x = rng.randint(-127, 128, size=arr.shape).astype(np.int8)
                jpool[key], ppool[key] = jnp.asarray(x), torch.from_numpy(x)
            elif key.endswith("_scale"):
                x = rng.uniform(0.01, 0.1, size=arr.shape).astype(np.float32)
                jpool[key], ppool[key] = jnp.asarray(x), torch.from_numpy(x)
            else:
                x = rng.standard_normal(arr.shape).astype(np.float32)
                jpool[key] = jnp.asarray(x).astype(arr.dtype)
                ppool[key] = torch.from_numpy(x).to(torch.bfloat16)
        jres, pres = ref.init_residual_arrays(), port.init_residual_arrays(
            "cpu")
        for key in jres:
            x = rng.standard_normal(jres[key].shape).astype(np.float32)
            jres[key] = jnp.asarray(x).astype(jnp.bfloat16)
            pres[key] = torch.from_numpy(x).to(torch.bfloat16)
        prefix = np.array([[5, 2], [0, 3]], np.int32)
        want = ref.make_continuation_caches(jpool, jnp.asarray(prefix), 2, 12)
        got = port.make_continuation_caches(ppool, prefix, 2, 12)
        assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), want) == \
            tree_map(lambda a: (tuple(a.shape),
                                str(a.dtype).replace("torch.", "")), got)
        jax.tree.map(lambda w, g: np.testing.assert_array_equal(f32(g),
                                                                f32(w)),
                     want, got)
        assert not got["units"]["cross"]["k"].any()
        tables = np.array([[5, 2, -1, -1], [7, 0, 3, -1]], np.int32)
        want = ref.build_view(jpool, jres, jnp.asarray(tables))
        got = port.build_view(ppool, pres, tables)
        jax.tree.map(lambda w, g: np.testing.assert_array_equal(f32(g),
                                                                f32(w)),
                     want, got)
        assert torch.equal(got["units"]["cross"]["v"], pres["units/cross/v"])
