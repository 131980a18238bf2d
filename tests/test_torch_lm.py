"""Port parity for the dense LM (``repro_torch.models``) on the CPU.

``reduced(llama3.2-1b)`` and ``reduced(qwen3-1.7b)`` (qk-norm, head dim 16)
run in both packages on the reference's parameters, converted leaf by leaf.

Tolerances.  float32 compute: logits within 1e-4, cache rows within 1e-5.
The caches are bfloat16 in both packages (as the reference makes them), so
a float32 K/V value that lands within float32 rounding of a bfloat16
rounding boundary can round the other way; the cache check allows exactly
one bfloat16 step on at most 0.1 % of elements, and the logits checks use a
draw in which no value decoded against lands on such a boundary.  bfloat16
compute: the two frameworks round the projections' and the attention's
bfloat16 products at other places, so logits (whose range is about 60 in the
reduced llama: the tied table is N(0, 1)) agree within 0.25 and the argmax
agrees wherever its margin is clear of that.
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
from repro_torch.models import common as port_common
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LMConfig
from torch_testlib import f32

torch.set_num_threads(1)

ARCHS = ("llama3.2-1b", "qwen3-1.7b")
B, S, T = 3, 8, 16
LENGTHS = np.array([8, 5, 3], np.int32)
DRAW = 3          # input draw: see the module docstring


def _cfgs(arch, **kw):
    return (dataclasses.replace(ref_configs.reduced(
                ref_configs.get_config(arch)), **kw),
            dataclasses.replace(port_configs.reduced(
                port_configs.get_config(arch)), **kw))


def _inputs(seed=DRAW):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(1, 128, (B, S)).astype(np.int32)
    nxt = rng.randint(1, 128, (B, 1)).astype(np.int32)
    return tokens, nxt


_RUNS = {}


def _run(arch, compute_dtype):
    """Both packages through forward, ragged prefill, a vector-pos decode,
    a continuation prefill and a scalar-pos decode; cached per module."""
    key = (arch, compute_dtype)
    if key in _RUNS:
        return _RUNS[key]
    jcfg, pcfg = _cfgs(arch, compute_dtype=compute_dtype)
    jp = ref_lm.init(jcfg, jax.random.key(0))
    pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens, nxt = _inputs()
    out = {}

    # reference
    x, _, _ = ref_lm.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    out["j_forward"] = f32(ref_lm.common.unembed(jp["embed"], jcfg, x))
    jl, jc = ref_lm.ragged_prefill_step(
        jp, jcfg, {"tokens": jnp.asarray(tokens),
                   "lengths": jnp.asarray(LENGTHS)},
        ref_lm.make_caches(jcfg, B, T))
    out["j_prefill"], out["j_prefill_k"] = f32(jl), f32(jc["kv"]["k"])
    out["j_prefill_v"] = f32(jc["kv"]["v"])
    jl, jc = ref_lm.decode_step(jp, jcfg, {"tokens": jnp.asarray(nxt),
                                           "pos": jnp.asarray(LENGTHS)}, jc)
    out["j_decode"], out["j_decode_v"] = f32(jl), f32(jc["kv"]["v"])
    jl, jc2 = ref_lm.continuation_prefill_step(
        jp, jcfg, {"tokens": jnp.asarray(tokens[:, :4]),
                   "lengths": jnp.asarray(np.array([4, 2, 1], np.int32))},
        ref_lm.make_caches(jcfg, B, T), offset=0)
    jl, jc2 = ref_lm.continuation_prefill_step(
        jp, jcfg, {"tokens": jnp.asarray(tokens[:, 4:]),
                   "lengths": jnp.asarray(np.array([4, 4, 4], np.int32))},
        jc2, offset=4)
    out["j_cont"] = f32(jl)
    jl, _ = ref_lm.decode_step(jp, jcfg, {"tokens": jnp.asarray(nxt),
                                          "pos": jnp.asarray(8, jnp.int32)},
                               jc2)
    out["j_scalar"] = f32(jl)

    # port
    t = torch.from_numpy
    x, _, _ = port_lm.forward(pp, pcfg, {"tokens": t(tokens)})
    out["p_forward"] = f32(port_common.unembed(pp["embed"], pcfg, x))
    pl, pc = port_lm.ragged_prefill_step(
        pp, pcfg, {"tokens": t(tokens), "lengths": t(LENGTHS)},
        port_lm.make_caches(pcfg, B, T, device="cpu"))
    out["p_prefill"], out["p_prefill_k"] = f32(pl), f32(pc["kv"]["k"])
    out["p_prefill_v"] = f32(pc["kv"]["v"])
    pl, pc = port_lm.decode_step(pp, pcfg, {"tokens": t(nxt),
                                            "pos": t(LENGTHS)}, pc)
    out["p_decode"], out["p_decode_v"] = f32(pl), f32(pc["kv"]["v"])
    _, pc2 = port_lm.continuation_prefill_step(
        pp, pcfg, {"tokens": t(tokens[:, :4]),
                   "lengths": t(np.array([4, 2, 1], np.int32))},
        port_lm.make_caches(pcfg, B, T, device="cpu"), offset=0)
    pl, pc2 = port_lm.continuation_prefill_step(
        pp, pcfg, {"tokens": t(tokens[:, 4:]),
                   "lengths": t(np.array([4, 4, 4], np.int32))},
        pc2, offset=4)
    out["p_cont"] = f32(pl)
    pl, _ = port_lm.decode_step(pp, pcfg, {"tokens": t(nxt), "pos": 8}, pc2)
    out["p_scalar"] = f32(pl)
    _RUNS[key] = out
    return out


def _bf16_step(x):
    """One bfloat16 rounding step at each value's magnitude."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


def _assert_cache_close(got, want):
    d = np.abs(got - want)
    off = d > 1e-5
    assert off.mean() <= 1e-3, f"{off.sum()} cache elements differ"
    np.testing.assert_allclose(d[off], _bf16_step(want[off]), rtol=1e-6)


class TestConfigs:
    def test_archs(self):
        assert port_configs.list_archs() == [
            "llama3.2-1b", "qwen3-1.7b", "capsnet-mnist", "capsnet-fmnist"]
        for arch in port_configs.LM_ARCHS:
            assert arch in ref_configs.list_archs()

    @pytest.mark.parametrize("arch", ARCHS)
    def test_published_and_reduced_match_reference(self, arch):
        ref_cfg = ref_configs.get_config(arch)
        port_cfg = port_configs.get_config(arch)
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert (dataclasses.asdict(port_configs.reduced(port_cfg))
                == dataclasses.asdict(ref_configs.reduced(ref_cfg)))
        assert port_cfg.head_dim == ref_cfg.head_dim

    def test_lmconfig_has_every_reference_field(self):
        from repro.models.common import LMConfig as RefLMConfig

        assert ([f.name for f in dataclasses.fields(LMConfig)]
                == [f.name for f in dataclasses.fields(RefLMConfig)])


class TestParams:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_tree_matches_reference_and_round_trips(self, arch):
        jcfg, pcfg = _cfgs(arch)
        jp = jax.tree.map(np.asarray, ref_lm.init(jcfg, jax.random.key(0)))
        gen = torch.Generator().manual_seed(0)
        pp = port_lm.init(pcfg, gen, "cpu")
        shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
        assert convert.params_to_numpy(pp).keys() == jp.keys()
        assert jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            convert.params_to_numpy(pp)) == shapes
        back = convert.params_to_numpy(convert.params_from_numpy(jp))
        jax.tree.map(np.testing.assert_array_equal, back, jp)

    def test_init_draws_per_unit_with_declared_fan_in(self):
        _, pcfg = _cfgs("llama3.2-1b")
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(1), "cpu")
        wq = pp["units"]["block"]["attn"]["wq"]          # (L, d, H, hd)
        assert wq.shape[0] == pcfg.n_layers
        assert not torch.equal(wq[0], wq[1])
        std = 1.0 / np.sqrt(pcfg.d_model)
        assert float(wq.abs().max()) <= 2 * std + 1e-6
        assert torch.equal(pp["units"]["block"]["ln1"]["scale"],
                           torch.ones(pcfg.n_layers, pcfg.d_model))

    def test_compute_params_casts_once_with_the_same_values(self):
        _, pcfg = _cfgs("llama3.2-1b")
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(2), "cpu")
        cp = port_lm.compute_params(pcfg, pp)
        assert cp["embed"]["tok"].dtype == torch.float32
        assert cp["embed"]["tok_cd"].dtype == torch.bfloat16
        assert cp["final_ln"]["scale"].dtype == torch.float32
        assert cp["units"]["block"]["ln2"]["scale"].dtype == torch.float32
        assert cp["units"]["block"]["attn"]["wq"].dtype == torch.bfloat16
        tokens = torch.from_numpy(_inputs()[0])
        a, _, _ = port_lm.forward(pp, pcfg, {"tokens": tokens})
        b, _, _ = port_lm.forward(cp, pcfg, {"tokens": tokens})
        assert torch.equal(a, b)
        assert torch.equal(port_common.unembed(pp["embed"], pcfg, a),
                           port_common.unembed(cp["embed"], pcfg, b))


class TestFloat32:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_forward_logits(self, arch):
        r = _run(arch, "float32")
        np.testing.assert_allclose(r["p_forward"], r["j_forward"], atol=1e-4)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_ragged_prefill_logits_and_cache(self, arch):
        r = _run(arch, "float32")
        np.testing.assert_allclose(r["p_prefill"], r["j_prefill"], atol=1e-4)
        _assert_cache_close(r["p_prefill_k"], r["j_prefill_k"])
        _assert_cache_close(r["p_prefill_v"], r["j_prefill_v"])

    @pytest.mark.parametrize("arch", ARCHS)
    def test_vector_pos_decode(self, arch):
        r = _run(arch, "float32")
        np.testing.assert_allclose(r["p_decode"], r["j_decode"], atol=1e-4)
        _assert_cache_close(r["p_decode_v"], r["j_decode_v"])

    @pytest.mark.parametrize("arch", ARCHS)
    def test_continuation_prefill_and_scalar_pos_decode(self, arch):
        r = _run(arch, "float32")
        np.testing.assert_allclose(r["p_cont"], r["j_cont"], atol=1e-4)
        np.testing.assert_allclose(r["p_scalar"], r["j_scalar"], atol=1e-4)

    @pytest.mark.parametrize("impl", ["reference", "cuda"])
    def test_attn_impls_agree_with_chunked(self, impl):
        """``reference`` (full scores) and ``cuda`` (the flash kernel's plain
        version on the CPU) give the chunked path's prefill."""
        _, pcfg = _cfgs("qwen3-1.7b", compute_dtype="float32")
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(3), "cpu")
        tokens = torch.from_numpy(_inputs()[0])
        want, _, _ = port_lm.forward(pp, pcfg, {"tokens": tokens})
        got, _, _ = port_lm.forward(
            pp, dataclasses.replace(pcfg, attn_impl=impl), {"tokens": tokens})
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-5)

    @pytest.mark.parametrize("mode", ["exact", "taylor"])
    def test_decode_kernel_path_agrees_with_chunked(self, mode):
        _, pcfg = _cfgs("llama3.2-1b", compute_dtype="float32",
                        softmax_mode=mode)
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(4), "cpu")
        tokens, nxt = (torch.from_numpy(a) for a in _inputs())
        logits = {}
        for impl in ("chunked", "cuda"):
            cfg = dataclasses.replace(pcfg, decode_impl=impl)
            _, c = port_lm.ragged_prefill_step(
                pp, cfg, {"tokens": tokens, "lengths": torch.from_numpy(LENGTHS)},
                port_lm.make_caches(cfg, B, T, device="cpu"))
            logits[impl], _ = port_lm.decode_step(
                pp, cfg, {"tokens": nxt, "pos": torch.from_numpy(LENGTHS)}, c)
        np.testing.assert_allclose(f32(logits["cuda"]), f32(logits["chunked"]),
                                   atol=1e-4)


class TestBFloat16:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_prefill_and_decode_logits(self, arch):
        r = _run(arch, "bfloat16")
        for step in ("forward", "prefill", "decode", "cont", "scalar"):
            got, want = r["p_" + step], r["j_" + step]
            np.testing.assert_allclose(got, want, atol=0.25, err_msg=step)
            top2 = np.sort(want, axis=-1)[..., -2:]
            clear = (top2[..., 1] - top2[..., 0]) > 0.5
            np.testing.assert_array_equal(got.argmax(-1)[clear],
                                          want.argmax(-1)[clear])


class TestCaches:
    def test_make_caches_shapes_and_type(self):
        _, pcfg = _cfgs("qwen3-1.7b", compute_dtype="float32")
        c = port_lm.make_caches(pcfg, 3, 16, device="cpu")
        assert c["kv"]["k"].shape == (pcfg.n_layers, 3, 16, pcfg.n_kv_heads,
                                      pcfg.head_dim)
        assert c["kv"]["v"].dtype == torch.bfloat16
        moe = dataclasses.replace(pcfg, family="moe")
        assert port_lm.make_caches(moe, 1, 4, device="cpu")["kv"]["k"].shape[1] == 1
        with pytest.raises(NotImplementedError):
            port_lm.make_caches(dataclasses.replace(pcfg, family="ssm"), 1, 4)
        assert port_lm.cache_specs(pcfg) == ref_lm.cache_specs(
            ref_configs.reduced(ref_configs.get_config("qwen3-1.7b")))

    def test_gather_concat_scatter_round_trip(self):
        _, pcfg = _cfgs("llama3.2-1b")
        c = port_lm.make_caches(pcfg, 4, 8, device="cpu")
        for leaf in (c["kv"]["k"], c["kv"]["v"]):
            leaf.copy_(torch.randn(leaf.shape, generator=torch.Generator()
                                   .manual_seed(5)))
        a = port_lm.gather_cache_rows(pcfg, [1], c)
        b = port_lm.gather_cache_rows(pcfg, [3], c)
        rows = port_lm.concat_cache_rows(pcfg, [a, b])
        assert rows["kv"]["k"].shape[1] == 2
        assert port_lm.cache_row_nbytes(rows) == 2 * port_lm.cache_row_nbytes(a)
        fresh = port_lm.make_caches(pcfg, 4, 8, device="cpu")
        # slot 4 is past the caches: its row (a pad row) is dropped
        port_lm.scatter_cache_rows(
            pcfg, np.array([2, 4]), rows, fresh)
        assert torch.equal(fresh["kv"]["k"][:, 2], c["kv"]["k"][:, 1])
        assert not fresh["kv"]["k"][:, [0, 1, 3]].any()
        with pytest.raises(ValueError, match="empty"):
            port_lm.concat_cache_rows(pcfg, [])

    def test_decode_write_past_the_cache_is_dropped(self):
        _, pcfg = _cfgs("llama3.2-1b", compute_dtype="float32")
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(6), "cpu")
        c = port_lm.make_caches(pcfg, 2, 4, device="cpu")
        logits, c = port_lm.decode_step(
            pp, pcfg, {"tokens": torch.tensor([[3], [4]]),
                       "pos": torch.tensor([1, 4])}, c)
        assert torch.isfinite(logits).all()
        assert c["kv"]["k"][:, 0, 1].any() and not c["kv"]["k"][:, 1].any()

    def test_paged_and_other_families_raise(self):
        _, pcfg = _cfgs("llama3.2-1b")
        pp = port_lm.init(pcfg, torch.Generator().manual_seed(7), "cpu")
        tokens = torch.ones((1, 2), dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="paged slice"):
            port_lm.forward(pp, pcfg, {"tokens": tokens},
                            paged_tables=torch.zeros((1, 1)))
        with pytest.raises(NotImplementedError, match="paged slice"):
            port_attention.self_attention(
                pp["units"]["block"]["attn"], pcfg,
                torch.zeros(1, 1, pcfg.d_model), torch.zeros(1, 1),
                cache={"k": None, "v": None, "k_scale": None})
        with pytest.raises(NotImplementedError, match="dense family"):
            port_lm.forward(pp, dataclasses.replace(pcfg, family="vlm"),
                            {"tokens": tokens})
        with pytest.raises(ValueError, match="attn_impl"):
            port_lm.forward(pp, dataclasses.replace(pcfg, attn_impl="pallas"),
                            {"tokens": tokens})
