"""Port parity for the ssm (xlstm), hybrid (zamba2) and audio (hubert)
families on the CPU: the model (``repro_torch.models.lm``), the serving
engine's length-bucketed admission, disaggregated serving and the
launcher.

Models: ``reduced()`` of the three published configs (the reference's
reduction) at float32 compute, on the reference's parameters converted
leaf by leaf, through ``forward``, ``prefill_step`` and ``decode_step``.
Tolerances: logits, hidden states and the float32 state leaves within
1e-4 (the existing LM tests' bar for a whole stack; the blocks alone are
held to 1e-5 in ``tests/test_torch_mamba2_xlstm.py``: here the state of
a later layer carries the earlier layers' float32 matmul rounding, which
the two frameworks order differently, about 1e-5 on the hybrid's
convolution state after two decode steps); the hybrid's shared-attention KV cache is bfloat16 in both packages, so it
is held as ``tests/test_torch_lm.py`` holds the dense caches (one bf16
step allowed on at most 0.1 % of elements).

Serving: the reference's tiny fixtures (``tests/test_serving_api.py``
``TestRecurrentRagged`` and ``tests/test_disagg.py``: d_model 16, two
layers, chunk 8; three ragged prompts, 2 slots, ``max_len`` 32, 4 new
tokens).  Greedy and seeded tokens of the port's kernel path (the kernels'
plain versions on the CPU) must equal its per-request ``generate()`` and
the reference ``ServeEngine``'s, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.models.common import SSMConfig as RefSSMConfig
from repro.models.common import XLSTMConfig as RefXLSTMConfig
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.launch import serve as port_serve
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LMConfig, SSMConfig, XLSTMConfig
from repro_torch.serving import (DecodeEngine, PrefillEngine,
                                 PriorityScheduler, Request, ServeEngine,
                                 disaggregated_lm_engine)
from repro_torch.serving.disagg import _flatten
from torch_testlib import f32, lm_parity_bf16

torch.set_num_threads(1)

ARCHS = ("xlstm-1.3b", "zamba2-1.2b", "hubert-xlarge")
DECODING = ("xlstm-1.3b", "zamba2-1.2b")
ATOL = 1e-4
B, S, T = 2, 13, 32


# ---------------------------------------------------------------------------
# The reduced published configs
# ---------------------------------------------------------------------------


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(
                ref_configs.reduced(ref_configs.get_config(arch)), **kw),
            dataclasses.replace(
                port_configs.reduced(port_configs.get_config(arch)), **kw))


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jp = ref_lm.init(_cfgs(arch)[0], jax.random.key(0))
        _PARAMS[arch] = (jp, jax.tree.map(np.asarray, jp))
    jp, as_numpy = _PARAMS[arch]
    return jp, convert.params_from_numpy(as_numpy)


def _batch(arch, seed=3, s=S):
    rng = np.random.RandomState(seed)
    if arch == "hubert-xlarge":
        d = _cfgs(arch)[0].d_model
        return {"features": rng.standard_normal((B, s, d)).astype(np.float32)}
    return {"tokens": rng.randint(1, 128, (B, s)).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _bf16_step(x):
    """One bfloat16 step at the magnitude of ``x``."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


def _assert_leaf_close(got, want, name):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, name
    d = np.abs(got - want)
    off = d > ATOL * np.maximum(1.0, np.abs(want))
    assert off.mean() <= 1e-3, f"{name}: {off.sum()} elements differ"
    np.testing.assert_allclose(d[off], _bf16_step(want[off]), rtol=1e-6,
                               err_msg=str(name))


def _assert_caches_close(port_caches, ref_caches):
    got = dict(_flatten(port_caches))
    want = dict(_flatten(jax.tree.map(np.asarray, ref_caches)))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                           else torch.float32), path
        if g.dtype == torch.float32:
            np.testing.assert_allclose(f32(g), w, atol=ATOL, rtol=ATOL,
                                       err_msg=str(path))
        else:
            _assert_leaf_close(g, w, path)


class TestBFloat16:
    """The card's types, held against the reference on the CPU: bfloat16
    compute with float32 parameters (the leaves of ``lm.FLOAT32_KEYS`` read
    in float32), and bfloat16 parameters converted bit for bit.  Hidden
    states and the prefill and decode logits within four bf16 steps of each
    row's largest value (``torch_testlib.lm_parity_bf16``); the float32
    cases above keep their 1e-4."""

    @pytest.mark.parametrize("arch,param_dtype", [
        (a, d) for a in ARCHS for d in ("float32", "bfloat16")
        if a in DECODING or d == "float32"])
    def test_bf16_compute_matches_reference(self, arch, param_dtype):
        kw = dict(compute_dtype="bfloat16", param_dtype=param_dtype)
        jcfg, pcfg = _cfgs(arch, **kw)
        jp = ref_lm.init(jcfg, jax.random.key(0))
        pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
        lm_parity_bf16(jcfg, pcfg, jp, pp, _batch(arch),
                       b=B, t=T)


class TestConfigs:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_published_and_reduced_match_reference(self, arch):
        ref_cfg = ref_configs.get_config(arch)
        port_cfg = port_configs.get_config(arch)
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert (dataclasses.asdict(port_configs.reduced(port_cfg))
                == dataclasses.asdict(ref_configs.reduced(ref_cfg)))
        assert port_cfg.head_dim == ref_cfg.head_dim
        assert port_cfg.family in port_lm.SERVED_FAMILIES

    @pytest.mark.parametrize("arch,n_params", [
        ("xlstm-1.3b", 3_606_960_464), ("zamba2-1.2b", 1_170_473_856),
        ("hubert-xlarge", 946_557_440)])
    def test_published_parameter_counts(self, arch, n_params):
        """The port's definitions count the reference's parameters (the
        counts of ``lm.param_structs`` at the published sizes)."""
        cfg = port_configs.get_config(arch)
        assert port_lm.param_bytes(cfg) == 4 * n_params

    @pytest.mark.parametrize("arch,nbytes", [
        ("xlstm-1.3b", 5_660_742_912), ("zamba2-1.2b", 736_829_440)])
    def test_published_cache_bytes(self, arch, nbytes):
        """8 slots x 1024 positions: xlstm's float32 state, zamba2's Mamba-2
        state and shared-attention KV, as the reference's structs size
        them."""
        cfg = port_configs.get_config(arch)
        assert port_lm.cache_nbytes(cfg, 8, 1024) == nbytes
        structs = ref_lm.make_caches(ref_configs.get_config(arch), 8, 1024,
                                     as_structs=True)
        assert nbytes == sum(int(np.prod(x.shape)) * x.dtype.itemsize
                             for x in jax.tree.leaves(structs))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class TestModel:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("attn_impl", ["chunked", "cuda"])
    def test_forward_matches_reference(self, arch, attn_impl):
        """The whole stack's final hidden states (audio: non-causal
        attention over the ``frontend_proj`` stub's features)."""
        jcfg, pcfg = _cfgs(arch, attn_impl=attn_impl)
        jp, pp = _params(arch)
        batch = _batch(arch)
        xr, _, _ = ref_lm.forward(jp, _cfgs(arch)[0], _j(batch))
        xp, caches, _ = port_lm.forward(pp, pcfg, _t(batch))
        assert caches is None
        np.testing.assert_allclose(f32(xp), f32(xr), atol=ATOL, rtol=ATOL)

    def test_audio_attends_both_ways_through_flash(self, monkeypatch):
        """hubert's attention is bidirectional: with ``attn_impl="cuda"``
        every layer calls the flash wrapper non-causal, and a feature at
        the end of the clip moves the first frame's output."""
        from repro_torch import kernels

        _, pcfg = _cfgs("hubert-xlarge", attn_impl="cuda")
        _, pp = _params("hubert-xlarge")
        calls = []
        inner = kernels.flash_attention

        def watched(q, k, v, **kw):
            calls.append(kw["causal"])
            return inner(q, k, v, **kw)

        monkeypatch.setattr(kernels, "flash_attention", watched)
        batch = _t(_batch("hubert-xlarge"))
        x0, _, _ = port_lm.forward(pp, pcfg, batch)
        assert calls == [False] * pcfg.n_layers
        batch["features"][:, -1] += 1.0
        x1, _, _ = port_lm.forward(pp, pcfg, batch)
        assert float((x1[:, 0] - x0[:, 0]).abs().max()) > 1e-4

    @pytest.mark.parametrize("arch", DECODING)
    @pytest.mark.parametrize("attn_impl", ["chunked", "cuda"])
    def test_prefill_then_decode_match_reference(self, arch, attn_impl):
        """``prefill_step`` at a prime length, then two ``decode_step``s
        with a vector ``pos``: logits and every cache leaf."""
        jcfg, pcfg = _cfgs(arch, attn_impl=attn_impl)
        pcfg = dataclasses.replace(pcfg, decode_impl=(
            "cuda" if attn_impl == "cuda" else "chunked"))
        jp, pp = _params(arch)
        batch = _batch(arch)
        jc = ref_lm.make_caches(_cfgs(arch)[0], B, T)
        pc = port_lm.make_caches(pcfg, B, T, device="cpu")
        jl, jc = ref_lm.prefill_step(jp, _cfgs(arch)[0], _j(batch), jc)
        pl, pc2 = port_lm.prefill_step(pp, pcfg, _t(batch), pc)
        assert pc2 is pc                        # updated in place
        np.testing.assert_allclose(f32(pl), f32(jl), atol=ATOL, rtol=ATOL)
        _assert_caches_close(pc, jc)
        rng = np.random.RandomState(4)
        for step in range(2):
            nxt = rng.randint(1, 128, (B, 1)).astype(np.int32)
            pos = np.full((B,), S + step, np.int32)
            jl, jc = ref_lm.decode_step(
                jp, _cfgs(arch)[0], {"tokens": jnp.asarray(nxt),
                                     "pos": jnp.asarray(pos)}, jc)
            pl, pc = port_lm.decode_step(
                pp, pcfg, {"tokens": torch.from_numpy(nxt),
                           "pos": torch.from_numpy(pos)}, pc)
            np.testing.assert_allclose(f32(pl), f32(jl), atol=ATOL,
                                       rtol=ATOL)
        _assert_caches_close(pc, jc)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_caches_and_specs_match_reference(self, arch):
        """Tree, shapes and types of ``make_caches`` (float32 state, bf16
        KV; None for audio) and the logical axes of ``cache_specs``."""
        jcfg, pcfg = _cfgs(arch)
        structs = ref_lm.make_caches(jcfg, 3, T, as_structs=True)
        caches = port_lm.make_caches(pcfg, 3, T, device="cpu")
        assert port_lm.cache_specs(pcfg) == ref_lm.cache_specs(jcfg)
        if structs is None:
            assert caches is None and arch == "hubert-xlarge"
            return
        got = sorted(_flatten(caches), key=lambda pl: pl[0])
        want = sorted(_flatten(structs), key=lambda pl: pl[0])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape), path
            assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                               else torch.float32), path
        assert any(g.dtype == torch.float32 for _, g in got)
        assert port_lm.cache_nbytes(pcfg, 3, T) == port_lm.cache_row_nbytes(
            caches)

    @pytest.mark.parametrize("arch", DECODING)
    def test_row_movement_matches_reference(self, arch):
        """gather / concat / scatter of slot rows along each leaf's own
        batch axis, on a prefilled cache, each leaf in its own type."""
        jcfg, pcfg = _cfgs(arch)
        jp, pp = _params(arch)
        batch = _batch(arch)
        jc = ref_lm.make_caches(jcfg, B, T)
        pc = port_lm.make_caches(pcfg, B, T, device="cpu")
        _, jc = ref_lm.prefill_step(jp, jcfg, _j(batch), jc)
        port_lm.prefill_step(pp, pcfg, _t(batch), pc)
        jrows = ref_lm.concat_cache_rows(jcfg, [
            ref_lm.gather_cache_rows(jcfg, jnp.asarray([1]), jc),
            ref_lm.gather_cache_rows(jcfg, jnp.asarray([0]), jc)])
        prows = port_lm.concat_cache_rows(pcfg, [
            port_lm.gather_cache_rows(pcfg, [1], pc),
            port_lm.gather_cache_rows(pcfg, [0], pc)])
        _assert_caches_close(prows, jrows)
        # scatter the swapped rows into fresh caches of 3 slots at (2, 0),
        # with a pad row past the slots that must drop
        jdst = ref_lm.make_caches(jcfg, 3, T)
        pdst = port_lm.make_caches(pcfg, 3, T, device="cpu")
        pad = port_lm.concat_cache_rows(pcfg, [prows, port_lm.gather_cache_rows(
            pcfg, [0], prows)])
        jdst = ref_lm.scatter_cache_rows(jcfg, jnp.asarray([2, 0]), jrows,
                                         jdst)
        leaves = [x for _, x in _flatten(pdst)]
        out = port_lm.scatter_cache_rows(pcfg, [2, 0, 3], pad, pdst)
        assert all(a is b for a, (_, b) in zip(leaves, _flatten(out)))
        _assert_caches_close(pdst, jdst)
        assert port_lm.cache_row_nbytes(prows) == sum(
            int(np.prod(x.shape)) * x.dtype.itemsize
            for x in jax.tree.leaves(jrows))

    @pytest.mark.parametrize("arch", DECODING)
    def test_compute_params_keeps_the_float32_leaves(self, arch):
        """At bf16 compute the engine's cast keeps in float32 what the
        reference reads in float32 at each use: the recurrent gates, decay
        and skip terms, the blocks' inner norms and the norms; the
        projections become bf16."""
        _, pcfg = _cfgs(arch, compute_dtype="bfloat16")
        _, pp = _params(arch)
        cp = port_lm.compute_params(pcfg, pp)
        kept = {"a_log", "dt_bias", "d_skip", "norm_scale", "w_gates",
                "b_gates", "r_gates", "scale", "bias", "tok"}
        seen = set()
        for path, leaf in _flatten(cp):
            name = path[-1]
            if name == "tok_cd":
                assert leaf.dtype == torch.bfloat16
            elif name in kept:
                assert leaf.dtype == torch.float32, path
                seen.add(name)
            else:
                assert leaf.dtype == torch.bfloat16, path
        want = ({"a_log", "dt_bias", "d_skip", "norm_scale"} if arch ==
                "zamba2-1.2b" else {"w_gates", "b_gates", "r_gates",
                                    "norm_scale"})
        assert want <= seen

    @pytest.mark.parametrize("arch", DECODING)
    def test_what_stays_refused(self, arch):
        """A continuation prefill and paged decode are attention-family
        paths, as in the reference."""
        _, pcfg = _cfgs(arch)
        _, pp = _params(arch)
        batch = _t(_batch(arch))
        caches = port_lm.make_caches(pcfg, B, T, device="cpu")
        with pytest.raises(ValueError, match="attention families"):
            port_lm.forward(pp, pcfg, batch, caches, prefill_offset=4)
        with pytest.raises(ValueError, match="dense / moe"):
            port_lm.forward(pp, pcfg, batch, caches,
                            paged_tables=torch.zeros((B, 2)))


# ---------------------------------------------------------------------------
# Serving: the reference's tiny fixtures
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4]]
MAX_LEN = 32
MAX_NEW = 4
SAMPLING_KW = dict(temperature=0.8, top_k=8, top_p=0.95)
TRANSPORTS = ["in_process", "host_staged", "device_to_device"]
FAMILIES = ("ssm", "hybrid")


def tiny(cls_lm, cls_ssm, cls_xl, family):
    base = dict(arch_id="tiny-" + family, family=family, n_layers=2,
                d_model=16, n_heads=2, n_kv_heads=2, vocab=32, remat=False,
                compute_dtype="float32", param_dtype="float32")
    if family == "ssm":
        return cls_lm(**base, d_ff=0,
                      xlstm=cls_xl(slstm_every=2, chunk_size=8))
    return cls_lm(**base, d_ff=32, hybrid_attn_every=2,
                  ssm=cls_ssm(d_state=4, d_conv=4, expand=2, head_dim=8,
                              n_groups=1, chunk_size=8))


_TINY = {}


def tiny_params(family):
    if family not in _TINY:
        _TINY[family] = ref_lm.init(
            tiny(RefLMConfig, RefSSMConfig, RefXLSTMConfig, family),
            jax.random.key(0))
    return _TINY[family]


def tiny_cfg(family, **kw):
    return dataclasses.replace(tiny(LMConfig, SSMConfig, XLSTMConfig,
                                    family), **kw)


def engine(family, kernels=True, cls=ServeEngine, **kw):
    kw.setdefault("n_slots", 2)
    cfg = tiny_cfg(family, attn_impl="cuda" if kernels else "chunked")
    return cls(cfg, convert.params_from_numpy(
        jax.tree.map(np.asarray, tiny_params(family))), max_len=MAX_LEN,
        decode_kernel=kernels, device="cpu", **kw)


def _requests(cls, seeded=False, prompts=PROMPTS, **kw):
    extra = dict(SAMPLING_KW) if seeded else {}
    return [cls(prompt=list(p), max_new_tokens=MAX_NEW, rid=i,
                **({"seed": 1000 + i} if seeded else {}), **extra, **kw)
            for i, p in enumerate(prompts)]


def serve_tokens(eng, cls=Request, seeded=False):
    return {c.rid: list(c.tokens) for c in eng.serve(_requests(cls, seeded))}


def ref_tokens(family, seeded=False):
    key = (family, seeded)
    if key not in _TINY:
        eng = RefServeEngine(tiny(RefLMConfig, RefSSMConfig, RefXLSTMConfig,
                                  family), tiny_params(family), n_slots=2,
                             max_len=MAX_LEN)
        _TINY[key] = serve_tokens(eng, RefRequest, seeded)
    return _TINY[key]


class TestServing:
    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("kernels", [True, False])
    def test_ragged_serve_matches_generate_and_reference(self, family,
                                                         kernels):
        """Length-bucketed admission: no pad token enters a recurrent
        state, so ragged serving equals per-request ``generate()`` and the
        reference engine, token for token."""
        eng = engine(family, kernels)
        got = serve_tokens(eng)
        assert got == ref_tokens(family)
        for i, p in enumerate(PROMPTS):
            assert eng.generate([p], max_new_tokens=MAX_NEW)[0] == got[i]

    @pytest.mark.parametrize("family", FAMILIES)
    def test_seeded_draws_match_reference(self, family):
        got = serve_tokens(engine(family), seeded=True)
        assert got == ref_tokens(family, seeded=True)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_admission_prefills_each_length_without_pad(self, family):
        """Every prefill group holds prompts of one length and no pad
        column; pad rows (past the slots) are whole rows that drop."""
        eng = engine(family, n_slots=4)
        seen = []
        inner = eng._prefill_scatter

        def watched(sh, tokens, lengths, slot_idx, caches):
            # host arrays, or (staged) the call's slices of its buffer
            seen.append((tuple(tokens.shape), np.array(lengths),
                         np.array(slot_idx)))
            return inner(sh, tokens, lengths, slot_idx, caches)

        eng._prefill_scatter = watched
        prompts = PROMPTS + [[7, 7, 7]]
        comps = eng.serve(_requests(Request, prompts=prompts))
        assert len(comps) == 4
        assert len(seen) == 3                   # lengths 2, 3 (twice), 7
        for (nb, width), lengths, slots in seen:
            real = slots < eng.capacity
            assert (lengths[real] == width).all()
            assert nb == 1 << (int(real.sum()) - 1).bit_length()
        assert sorted(int(w) for (_, w), _, _ in seen) == [2, 3, 7]

    @pytest.mark.parametrize("family", FAMILIES)
    def test_generate_refuses_a_ragged_batch(self, family):
        eng = engine(family)
        with pytest.raises(ValueError, match="ragged"):
            eng.generate(PROMPTS, max_new_tokens=2)
        out = eng.generate([[1, 2, 3], [4, 5, 6]], max_new_tokens=3)
        assert out == [eng.generate([p], max_new_tokens=3)[0]
                       for p in ([1, 2, 3], [4, 5, 6])]

    @pytest.mark.parametrize("family", FAMILIES)
    def test_priority_preemption_is_lossless(self, family):
        """The victim's state rows are gathered out on eviction and
        scattered back on resume: its tokens are the undisturbed run's."""
        victim = dict(prompt=[1, 2, 3], max_new_tokens=8, rid=0, seed=42,
                      priority=1, **SAMPLING_KW)
        [c] = engine(family, n_slots=1, scheduler=PriorityScheduler()).serve(
            [Request(**victim)])
        eng = engine(family, n_slots=1, scheduler=PriorityScheduler())
        eng.submit(Request(**victim))
        eng.tick()
        eng.tick()
        eng.submit(Request(prompt=[9, 9], max_new_tokens=2, rid=1, seed=43,
                           priority=0, **SAMPLING_KW))
        comps = {c.rid: list(c.tokens) for c in eng.run_until_idle()}
        assert eng.stats().preempted >= 1
        assert comps[0] == list(c.tokens)

    @pytest.mark.parametrize("family", FAMILIES)
    @pytest.mark.parametrize("transport", TRANSPORTS)
    def test_disaggregated_matches_unified(self, family, transport):
        """A prefill engine and two decode engines joined by handoffs of
        float32 state rows give the unified engine's tokens."""
        cfg = tiny_cfg(family, attn_impl="cuda")
        params = convert.params_from_numpy(
            jax.tree.map(np.asarray, tiny_params(family)))
        eng = disaggregated_lm_engine(cfg, params, n_slots=2,
                                      max_len=MAX_LEN, n_decode=2,
                                      transport=transport,
                                      decode_kernel=True, device="cpu")
        assert serve_tokens(eng) == ref_tokens(family)
        st = eng.stats()
        assert st.transfer[f"{transport}/total"].count == len(PROMPTS)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_handoff_carries_float32_state(self, family):
        """A handoff's rows are the slot's state leaves in their own types
        (one slot each); a decode engine takes them, and refuses the same
        rows cast to bf16."""
        pre = engine(family, cls=PrefillEngine)
        [h] = pre.serve(_requests(Request, prompts=[[3, 1, 4, 1, 5]]))
        dec = engine(family, cls=DecodeEngine)
        dec.validate_handoff(h)
        leaves = _flatten(h.rows)
        assert any(x.dtype == torch.float32 for _, x in leaves)
        for path, x in leaves:
            assert 1 in x.shape, path
        bad = dataclasses.replace(h, rows=_copy_tree(h.rows))
        path = next(p for p, x in leaves if x.dtype == torch.float32)
        node = bad.rows
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]].to(torch.bfloat16)
        with pytest.raises(ValueError, match="dtype"):
            dec.validate_handoff(bad)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_what_the_engine_refuses(self, family):
        with pytest.raises(ValueError, match="recurrent"):
            engine(family, page_size=8)

    def test_engine_refuses_the_encoder(self):
        _, pcfg = _cfgs("hubert-xlarge")
        _, pp = _params("hubert-xlarge")
        with pytest.raises(ValueError, match="no decode path"):
            ServeEngine(pcfg, pp, device="cpu")


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


class TestLauncher:
    @pytest.mark.parametrize("arch,extra", [
        ("xlstm-1.3b", ["--decode-kernel", "--attn-impl", "cuda"]),
        ("zamba2-1.2b", ["--decode-kernel", "--attn-impl", "cuda"]),
        ("xlstm-1.3b", ["--scheduler", "disagg", "--transport",
                        "host_staged"]),
        ("zamba2-1.2b", ["--scheduler", "disagg", "--decode-kernel"])])
    def test_serves_the_recurrent_families_on_the_cpu(self, capsys, arch,
                                                       extra):
        port_serve.main(["--arch", arch, "--requests", "3", "--max-new", "4",
                         "--device", "cpu"] + extra)
        assert f"[{arch}] on cpu: served 3 requests (12 new tokens)" in \
            capsys.readouterr().out

    @pytest.mark.parametrize("extra", [[], ["--trace", "bursty"]])
    def test_refuses_the_encoder(self, extra):
        with pytest.raises(SystemExit, match="encoder-only arch has no "
                                             "decode path"):
            port_serve.main(["--arch", "hubert-xlarge", "--device", "cpu"]
                            + extra)

    def test_check_fits_counts_the_recurrent_state(self):
        """xlstm-1.3b's float32 parameters and bf16 copy (21.6 GB) fit a
        card with 25 GB free; its 8 slots of float32 state (5.66 GB) on
        top do not."""
        cfg = port_configs.get_config("xlstm-1.3b")
        params = port_serve.param_bytes_served(cfg)
        state = port_lm.cache_nbytes(cfg, 8, 1024)
        free = 25_000_000_000
        assert params < free < params + state
        port_serve.check_fits(cfg, free)
        with pytest.raises(SystemExit, match=f"{params + state:,} bytes"):
            port_serve.check_fits(cfg, free, 8, 1024)
