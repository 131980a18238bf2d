"""The reference's serving gate, run on the port's ``ServeEngine`` for the
dense, vlm and moe families on the CPU.

Fixtures are the reference's ``tests/test_decode_kernels.py`` ones (tiny
float32 models of each family: 2 layers, vlm 3 layers as 2 self-attention
blocks and a cross block with 8 image tokens, moe 4 experts top-2; three
ragged prompts, 2 slots, ``max_len`` 32, 4 new tokens, pages of 8 rows),
with the reference's parameters converted leaf by leaf.  For each family
and cache (dense slots, bf16 pages, int8 pages), greedy tokens of the
port's kernel path (``decode_kernel=True``, ``attn_impl="cuda"``: the
kernels' plain versions on the CPU) must equal:

* the port's per-request ``generate()`` and its chunked path;
* the reference ``ServeEngine``'s on the same parameters (its own gate holds
  its kernel path equal to its chunked path).

The vlm and moe families are then served disaggregated under each
transport (the reference's ``tests/test_disagg.py`` matrix), and a vlm
handoff is shown to carry its nested ``{"units": {"kv", "cross"}}`` tree
(or its pages and the cross cache as residual rows) whole.  Last, the
reference's ragged-moe case (``tests/test_traffic.py``): with capacity
drops forced, a prompt served in a ragged batch gets the tokens it gets
alone.  Each reference engine runs once per module.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.models.common import MoEConfig as RefMoEConfig
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert
from repro_torch.models.common import LMConfig, MoEConfig
from repro_torch.serving import (CacheHandoff, DecodeEngine, HandoffRequest,
                                 PrefillEngine, Request, ServeEngine,
                                 disaggregated_lm_engine, make_transport)
from repro_torch.serving.disagg import _flatten

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4]]
TRANSPORTS = ["in_process", "host_staged", "device_to_device"]
PAGE = 8
MAX_LEN = 32
MAX_NEW = 4
CACHE_MODES = {"dense": {}, "paged": dict(page_size=PAGE),
               "paged_int8": dict(page_size=PAGE, quantize_pages=True)}


def _base(family, **kw):
    base = dict(arch_id="tiny-" + family, family=family, n_layers=2,
                d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                remat=False, compute_dtype="float32", param_dtype="float32")
    base.update(kw)
    return base


def cfgs(family):
    """(reference config, port config) of ``cfg_for(family)``."""
    if family == "dense":
        kw = {}
    elif family == "vlm":
        kw = dict(n_layers=3, cross_attn_every=2, n_image_tokens=8)
    else:
        moe = dict(n_experts=4, top_k=2, d_expert=32)
        return (RefLMConfig(**_base("moe"), moe=RefMoEConfig(**moe)),
                LMConfig(**_base("moe"), moe=MoEConfig(**moe)))
    return RefLMConfig(**_base(family, **kw)), LMConfig(**_base(family, **kw))


_REF = {}


def ref_params(family):
    if ("params", family) not in _REF:
        _REF[("params", family)] = ref_lm.init(cfgs(family)[0],
                                               jax.random.key(0))
    return _REF[("params", family)]


def port_params(family):
    return convert.params_from_numpy(
        jax.tree.map(np.asarray, ref_params(family)))


def port_cfg(family, **kw):
    return dataclasses.replace(cfgs(family)[1], **kw)


def serve_tokens(eng, request_cls=Request, prompts=PROMPTS):
    comps = eng.serve([request_cls(prompt=list(p), max_new_tokens=MAX_NEW,
                                   rid=i) for i, p in enumerate(prompts)])
    return {c.rid: list(c.tokens) for c in comps}


def ref_tokens(family, cache):
    key = ("tokens", family, cache)
    if key not in _REF:
        eng = RefServeEngine(cfgs(family)[0], ref_params(family), n_slots=2,
                             max_len=MAX_LEN, **CACHE_MODES[cache])
        _REF[key] = serve_tokens(eng, RefRequest)
    return _REF[key]


def engine(family, cache="dense", kernels=True, **kw):
    cfg = port_cfg(family, attn_impl="cuda" if kernels else "chunked")
    return ServeEngine(cfg, port_params(family), n_slots=2, max_len=MAX_LEN,
                       decode_kernel=kernels, device="cpu",
                       **CACHE_MODES[cache], **kw)


@pytest.mark.parametrize("family", ["dense", "vlm", "moe"])
@pytest.mark.parametrize("cache", sorted(CACHE_MODES))
def test_kernel_matches_generate_chunked_and_reference(family, cache):
    kern = serve_tokens(engine(family, cache))
    gen = engine(family, kernels=False)
    for i, p in enumerate(PROMPTS):
        assert gen.generate([p], max_new_tokens=MAX_NEW)[0] == kern[i], \
            (family, cache, i)
    assert serve_tokens(engine(family, cache, kernels=False)) == kern
    assert kern == ref_tokens(family, cache)


@pytest.mark.parametrize("family", ["vlm", "moe"])
def test_paged_kernel_decode_route(family, monkeypatch):
    """moe pages are read in place by the paged decode body; vlm decodes a
    gathered view through the dense body, as the reference does."""
    from repro_torch import kernels

    eng = engine(family, "paged")
    bodies = []
    inner = kernels.decode_attention

    def spy(*args, tables=None, **kw):
        bodies.append(tables is not None)
        return inner(*args, tables=tables, **kw)

    monkeypatch.setattr(kernels, "decode_attention", spy)
    serve_tokens(eng)
    assert bodies and all(bodies) == (family == "moe")
    assert any(bodies) == (family == "moe")


@pytest.mark.parametrize("family", ["vlm", "moe"])
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_disaggregated_matches_generate_under_every_transport(family,
                                                              transport):
    eng = disaggregated_lm_engine(
        port_cfg(family, attn_impl="cuda"), port_params(family), n_slots=2,
        max_len=MAX_LEN, n_decode=2, transport=transport,
        decode_kernel=True, device="cpu")
    got = serve_tokens(eng)
    assert got == ref_tokens(family, "dense")
    gen = engine(family, kernels=False)
    for i, p in enumerate(PROMPTS):
        assert gen.generate([p], max_new_tokens=MAX_NEW)[0] == got[i]
    assert eng.stats().transfer[f"{transport}/total"].count == len(PROMPTS)


@pytest.mark.parametrize("family", ["vlm", "moe"])
@pytest.mark.parametrize("cache", ["paged", "paged_int8"])
def test_paged_disaggregated_matches_unified(family, cache):
    eng = disaggregated_lm_engine(
        port_cfg(family, attn_impl="cuda"), port_params(family), n_slots=2,
        max_len=MAX_LEN, n_decode=2, transport="host_staged",
        decode_kernel=True, device="cpu", **CACHE_MODES[cache])
    got = serve_tokens(eng)
    assert got == serve_tokens(engine(family, cache))
    assert eng.stats().pages["handoff_pages_moved"] > 0


def _vlm_handoff(cache):
    cfg = port_cfg("vlm")
    pre = PrefillEngine(cfg, port_params("vlm"), n_slots=2, max_len=MAX_LEN,
                        device="cpu", **CACHE_MODES[cache])
    pre.submit(Request(prompt=[1, 2, 3], max_new_tokens=MAX_NEW))
    (h,) = pre.run_until_idle()
    assert isinstance(h, CacheHandoff) and h.family == "vlm"
    return cfg, h


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("cache", ["dense", "paged"])
def test_vlm_handoff_moves_the_nested_tree_whole(cache, transport):
    cfg, h = _vlm_handoff(cache)
    leaves = dict(_flatten(h.rows))
    if cache == "dense":
        assert sorted(leaves) == [("units", "cross", "k"),
                                  ("units", "cross", "v"),
                                  ("units", "kv", "k"), ("units", "kv", "v")]
        assert tuple(leaves[("units", "kv", "k")].shape) == (
            1, cfg.cross_attn_every, 1, MAX_LEN, cfg.n_kv_heads,
            cfg.head_dim)
        assert tuple(leaves[("units", "cross", "v")].shape) == (
            1, 1, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
        assert float(leaves[("units", "kv", "k")].abs().sum()) > 0
    else:
        assert sorted(h.rows["pages"]) == ["units/kv/k", "units/kv/v"]
        assert sorted(h.rows["residual"]) == ["units/cross/k",
                                              "units/cross/v"]
    dec = DecodeEngine(cfg, port_params("vlm"), n_slots=2, max_len=MAX_LEN,
                       device="cpu", **CACHE_MODES[cache])
    before = [(p, x.clone()) for p, x in _flatten(h.rows)]
    make_transport(transport).deliver(h, dec)
    after = _flatten(h.rows)
    assert [p for p, _ in after] == [p for p, _ in before]
    for (_, a), (_, b) in zip(after, before):
        assert torch.equal(a, b)
    dec.submit(HandoffRequest(handoff=h))
    [c] = dec.run_until_idle()
    assert c.tokens == engine("vlm", kernels=False).generate(
        [[1, 2, 3]], max_new_tokens=MAX_NEW)[0]


def test_vlm_handoff_with_a_missing_cross_leaf_is_rejected():
    cfg, h = _vlm_handoff("dense")
    h.rows = {"units": {"kv": h.rows["units"]["kv"]}}
    dec = DecodeEngine(cfg, port_params("vlm"), n_slots=2, max_len=MAX_LEN,
                       device="cpu")
    with pytest.raises(ValueError, match="tree structure"):
        dec.submit(HandoffRequest(handoff=h))


@pytest.mark.parametrize("dispatch", ["scatter", "onehot"])
def test_ragged_moe_serving_equals_per_request_generate(dispatch):
    """The reference's ``tests/test_traffic.py`` ragged-moe case on the
    port: capacity factor 0.6 forces expert drops, yet a prompt served in a
    right-padded ragged batch gets the tokens it gets served alone (its
    capacity comes from its real tokens), and both equal the reference's."""
    kw = dict(_base("moe"), arch_id=f"tiny-moe-{dispatch}")
    moe = dict(n_experts=4, top_k=2, d_expert=32, capacity_factor=0.6,
               dispatch=dispatch, global_decode_dispatch=False)
    ref_cfg = RefLMConfig(**kw, moe=RefMoEConfig(**moe))
    cfg = LMConfig(**kw, moe=MoEConfig(**moe))
    jp = ref_lm.init(ref_cfg, jax.random.PRNGKey(1))
    pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    prompts = [[3, 5, 7], [9, 11, 13, 15, 17, 19, 21],
               [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24]]

    def serve(eng, request_cls, ps):
        return [c.tokens for c in sorted(
            eng.serve([request_cls(prompt=list(p), max_new_tokens=6, rid=i)
                       for i, p in enumerate(ps)]), key=lambda c: c.rid)]

    got = serve(ServeEngine(cfg, pp, n_slots=4, max_len=64, device="cpu"),
                Request, prompts)
    for i, p in enumerate(prompts):
        solo = ServeEngine(cfg, pp, n_slots=1, max_len=64, device="cpu")
        assert serve(solo, Request, [p])[0] == got[i], p
    assert got == serve(RefServeEngine(ref_cfg, jp, n_slots=4, max_len=64),
                        RefRequest, prompts)
