"""The reference's serving contracts that no other port test held, each
against the JAX package on the same numpy inputs, on the CPU (a kernel
wrapper given CPU tensors runs its plain version):

* seeded draws do not depend on the schedule: an engine of 2 slots, one of
  3 slots and each request alone give the same tokens, and they are the
  reference's (``tests/test_decode_kernels.py:284``), with and without the
  decode kernel; an unset seed is derived as the reference derives it
  (``docs/kernels.md:219-222``);
* permuting the rows of one ``fused_sampling`` call permutes its tokens
  (``:410``);
* the chi-square of seeded draws from one fixed row stays under 45
  (``:396``);
* a slot's paged decode output does not change with where the other
  slots' sentinel table entries alias, over float32 and int8 pages, and it
  is the reference's plain decode (``:196-208``).

``docs/torch_kernels.md`` and ``docs/torch_traffic.md`` cite these tests in
their contract tables; ``chip_smoke.py`` holds the same contracts on the
card (``serve_lm``'s ``seeded_schedules``, the ``kernels`` phase's
``contracts`` line).  Tolerances: tokens are integers and compared for
equality; decode outputs are compared bit for bit between the two
aliasings (the same function of the same rows) and within 2e-5 of the
reference's float32 oracle, the reference's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as ref_kernels
from repro.kernels.attention.ref import decode_attention_ref
from repro.models import lm as ref_lm
from repro.models.attention import quantize_kv_rows as ref_quantize_kv_rows
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import convert
from repro_torch import kernels
from repro_torch.models.attention import quantize_kv_rows
from repro_torch.models.common import LMConfig
from repro_torch.serving import Request, ServeEngine

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4]]
PAGE = 8
MAX_LEN = 32
MAX_NEW = 4
SAMPLING_KW = dict(temperature=0.8, top_k=8, top_p=0.95)
TINY = dict(arch_id="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")
REF_CFG, CFG = RefLMConfig(**TINY), LMConfig(**TINY)
_CACHE = {}


def ref_params():
    if "params" not in _CACHE:
        _CACHE["params"] = ref_lm.init(REF_CFG, jax.random.key(0))
    return _CACHE["params"]


def port_params():
    return convert.params_from_numpy(jax.tree.map(np.asarray, ref_params()))


def seeded_tokens(eng, request_cls, prompts=PROMPTS, rids=None, **kw):
    """The reference's ``seeded_tokens``: each prompt with seed 1000 + its
    index, temperature 0.8, top-k 8, top-p 0.95."""
    rids = range(len(prompts)) if rids is None else rids
    comps = eng.serve([request_cls(prompt=list(p), max_new_tokens=MAX_NEW,
                                   rid=i, seed=1000 + i,
                                   **{**SAMPLING_KW, **kw})
                       for i, p in zip(rids, prompts)])
    return {c.rid: list(c.tokens) for c in comps}


def ref_seeded(decode_kernel):
    key = ("seeded", decode_kernel)
    if key not in _CACHE:
        eng = RefServeEngine(REF_CFG, ref_params(), n_slots=2,
                             max_len=MAX_LEN, page_size=PAGE,
                             decode_kernel=decode_kernel)
        _CACHE[key] = seeded_tokens(eng, RefRequest)
    return _CACHE[key]


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_seeded_tokens_are_schedule_invariant(decode_kernel):
    """Together in 2 slots (twice), in 3 slots, and each request alone:
    the same tokens, and the reference's."""
    params = port_params()

    def mk(n_slots):
        return ServeEngine(CFG, params, n_slots=n_slots, max_len=MAX_LEN,
                           page_size=PAGE, decode_kernel=decode_kernel,
                           device="cpu")

    together = seeded_tokens(mk(2), Request)
    assert seeded_tokens(mk(2), Request) == together       # reproducible
    assert seeded_tokens(mk(3), Request) == together       # slot mix
    solo = {}
    for i, p in enumerate(PROMPTS):                        # batch of one
        solo.update(seeded_tokens(mk(2), Request, [p], [i]))
    assert solo == together
    assert together == ref_seeded(decode_kernel)
    greedy = seeded_tokens(mk(2), Request, temperature=0.0)
    assert together != greedy          # the draws are not greedy here


def test_unset_seed_is_derived_as_the_reference_derives_it():
    """Sampled requests without a seed: each engine derives one from its
    own seed and the rid, writes it back onto the request, and draws the
    reference's tokens from it."""
    def serve(eng, request_cls):
        reqs = [request_cls(prompt=list(p), max_new_tokens=MAX_NEW, rid=i,
                            **SAMPLING_KW) for i, p in enumerate(PROMPTS)]
        comps = eng.serve(reqs)
        return ({c.rid: list(c.tokens) for c in comps},
                [r.seed for r in reqs])

    got, seeds = serve(ServeEngine(CFG, port_params(), n_slots=2,
                                   max_len=MAX_LEN, decode_kernel=True,
                                   device="cpu"), Request)
    want, ref_seeds = serve(RefServeEngine(REF_CFG, ref_params(), n_slots=2,
                                           max_len=MAX_LEN,
                                           decode_kernel=True), RefRequest)
    assert seeds == ref_seeds and None not in seeds
    assert got == want


def _rows(seed: int, b: int, vocab: int):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, vocab).astype(np.float32)
    temp = rng.uniform(0.5, 1.5, b).astype(np.float32)
    seeds = rng.randint(0, 2**31, b).astype(np.int32)
    pos = rng.randint(0, 64, b).astype(np.int32)
    return logits, temp, seeds, pos


def test_fused_sampling_slot_order_invariant():
    """Permuting the rows of one launch permutes its tokens, and both
    launches draw the reference's tokens."""
    logits, temp, seeds, pos = _rows(3, 8, 16)
    perm = np.random.RandomState(4).permutation(8)

    def port(idx):
        return kernels.fused_sampling(
            torch.from_numpy(logits[idx]), torch.from_numpy(temp[idx]),
            torch.from_numpy(seeds[idx]), torch.from_numpy(pos[idx]),
            tune=False).numpy()

    def ref(idx):
        return np.asarray(ref_kernels.fused_sampling(
            jnp.asarray(logits[idx]), jnp.asarray(temp[idx]),
            jnp.asarray(seeds[idx]), jnp.asarray(pos[idx]), tune=False))

    base = port(np.arange(8))
    np.testing.assert_array_equal(port(perm), base[perm])
    np.testing.assert_array_equal(base, ref(np.arange(8)))
    np.testing.assert_array_equal(port(perm), ref(perm))


@pytest.mark.parametrize("vocab, n", [(8, 2048), (16, 4096)])
def test_fused_sampling_chi_square(vocab, n):
    """Draws of one fixed row over n counters (seed i, position 0) at T 1:
    the chi-square against the softmax law under 45 (the reference's bound
    at its 8 lanes, and chip_smoke.py's 16 lanes); the same counters give
    the same tokens; at the reference's size, its tokens."""
    rng = np.random.RandomState(0)
    row = rng.randn(vocab).astype(np.float32) * 1.5
    probs = np.exp(row - row.max())
    probs /= probs.sum()
    logits = np.tile(row, (n, 1))
    args = (np.ones((n,), np.float32), np.arange(n, dtype=np.int32),
            np.zeros((n,), np.int32))

    def port():
        return kernels.fused_sampling(
            torch.from_numpy(logits), *map(torch.from_numpy, args),
            tune=False).numpy()

    toks = port()
    obs = np.bincount(toks, minlength=vocab)
    chi2 = float(((obs - probs * n) ** 2 / (probs * n)).sum())
    assert chi2 < 45.0, chi2
    np.testing.assert_array_equal(port(), toks)
    if vocab == 8:
        want = np.asarray(ref_kernels.fused_sampling(
            jnp.asarray(logits), *map(jnp.asarray, args), tune=False))
        np.testing.assert_array_equal(toks, want)


def _paged_case(seed, valid_lens, shuffle_seed):
    """The reference's check_paged_decode_case inputs: a pool of 4 pages a
    slot, shuffled; -1 past each slot's resident pages."""
    b, nkv, h, d, page, p_per = len(valid_lens), 2, 4, 8, 4, 4
    n_pages, max_len = b * p_per, p_per * page
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(n_pages, page, nkv, d).astype(np.float32)
    v = rng.randn(n_pages, page, nkv, d).astype(np.float32)
    valid = np.asarray([min(n, max_len) for n in valid_lens], np.int32)
    perm = np.random.RandomState(shuffle_seed).permutation(n_pages)
    tables = np.full((b, p_per), -1, np.int64)
    for i in range(b):
        n_resident = -(-int(valid[i]) // page)
        tables[i, :n_resident] = perm[i * p_per:(i + 1) * p_per][:n_resident]
    clipped = np.clip(tables, 0, n_pages - 1).astype(np.int32)
    again = np.where(tables < 0, (tables + 7) % n_pages, tables
                     ).astype(np.int32)
    return q, k, v, valid, clipped, again


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("seed, valid_lens, shuffle_seed", [
    (0, (5, 0, 16, 9), 1), (3, (1, 13, 4, 0, 7), 2), (7, (16, 16, 2), 5)])
def test_paged_alias_invariance(seed, valid_lens, shuffle_seed, quantized):
    """The sentinels clipped to page 0, then re-clipped to page 6: the
    port's paged decode gives the same bits, within 2e-5 of the
    reference's oracle on the same pool."""
    q, k, v, valid, clipped, again = _paged_case(seed, valid_lens,
                                                 shuffle_seed)
    n_pages, page = k.shape[:2]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    extra, ref_extra = {}, {}
    if quantized:
        flat = (1, n_pages * page) + k.shape[2:]
        tk, ks = quantize_kv_rows(tk.reshape(flat))
        tv, vs = quantize_kv_rows(tv.reshape(flat))
        tk, tv = tk.reshape(k.shape), tv.reshape(v.shape)
        extra = {"ks": ks.reshape(n_pages, page),
                 "vs": vs.reshape(n_pages, page)}
        jk, jks = ref_quantize_kv_rows(jnp.asarray(k).reshape(flat))
        jv, jvs = ref_quantize_kv_rows(jnp.asarray(v).reshape(flat))
        ref_extra = {"ks": jks.reshape(n_pages, page),
                     "vs": jvs.reshape(n_pages, page)}
        jk, jv = jk.reshape(k.shape), jv.reshape(v.shape)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
    got = [kernels.decode_attention(tq, tk, tv, torch.from_numpy(valid),
                                    tables=torch.from_numpy(t), tune=False,
                                    **extra).numpy()
           for t in (clipped, again)]
    np.testing.assert_array_equal(got[0], got[1])
    want = np.asarray(decode_attention_ref(
        jnp.asarray(q), jk, jv, jnp.asarray(valid),
        tables=jnp.asarray(clipped), **ref_extra))
    np.testing.assert_allclose(got[0], want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("h, nkv, d, t, paged, kv_dtype", [
    (32, 8, 64, 1024, False, torch.bfloat16),   # serve_lm's cache
    (32, 8, 64, 1024, True, torch.int8),        # its int8 pages
    (96, 8, 128, 1024, False, torch.bfloat16),  # mistral-large: 2 chunks
    (16, 8, 128, 512, True, torch.bfloat16),    # qwen3's widths
])
def test_decode_plan_is_batch_invariant(h, nkv, d, t, paged, kv_dtype):
    """The decode kernel's resolved launch (``kv_splits`` and ``threads``
    set a row's sums: the split ranges and their join) is the same for
    every batch of slots, so a slot's output does not depend on who shares
    its decode tick (ROADMAP §C: the split count was once planned from
    the batch, 4 at 3 slots against 2 at 8)."""
    page = 16
    configs = set()
    for b in range(1, 17):
        q = torch.empty(b, 1, h, d, device="meta")
        if paged:
            n_pages = b * t // page
            k = torch.empty(n_pages, page, nkv, d, dtype=kv_dtype,
                            device="meta")
            kw = {"tables": torch.empty(b, t // page, dtype=torch.int32,
                                        device="meta")}
        else:
            k = torch.empty(b, t, nkv, d, dtype=kv_dtype, device="meta")
            kw = {}
        valid = torch.empty(b, dtype=torch.int32, device="meta")
        cfg = kernels.registry.default_config("decode_attention", q, k, k,
                                              valid, **kw)
        configs.add(tuple(sorted(cfg.items())))
    assert len(configs) == 1, configs
