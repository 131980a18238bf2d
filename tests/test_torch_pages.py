"""Port parity for the paged KV cache (``repro_torch.serving.pages``) on the
CPU.

The host bookkeeping is driven through the same sequence of calls in the
reference's ``PagePool`` and the port's, and the two must hold identical
tables, free lists, refcounts, LRU order and counters after every step.
Page hashes must be the reference's bytes.  The device ops (gathered view,
decode-row scatter, prefill page write, continuation caches, page export and
import) run on the same pool contents in both packages, for a bfloat16 pool
and an int8 one: gathers and scatters move values and must agree exactly;
quantizing a float32 row (the int8 prefill write) agrees to one int8 step on
rows whose scaled value lands at a rounding boundary, and the scales to
float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import pages as ref_pages
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LMConfig
from repro_torch.serving import PagePool, PagePoolExhausted
from torch_testlib import f32

torch.set_num_threads(1)

TINY = dict(arch_id="tiny-dense", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab=64, remat=False,
            compute_dtype="float32", param_dtype="float32")
N_SLOTS, MAX_LEN, PAGE, N_PAGES = 2, 32, 8, 8


def pools(quantize=False, n_pages=N_PAGES, page=PAGE, n_slots=N_SLOTS,
          max_len=MAX_LEN):
    kw = dict(n_slots=n_slots, max_len=max_len, page_size=page,
              n_pages=n_pages, quantize=quantize)
    return (ref_pages.PagePool(RefLMConfig(**TINY), **kw),
            PagePool(LMConfig(**TINY), **kw))


def host_state(pool):
    return {"tables": pool.tables_snapshot().tolist(),
            "free": list(pool._free), "refs": pool._refs.tolist(),
            "evictable": list(pool._evictable),
            "index": sorted((h, p) for h, p in pool._prefix_index.items()),
            "counters": pool.counters(), "free_pages": pool.free_pages}


def run_both(ref, port, fn):
    """Apply ``fn`` to both pools; their results (or the type of the error
    they raise) and their whole host state must agree."""
    out = []
    for pool in (ref, port):
        try:
            out.append(("ok", fn(pool)))
        except (ValueError, RuntimeError) as e:
            out.append(("raised", type(e).__name__))
    assert out[0] == out[1]
    assert host_state(ref) == host_state(port)
    return out[1][1]


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------


class TestBookkeeping:
    def test_sequence_matches_reference(self):
        """allocate, retain, release, register, acquire, extend, pin, bind,
        unbind, LRU eviction and exhaustion, step by step."""
        ref, port = pools(n_pages=6)
        h = [bytes([i]) * 32 for i in range(8)]
        a = run_both(ref, port, lambda p: p.allocate(3, slot=0))
        run_both(ref, port, lambda p: p.bind_slot(0, a))
        for i, pg in enumerate(a[:2]):
            run_both(ref, port, lambda p: p.register_hash(pg, h[i]))
        run_both(ref, port, lambda p: p.register_hash(a[2], h[0]))  # dup
        run_both(ref, port, lambda p: p.retain(a[:1]))
        b = run_both(ref, port, lambda p: p.allocate(2, slot=1))
        run_both(ref, port, lambda p: p.bind_slot(1, b))
        run_both(ref, port, lambda p: p.set_slot_page(1, 3, a[2]))
        run_both(ref, port, lambda p: p.page_at(1, 3))
        run_both(ref, port, lambda p: p.slot_pages(1))
        run_both(ref, port, lambda p: p.slot_page_hashes(0))
        run_both(ref, port, lambda p: p.allocate(2))             # exhausted
        got = run_both(ref, port, lambda p: p.unbind_slot(0))
        run_both(ref, port, lambda p: p.release(got))
        run_both(ref, port, lambda p: p.release(a[:1]))
        run_both(ref, port, lambda p: p.acquire_prefix(h[:3]))   # 2 hits
        run_both(ref, port, lambda p: p.extend_prefix(h[:3], 1))
        run_both(ref, port, lambda p: p.pin_hashes([h[5], h[1], None]))
        run_both(ref, port, lambda p: p.release(a[:2] * 3))
        run_both(ref, port, lambda p: p.release(a[:1]))          # unowned
        run_both(ref, port, lambda p: p.allocate(3, slot=1))     # evicts LRU
        run_both(ref, port, lambda p: p.acquire_prefix(h[:2]))
        run_both(ref, port, lambda p: p.unbind_slot(1))
        run_both(ref, port, lambda p: p.set_device_blocks(2))
        run_both(ref, port, lambda p: p.allocate(1, slot=1))
        run_both(ref, port, lambda p: p.bind_slot(0, list(range(5))))

    def test_exhaustion_is_atomic(self):
        _, pool = pools(n_pages=4)
        pool.allocate(3)
        with pytest.raises(PagePoolExhausted):
            pool.allocate(2)               # only 1 free: nothing taken
        assert pool.free_pages == 1
        assert pool.counters()["allocated"] == 3
        pool.allocate(1)                   # the survivor is still usable
        with pytest.raises(PagePoolExhausted):
            pool.allocate(1)

    def test_geometry_checks(self):
        with pytest.raises(ValueError, match="divide"):
            pools(page=5)
        with pytest.raises(ValueError, match="cannot hold"):
            pools(n_pages=3)
        with pytest.raises(ValueError, match="exceed"):
            pools()[1].bind_slot(0, list(range(5)))

    @pytest.mark.parametrize("quantize", [False, True])
    def test_specs_and_payload_struct_match_reference(self, quantize):
        ref, port = pools(quantize)
        assert port.pool_specs() == ref.pool_specs()
        assert port.residual_specs() == ref.residual_specs() == {}
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in ref.page_payload_struct(3).items()}
        got = {k: (shape, str(dt).replace("torch.", ""))
               for k, (shape, dt) in port.page_payload_struct(3).items()}
        assert got == want
        arrays = {k: (tuple(v.shape), str(v.dtype))
                  for k, v in ref.init_pool_arrays().items()}
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in port.init_pool_arrays("cpu").items()} == arrays


class TestChainHashes:
    @pytest.mark.parametrize("quantize", [False, True])
    @pytest.mark.parametrize("page", [4, 8])
    def test_bytes_equal_reference(self, quantize, page):
        ref, port = pools(quantize, page=page)
        rng = np.random.RandomState(page + quantize)
        for n in (1, page, page + 1, 3 * page, 3 * page + 2):
            prompt = [int(t) for t in rng.randint(1, 2 ** 20, size=n)]
            assert port.chain_hashes(prompt) == ref.chain_hashes(prompt)

    def test_cap_and_sensitivity(self):
        _, port = pools(page=4)
        prompt = list(range(1, 13))         # 12 tokens, 3 full pages
        hs = port.chain_hashes(prompt)
        assert len(hs) == 2                 # capped: a suffix token remains
        other = port.chain_hashes([9] + prompt[1:])
        assert hs[0] != other[0] and hs[1] != other[1]   # chained
        assert pools(page=8)[1].chain_hashes(prompt) != hs[:1]
        assert pools(True, page=4)[1].chain_hashes(prompt) != hs


# ---------------------------------------------------------------------------
# device ops on the same pool contents
# ---------------------------------------------------------------------------


def _fill(ref, port, seed):
    """The same random contents in both pools: bf16 K/V, or int8 rows with
    positive float32 scales."""
    rng = np.random.RandomState(seed)
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
    return jpool, ppool


TABLES = np.array([[5, 2, -1, -1], [7, 0, 3, -1]], np.int32)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
        return
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("quantize", [False, True])
class TestDeviceOps:
    def test_build_view(self, quantize):
        ref, port = pools(quantize)
        jpool, ppool = _fill(ref, port, 1)
        for dequant in (False, True):
            want = ref.build_view(jpool, {}, jnp.asarray(TABLES),
                                  dequant=dequant)
            got = port.build_view(ppool, {}, torch.from_numpy(TABLES),
                                  dequant=dequant)
            _assert_tree_equal(got, want)
            # the decode kernel reads the view's layers in place
            assert all(leaf.is_contiguous() for leaf in got["kv"].values())
        _assert_tree_equal(port.pool_tree(ppool, {}),
                           ref.pool_tree(jpool, {}))
        assert port.pool_untree(port.pool_tree(ppool, {}))[0] is not None

    def test_scatter_decode_rows(self, quantize):
        ref, port = pools(quantize)
        jpool, ppool = _fill(ref, port, 2)
        jview = ref.build_view(jpool, {}, jnp.asarray(TABLES))
        pview = port.build_view(ppool, {}, torch.from_numpy(TABLES))
        # new rows at each slot's write head; slot 0 writes into page 2's
        # row 1, slot 1 into page 3's row 4
        pos = np.array([9, 20], np.int32)
        jn, pn = _fill(*pools(quantize), 3)        # fresh values to write
        for key in jview["kv"]:
            src = np.array(ref.build_view(jn, {}, jnp.asarray(TABLES)
                                          )["kv"][key].astype(jnp.float32))
            jview["kv"][key] = jnp.asarray(src).astype(jview["kv"][key].dtype)
            pview["kv"][key] = torch.from_numpy(src).to(pview["kv"][key].dtype)
        want = ref.scatter_decode_rows(jpool, jview, jnp.asarray(TABLES),
                                       jnp.asarray(pos))
        got = port.scatter_decode_rows(ppool, pview, torch.from_numpy(TABLES),
                                       torch.from_numpy(pos))
        _assert_tree_equal(got, want)
        # an unmapped write head (slot 0 at page index 2) drops its row:
        # nothing lands in page 0, where the clipped sentinel points
        before = {k: v.clone() for k, v in ppool.items()}
        want = ref.scatter_decode_rows(want, jview, jnp.asarray(TABLES),
                                       jnp.asarray([17, 20], jnp.int32))
        got = port.scatter_decode_rows(ppool, pview, TABLES,
                                       np.array([17, 20]))
        _assert_tree_equal(got, want)
        for key, leaf in got.items():
            assert torch.equal(before[key][:, 0], leaf[:, 0]), key

    @pytest.mark.parametrize("off", [0, 8])
    def test_write_prefill_pages(self, quantize, off):
        ref, port = pools(quantize)
        jpool, ppool = _fill(ref, port, 4)
        npg, nb = 2, 2
        total = off + npg * PAGE
        rng = np.random.RandomState(5)
        shape = (TINY["n_layers"], nb, total, 2, 8)
        sub = {k: rng.standard_normal(shape).astype(np.float32)
               for k in ("k", "v")}
        # row 1's second page is unallocated: the sentinel drops it
        page_map = np.array([[6, 1], [4, N_PAGES]], np.int32)
        want = ref.write_prefill_pages(
            jpool, {"kv": {k: jnp.asarray(v).astype(jnp.bfloat16)
                           for k, v in sub.items()}},
            jnp.asarray(page_map), off)
        got = port.write_prefill_pages(
            ppool, {"kv": {k: torch.from_numpy(v).to(torch.bfloat16)
                           for k, v in sub.items()}}, page_map, off)
        if not quantize:
            _assert_tree_equal(got, want)
            return
        for key in ("kv/k", "kv/v"):
            d = np.abs(f32(got[key]) - f32(want[key]))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, key
            np.testing.assert_allclose(f32(got[key + "_scale"]),
                                       f32(want[key + "_scale"]), rtol=1e-6)

    def test_make_continuation_caches(self, quantize):
        ref, port = pools(quantize)
        jpool, ppool = _fill(ref, port, 6)
        prefix = np.array([[5, 2], [0, 3]], np.int32)
        want = ref.make_continuation_caches(jpool, jnp.asarray(prefix), 2, 24)
        got = port.make_continuation_caches(ppool, prefix, 2, 24)
        _assert_tree_equal(got, want)
        assert got["kv"]["k"].dtype == torch.bfloat16

    def test_export_import_and_take(self, quantize):
        ref, port = pools(quantize)
        jpool, ppool = _fill(ref, port, 7)
        want = ref.export_pages(jpool, [3, 6, 1])
        got = port.export_pages(ppool, [3, 6, 1])
        _assert_tree_equal(got, want)
        _assert_tree_equal(port.take_payload(got, [2, 0]),
                           ref.take_payload(want, [2, 0]))
        _assert_tree_equal(port.import_pages(ppool, got, [0, 4, 5]),
                           ref.import_pages(jpool, want, [0, 4, 5]))


class TestPayloadBytes:
    def _payload_nbytes(self, quantize):
        _, pool = pools(quantize, n_pages=None)
        payload = pool.export_pages(pool.init_pool_arrays("cpu"), [0, 1])
        return port_lm.cache_row_nbytes(payload)

    def test_nbytes_quantized_payload_shrinks(self):
        plain = self._payload_nbytes(False)
        q = self._payload_nbytes(True)
        # int8 rows + float32 per-row scales against the bfloat16 pool:
        # exactly 2x on the rows, the scales cost 4 B per 16-element row
        assert 1.5 < plain / q <= 2.0, (plain, q)
        assert 3.0 < 2 * plain / q <= 4.0, (plain, q)

    def test_nbytes_match_reference(self):
        for quantize in (False, True):
            ref, port = pools(quantize, n_pages=None)
            want = ref_lm.cache_row_nbytes(
                ref.export_pages(ref.init_pool_arrays(), [0, 1]))
            assert self._payload_nbytes(quantize) == want


def test_other_families_are_refused():
    import dataclasses

    with pytest.raises(ValueError, match="attention family"):
        PagePool(dataclasses.replace(LMConfig(**TINY), family="ssm"), 2, 32, 8)


def test_jax_reference_is_on_the_cpu():
    assert jax.default_backend() == "cpu"
