"""Data-parallel serving on a 2-entry CPU mesh, held against the reference.

The twin of ``tests/test_serving_api.py``'s sharded tests (which force two
CPU devices in a subprocess): here a ``ShardedScheduler`` over a mesh that
names the CPU twice runs every sharded code path in process — two blocks of
slots, each with its own caches (or pool block), parameters cast once per
distinct device.  Greedy tokens of the sharded ``ServeEngine`` equal the
reference's unsharded per-request ``generate`` for the dense, vlm and ssm
families, dense paged included; the sharded ``CapsuleEngine`` with an SLO
inner scheduler classifies as the reference's deployed model does;
``multihost_disaggregated_lm_engine`` gives the unified engine's tokens;
and the page allocator stays inside the slot's block.  Models: the
reference's tiny float32 fixtures, ``reduced()`` xlstm-1.3b at float32
compute, parameters converted leaf by leaf.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import capsnet as ref_cn
from repro.deploy import FastCapsPipeline as RefPipeline
from repro.models import lm as ref_lm
from repro.models.common import LMConfig as RefLMConfig
from repro.serving import ServeEngine as RefServeEngine
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.core import capsnet as port_cn
from repro_torch.deploy import FastCapsPipeline
from repro_torch.launch import serve as port_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LMConfig
from repro_torch.serving import (CapsuleEngine, ImageRequest, PagePool,
                                 PagePoolExhausted, PriorityScheduler,
                                 Request, ServeEngine, ShardedScheduler,
                                 SLOBatchScheduler,
                                 multihost_disaggregated_lm_engine)
from repro_torch.serving.transport import (DeviceToDeviceTransport,
                                           InProcessTransport,
                                           select_transport)

torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [2, 4], [9, 9, 1, 4], [3]]
MAX_LEN = 48
MAX_NEW = 4
PAGE = 8


def mesh2():
    """A 2-way ``data`` mesh naming the CPU twice (degenerate placement)."""
    return make_mesh((2,), ("data",), devices=["cpu", "cpu"])


def _tiny(family, **kw):
    base = dict(arch_id="tiny-" + family, family=family, n_layers=2,
                d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                remat=False, compute_dtype="float32", param_dtype="float32")
    base.update(kw)
    return base


def cfgs(family):
    """(reference config, port config) for a family."""
    if family == "ssm":
        kw = dict(compute_dtype="float32")
        return (dataclasses.replace(ref_configs.reduced(
                    ref_configs.get_config("xlstm-1.3b")), **kw),
                dataclasses.replace(port_configs.reduced(
                    port_configs.get_config("xlstm-1.3b")), **kw))
    kw = (dict(n_layers=3, cross_attn_every=2, n_image_tokens=8)
          if family == "vlm" else {})
    return RefLMConfig(**_tiny(family, **kw)), LMConfig(**_tiny(family, **kw))


_CACHE = {}


def params(family):
    """(reference params, port params converted from them), once."""
    if family not in _CACHE:
        ref = ref_lm.init(cfgs(family)[0], jax.random.key(0))
        _CACHE[family] = (ref, convert.params_from_numpy(
            jax.tree.map(np.asarray, ref)))
    return _CACHE[family]


def ref_generate(family, prompt):
    key = ("gen", family, tuple(prompt))
    if key not in _CACHE:
        eng = RefServeEngine(cfgs(family)[0], params(family)[0], n_slots=2,
                             max_len=MAX_LEN)
        _CACHE[key] = eng.generate([list(prompt)],
                                   max_new_tokens=MAX_NEW)[0]
    return _CACHE[key]


def served(eng, prompts=PROMPTS):
    comps = eng.serve([Request(prompt=list(p), max_new_tokens=MAX_NEW,
                               rid=i) for i, p in enumerate(prompts)])
    return {c.rid: list(c.tokens) for c in comps}


class TestShardedServeEngine:
    @pytest.mark.parametrize("family,cache", [
        ("dense", "dense"), ("dense", "paged"), ("vlm", "dense"),
        ("vlm", "paged"), ("ssm", "dense")])
    def test_tokens_equal_reference(self, family, cache):
        kw = dict(page_size=PAGE) if cache == "paged" else {}
        sched = ShardedScheduler(mesh2())
        assert sched.n_devices == 2
        eng = ServeEngine(cfgs(family)[1], params(family)[1], n_slots=4,
                          max_len=MAX_LEN, scheduler=sched, device="cpu",
                          **kw)
        assert [(sh.lo, sh.hi) for sh in eng._shards] == [(0, 2), (2, 4)]
        # one compute copy of the parameters for the one distinct device
        assert eng._shards[0].params is eng._shards[1].params
        got = served(eng)
        for i, p in enumerate(PROMPTS):
            assert got[i] == ref_generate(family, p), (family, cache, i)

    def test_each_block_holds_half_the_caches(self):
        cfg = cfgs("dense")[1]
        eng = ServeEngine(cfg, params("dense")[1], n_slots=4,
                          max_len=MAX_LEN, scheduler=ShardedScheduler(mesh2()),
                          device="cpu")
        total = port_lm.cache_nbytes(cfg, 4, MAX_LEN)
        for sh in eng._shards:
            got = sum(x.numel() * x.element_size()
                      for x in jax.tree.leaves(sh.caches))
            assert got == total // 2
        # the layout is the one lm.cache_shardings gives the slot axis
        shard = port_lm.cache_shardings(
            cfg, port_lm.make_caches(cfg, 4, MAX_LEN, device="meta"),
            mesh2())
        assert shard["kv"]["k"].spec[1] == "data"

    def test_each_block_holds_half_the_pool(self):
        cfg = cfgs("dense")[1]
        eng = ServeEngine(cfg, params("dense")[1], n_slots=4,
                          max_len=MAX_LEN, scheduler=ShardedScheduler(mesh2()),
                          device="cpu", page_size=PAGE)
        whole = PagePool(cfg, 4, MAX_LEN, PAGE).init_pool_arrays("cpu")
        total = sum(x.numel() * x.element_size() for x in whole.values())
        for sh in eng._shards:
            assert sum(x.numel() * x.element_size()
                       for x in sh.pool.values()) == total // 2
            assert sh.page_lo == sh.index * eng._pages.n_pages // 2

    def test_capacity_must_divide(self):
        with pytest.raises(ValueError, match="divisible"):
            ServeEngine(cfgs("dense")[1], params("dense")[1], n_slots=3,
                        max_len=MAX_LEN,
                        scheduler=ShardedScheduler(mesh2()), device="cpu")

    def test_kernel_path_and_sampled_tokens(self):
        """decode_kernel (fused_sampling once per block) and the flash
        wrapper in prefill: greedy tokens equal the unsharded engine's,
        and seeded sampled tokens are equal too."""
        cfg = dataclasses.replace(cfgs("dense")[1], attn_impl="cuda")
        p = params("dense")[1]
        reqs = lambda: [Request(prompt=list(q), max_new_tokens=MAX_NEW, rid=i,
                                temperature=0.9 if i % 2 else 0.0,
                                top_k=20 if i % 2 else 0, seed=100 + i)
                        for i, q in enumerate(PROMPTS)]
        for kw in ({}, dict(page_size=PAGE)):
            one = ServeEngine(cfg, p, n_slots=4, max_len=MAX_LEN,
                              decode_kernel=True, device="cpu", **kw)
            two = ServeEngine(cfg, p, n_slots=4, max_len=MAX_LEN,
                              decode_kernel=True, device="cpu",
                              scheduler=ShardedScheduler(mesh2()), **kw)
            want = {c.rid: c.tokens for c in one.serve(reqs())}
            got = {c.rid: c.tokens for c in two.serve(reqs())}
            assert got == want, kw

    @pytest.mark.parametrize("cache", ("dense", "paged"))
    def test_preemption_moves_rows_between_blocks(self, cache):
        """A PriorityScheduler over the sharded engine's blocks: evicted
        tasks resume wherever a slot frees, on either block, with the
        tokens of an uninterrupted run."""
        cfg = cfgs("dense")[1]
        p = params("dense")[1]
        kw = dict(page_size=PAGE) if cache == "paged" else {}
        eng = ServeEngine(cfg, p, n_slots=2, max_len=MAX_LEN, device="cpu",
                          scheduler=_PrioritySharded(mesh2()), **kw)
        reqs = [Request(prompt=list(q), max_new_tokens=6, rid=i,
                        priority=1 if i < 2 else 0)
                for i, q in enumerate(PROMPTS[:4])]
        for r in reqs[:2]:
            eng.submit(r)
        eng.tick()
        eng.tick()
        for r in reqs[2:]:
            eng.submit(r)
        got = {c.rid: c.tokens for c in eng.run_until_idle()}
        assert eng.stats().preempted >= 1
        ref = ServeEngine(cfg, p, n_slots=2, max_len=MAX_LEN, device="cpu")
        for r in reqs:
            assert got[r.rid] == ref.generate([r.prompt],
                                              max_new_tokens=6)[0], r.rid


class _PrioritySharded(ShardedScheduler):
    """ShardedScheduler placement with PriorityScheduler admission and
    preemption (the engine shards when its scheduler is a
    ShardedScheduler; priority picks and evicts)."""

    def __init__(self, mesh):
        super().__init__(mesh, inner=PriorityScheduler())

    def select(self, queue):
        return self.inner.select(queue)

    def preempt(self, queued, residents):
        return self.inner.preempt(queued, residents)


class TestStrictBlockAllocator:
    def pool(self, n_pages=8):
        pool = PagePool(cfgs("dense")[1], 4, 16, 4, n_pages=n_pages)
        pool.set_device_blocks(2, strict=True)
        return pool

    def test_allocation_stays_in_the_slots_block(self):
        pool = self.pool()
        assert sorted(pool.allocate(4, slot=0)) == [0, 1, 2, 3]
        # block 0 is dry: a slot of block 0 fails although block 1 is free
        with pytest.raises(PagePoolExhausted, match="block 0"):
            pool.allocate(1, slot=1)
        assert sorted(pool.allocate(4, slot=3)) == [4, 5, 6, 7]

    def test_evicts_only_in_its_block(self):
        pool = self.pool()
        a = pool.allocate(4, slot=0)
        pool.register_hash(a[0], b"x" * 32)
        pool.release(a)                    # a[0] cached, the rest free
        b = pool.allocate(4, slot=1)
        assert sorted(b) == [0, 1, 2, 3]
        assert pool.counters()["cache_evicted"] == 1

    def test_prefix_hits_are_per_block(self):
        pool = self.pool()
        h = [bytes([i]) * 32 for i in range(2)]
        a = pool.allocate(2, slot=0)
        pool.register_hash(a[0], h[0])
        pool.register_hash(a[1], h[1])
        assert pool.acquire_prefix(h, slot=1) == a       # block 0
        assert pool.acquire_prefix(h, slot=2) == []      # block 1: none
        c = pool.allocate(1, slot=2)
        pool.register_hash(c[0], h[0])                   # block 1's own
        assert pool.acquire_prefix(h, slot=3) == c

    def test_preferring_blocks_is_unchanged(self):
        """Without ``strict`` the pool still prefers a block and takes
        another's page when its own is dry (the reference's rule)."""
        pool = PagePool(cfgs("dense")[1], 4, 16, 4, n_pages=8)
        pool.set_device_blocks(2)
        pool.allocate(4, slot=0)
        assert pool.allocate(1, slot=1)[0] >= 4

    def test_engine_spills_within_a_dry_block(self):
        """A sharded paged engine whose block runs dry spills preempted
        tasks' pages to the host, as an unsharded engine does when the
        pool runs dry; tokens stay those of an uninterrupted run."""
        cfg = cfgs("dense")[1]
        p = params("dense")[1]
        eng = ServeEngine(cfg, p, n_slots=2, max_len=MAX_LEN, device="cpu",
                          page_size=PAGE, n_pages=12,
                          scheduler=_PrioritySharded(mesh2()))
        # one slot a block, 6 pages a block; no two prompts share a page
        prompt = [[(x * k) % 60 + 1 for x in range(n)]
                  for k, n in ((1, 30), (3, 20), (7, 25))]
        reqs = [Request(prompt=prompt[0], max_new_tokens=8, rid=0,
                        priority=1),
                Request(prompt=prompt[1], max_new_tokens=8, rid=1,
                        priority=1),
                Request(prompt=prompt[2], max_new_tokens=4, rid=2,
                        priority=0)]
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        eng.tick()
        eng.submit(reqs[2])
        got = {c.rid: c.tokens for c in eng.run_until_idle()}
        ref = ServeEngine(cfg, p, n_slots=2, max_len=MAX_LEN, device="cpu")
        for r in reqs:
            assert got[r.rid] == ref.generate([r.prompt],
                                              max_new_tokens=r.max_new_tokens
                                              )[0], r.rid
        st = eng.stats()
        assert st.preempted >= 1
        assert st.pages.get("spilled_pages", 0) > 0


class TestShardedCapsuleEngine:
    @pytest.fixture(scope="class")
    def deployed(self):
        cfg = ref_cn.CapsNetConfig(conv1_channels=8, caps_types=2,
                                   decoder_hidden=(16, 32))
        ref = RefPipeline(cfg).build(seed=0).compile(routing="optimized")
        port_cfg = port_cn.CapsNetConfig(conv1_channels=8, caps_types=2,
                                         decoder_hidden=(16, 32))
        port_p = convert.params_from_numpy(jax.tree.map(np.asarray,
                                                        ref.params))
        dep = FastCapsPipeline(port_cfg, params=port_p,
                               device="cpu").compile(routing="optimized")
        return ref, dep

    def test_slo_inner_classes_equal_reference(self, deployed):
        ref, dep = deployed
        sched = ShardedScheduler(mesh2(),
                                 inner=SLOBatchScheduler(target_p95_ms=1e9))
        assert sched.n_devices == 2
        eng = CapsuleEngine(dep, batch_size=4, scheduler=sched, device="cpu")
        # SLO inner: power-of-two buckets rounded up to device multiples
        assert sched.quantize(3, 4) == 4 and sched.quantize(1, 4) == 2
        assert sched.shapes(4) == (2, 4)
        # one replica for the one distinct device, shared by both blocks
        assert len(eng._replicas) == 2
        assert eng._replicas[0] is eng._replicas[1] is dep
        rng = np.random.RandomState(0)
        reqs = [ImageRequest(rng.rand(n, 28, 28, 1).astype(np.float32),
                             rid=i) for i, n in enumerate([3, 2])]
        comps = {c.rid: c for c in eng.serve(reqs)}
        for r in reqs:
            want = np.asarray(ref.classify(jax.numpy.asarray(r.images)))
            assert (comps[r.rid].classes == want).all()
        st = eng.stats()
        assert st.frames == 5 and st.ticks == 2

    def test_place_splits_in_frame_order(self, deployed):
        sched = ShardedScheduler(mesh2())
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        blocks = sched.place(x)
        assert [tuple(b.shape) for b in blocks] == [(4, 3), (4, 3)]
        assert np.array_equal(np.concatenate([b.numpy() for b in blocks]), x)
        # a batch that does not divide stays whole on the first device
        assert [tuple(b.shape) for b in sched.place(x[:3])] == [(3, 3)]


class TestMultihost:
    @pytest.mark.parametrize("cache", ("dense", "paged"))
    def test_tokens_equal_unified(self, cache):
        cfg = cfgs("dense")[1]
        p = params("dense")[1]
        kw = dict(page_size=PAGE) if cache == "paged" else {}
        eng = multihost_disaggregated_lm_engine(
            cfg, p, n_slots=2, max_len=MAX_LEN, n_decode=2,
            devices=["cpu"], **kw)
        # three engines, each on a mesh of its own over the one CPU
        meshes = [e.scheduler.mesh for e in [eng.prefill] + eng.decodes]
        assert len({id(m) for m in meshes}) == 3
        assert isinstance(eng.transport, InProcessTransport)
        got = served(eng)
        unified = ServeEngine(cfg, p, n_slots=2, max_len=MAX_LEN,
                              device="cpu", **kw)
        assert got == served(unified)
        assert eng.stats().transfer["in_process/total"].count == len(PROMPTS)

    def test_forced_device_to_device(self):
        cfg = cfgs("dense")[1]
        p = params("dense")[1]
        eng = multihost_disaggregated_lm_engine(
            cfg, p, n_slots=2, max_len=MAX_LEN, n_decode=2, devices=["cpu"],
            transport="device_to_device")
        got = served(eng)
        for i, q in enumerate(PROMPTS):
            assert got[i] == ref_generate("dense", q), i

    def test_auto_picks_by_devices(self):
        """device_to_device exactly when a decode engine's devices differ
        from the prefill engine's."""
        class Eng:
            def __init__(self, devices):
                self.scheduler = ShardedScheduler(make_mesh(
                    (len(devices),), ("data",), devices=devices))

        a, b = torch.device("cpu", 0), torch.device("cpu", 1)
        assert isinstance(select_transport(Eng([a]), [Eng([a])]),
                          InProcessTransport)
        assert isinstance(select_transport(Eng([a]), [Eng([a]), Eng([b])]),
                          DeviceToDeviceTransport)
        assert isinstance(select_transport(Eng([a, b]), [Eng([b, a])]),
                          InProcessTransport)


class TestLauncher:
    def test_sharded_scheduler_on_cpu(self, capsys):
        port_serve.main(["--arch", "llama3.2-1b", "--scheduler", "sharded",
                         "--requests", "2", "--max-new", "3",
                         "--device", "cpu"])
        assert "served 2 requests" in capsys.readouterr().out

    def test_multihost_runs(self, capsys):
        port_serve.main(["--arch", "llama3.2-1b", "--scheduler", "disagg",
                         "--multihost", "--requests", "2", "--max-new", "3",
                         "--device", "cpu"])
        out = capsys.readouterr().out
        assert "multihost: transport in_process" in out
        assert "served 2 requests" in out

    def test_multihost_needs_disagg(self):
        with pytest.raises(SystemExit) as err:
            port_serve.main(["--arch", "llama3.2-1b", "--multihost",
                             "--device", "cpu"])
        assert err.value.code == 2
