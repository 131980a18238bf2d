"""The routing and softmax kernels' plans and arithmetic, on the CPU.

The CUDA kernels (``csrc/routing.cu``, ``csrc/softmax.cu``) run only on the
card, where ``chip_smoke.py`` holds them against their plain versions.  Here:

* ``plan_i_splits`` gives portable cluster sizes whose slice of ``u_hat``
  fits a block's shared memory, fills the card as its rule says, keeps a
  tuned size that fits, and raises on an I that fits no cluster;
* the Python mirror of the kernels' geometry equals the sources' constants;
* a float32 emulation of the routing kernel's summation order (contiguous
  rank ranges, a fixed-order sum inside a rank, the ranks joined in order,
  the quads of a j joined by an xor tree) stays within each registry
  case's tolerance of the plain version, for every cluster size;
* the softmax tile planner and its dispatch boundaries;
* a tuner-cache entry written before ``i_splits`` existed still resolves.
"""

import re

import numpy as np
import pytest
import torch

from repro.kernels.registry import registry as ref_registry
from repro_torch.core import approx_math
from repro_torch.kernels import build
from repro_torch.kernels import tuning as port_tuning
from repro_torch.kernels.registry import registry as port_registry
from repro_torch.kernels.routing import routing_kernel as rk
from repro_torch.kernels.routing.ref import fused_routing_ref
from repro_torch.kernels.softmax import kernel as sk
from repro_torch.kernels.softmax.ref import taylor_softmax_ref
from torch_testlib import rand, to_torch

torch.set_num_threads(1)

SMS = 132


def _constant(source: str, name: str) -> int:
    text = (build.CSRC_DIR / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (source, name, found)
    return int(found[0])


class TestPlanISplits:
    @pytest.mark.parametrize("b,i,elem,want", [
        (32, 252, 4, 4),       # serve_pruned: 128 blocks
        (32, 1152, 4, 8),      # serve_dense: 4 fits, but one block an SM
        (32, 1152, 2, 8),
        (1, 252, 4, 8),        # a batch of 1: 8 blocks, all it can get
        (3, 1152, 4, 8),
        (17, 252, 4, 8),
        (64, 252, 4, 2),
        (256, 252, 4, 2),      # 1 fits and fills, but one block an SM
        (2, 20, 2, 8),
        (1, 4, 4, 4),          # no block without a capsule
        (1, 1, 4, 1),
    ])
    def test_fill_rule(self, b, i, elem, want):
        got = rk.plan_i_splits(b, i, 10, 16, elem)
        assert got == want
        assert rk.routing_smem_bytes(i, 10, 16, elem, got) <= rk.MAX_DYNAMIC_SMEM
        smaller = [s for s in rk.I_SPLITS if s < got and rk.routing_smem_bytes(
            i, 10, 16, elem, s) <= rk.MAX_DYNAMIC_SMEM]
        # every smaller size that fits leaves more than a quarter of the SMs
        # idle or takes an SM's shared memory alone
        assert all(4 * b * s < 3 * SMS or not rk.two_per_sm(
            rk.routing_smem_bytes(i, 10, 16, elem, s)) for s in smaller)

    @pytest.mark.parametrize("i", [1, 7, 20, 36, 252, 1152, 2300, 2376])
    @pytest.mark.parametrize("elem", [2, 4])
    def test_sizes_are_portable_and_fit(self, i, elem):
        for b in (1, 3, 17, 32, 64, 256):
            for asked in (0, 1, 2, 3, 4, 8, 16):
                s = rk.plan_i_splits(b, i, 10, 16, elem, asked)
                assert s in rk.I_SPLITS
                assert (rk.routing_smem_bytes(i, 10, 16, elem, s)
                        <= rk.MAX_DYNAMIC_SMEM)

    @pytest.mark.parametrize("asked,want", [(1, 4), (2, 4), (4, 4), (8, 8),
                                            (3, 4), (16, 8)])
    def test_asked_size_kept_where_it_fits(self, asked, want):
        # (32, 1152, 10, 16) float32 fits 4 and 8 blocks, not 1 or 2
        assert rk.plan_i_splits(32, 1152, 10, 16, 4, asked) == want

    def test_raises_on_i_that_fits_no_cluster(self):
        cap = rk.max_input_capsules(10, 16, 4)
        assert 2300 <= cap < 2600                 # about 2400 in float32
        assert rk.max_input_capsules(10, 16, 2) > cap
        rk.plan_i_splits(32, cap, 10, 16, 4)
        with pytest.raises(ValueError, match=f"at most {cap} input capsules"):
            rk.plan_i_splits(32, cap + 1, 10, 16, 4)

    def test_largest_capsnet_fits(self):
        """The repo's largest routing layer (capsnet_mnist / fmnist: 32
        types of 6 x 6) is far from the cap."""
        from repro_torch import configs

        for arch in ("capsnet-mnist", "capsnet-fmnist"):
            cfg = configs.get_config(arch)
            assert cfg.n_primary_caps == 1152
            assert rk.plan_i_splits(32, cfg.n_primary_caps, cfg.n_classes,
                                    cfg.digit_dim, 4) == 8

    def test_two_blocks_an_sm(self):
        assert rk.two_per_sm(rk.routing_smem_bytes(1152, 10, 16, 4, 8))
        assert not rk.two_per_sm(rk.routing_smem_bytes(1152, 10, 16, 4, 4))
        assert rk.two_per_sm(rk.routing_smem_bytes(252, 10, 16, 4, 4))
        assert not rk.two_per_sm(rk.SM_SMEM // 2)

    def test_shared_memory_of_the_main_shapes(self):
        """About 48 KB a block pruned over 4, 210 KB dense over 4 and 106 KB
        dense over 8 (float32), plus the rows' exps."""
        assert 45_000 < rk.routing_smem_bytes(252, 10, 16, 4, 4) < 56_000
        assert 205_000 < rk.routing_smem_bytes(1152, 10, 16, 4, 4) < 228_000
        assert 100_000 < rk.routing_smem_bytes(1152, 10, 16, 4, 8) < 118_000

    def test_cpu_tensor_of_any_i_takes_the_plain_version(self):
        """Off the card an I that fits no cluster still resolves (the plain
        version takes any I); only the card refuses it."""
        u = to_torch(rand(5, (1, 2600, 10, 16), 0.2))
        cfg = port_registry.default_config("fused_routing", u)
        assert cfg["i_splits"] == rk.ROUTING_MAX_CLUSTER
        v, c = port_registry.call("fused_routing", u, n_iters=2,
                                  softmax_mode="taylor")
        v_ref, _ = fused_routing_ref(u, n_iters=2, softmax_mode="taylor")
        assert c.shape == (1, 2600, 10) and torch.equal(v, v_ref)

    def test_wrapper_refuses_a_size_that_does_not_fit(self):
        u = torch.zeros(2, 1152, 10, 16)
        with pytest.raises(ValueError, match="shared memory"):
            rk._check_cuda(u, 2, 1024)
        with pytest.raises(ValueError, match="i_splits must be one of"):
            rk._check_cuda(u, 3, 1024)
        rk._check_cuda(u, 4, 1024)


class TestGeometryMatchesSources:
    @pytest.mark.parametrize("source,constant,value", [
        ("routing.cu", "kRoutingMaxCluster", rk.ROUTING_MAX_CLUSTER),
        ("routing.cu", "kRoutingMaxThreads", rk.ROUTING_MAX_THREADS),
        ("routing.cu", "kRoutingMaxSmem", rk.MAX_DYNAMIC_SMEM),
        ("routing.cu", "kRoutingBarBytes", rk.ROUTING_BAR_BYTES),
        ("softmax.cu", "kSoftmaxShortMax", sk.SHORT_ROW_MAX),
        ("softmax.cu", "kSoftmaxTileBytes", sk.TILE_BYTES),
    ])
    def test_constant(self, source, constant, value):
        assert _constant(source, constant) == value

    def test_cluster_sizes_are_the_registry_space(self):
        spec = port_registry.get("fused_routing")
        assert spec.space["i_splits"] == rk.I_SPLITS
        assert max(rk.I_SPLITS) == rk.ROUTING_MAX_CLUSTER

    def test_smem_sum_matches_source_terms(self):
        """The source's sum, term by term, as its comment lists it."""
        text = (build.CSRC_DIR / "routing.cu").read_text()
        assert "2LL * routing_pad4(rows * n_out)" in text
        assert "3 * jd + n_out" in text
        assert "kRoutingBarBytes + routing_slice_bytes" in text
        assert "(jd > kRoutingMaxThreads ? jd : kRoutingMaxThreads)" in text


# -- the routing kernel's summation order, emulated in float32 --------------


def _fma(a, b, c):
    """a * b + c rounded once, as the card's fused multiply-add does."""
    return (a.double() * b.double() + c.double()).float()


def _quad(n_out: int, dim: int, threads: int) -> bool:
    """J and D of the kernel's quad body, and a row's quads in the block."""
    return (n_out, dim) == (10, 16) and threads >= n_out * dim // 4


def _over_d(x: torch.Tensor, y: torch.Tensor, quad: bool) -> torch.Tensor:
    """sum_d x * y as the kernel adds it: in d order with fused
    multiply-adds (run-time body); or four d a lane, in order, and the
    lanes of one j as lane 0 of an xor butterfly sees them, offsets 1, 2,
    ... (quad body)."""
    dim = x.shape[-1]
    if not quad:
        acc = torch.zeros(x.shape[:-1])
        for d in range(dim):
            acc = _fma(x[..., d], y[..., d], acc)
        return acc
    xq = x.reshape(*x.shape[:-1], dim // 4, 4)
    yq = y.reshape(*y.shape[:-1], dim // 4, 4)
    lanes = xq[..., 0] * yq[..., 0]
    for k in range(1, 4):
        lanes = _fma(xq[..., k], yq[..., k], lanes)
    off = 1
    while off < dim // 4:
        lanes = lanes + lanes[..., torch.arange(dim // 4) ^ off]
        off *= 2
    return lanes[..., 0]


def emulate_routing(u: torch.Tensor, n_iters: int, mode: str, splits: int,
                    threads: int = 1024):
    """The kernel's arithmetic in float32 on the CPU: rank r owns rows
    [r I / S, (r + 1) I / S); inside a rank, `groups` thread groups each add
    every groups-th row in order, and the groups are added in order; the
    ranks' partials are added in rank order; |s_j|^2 and the agreement
    reduce over d as :func:`_over_d` says."""
    u = u.float()
    bsz, n_in, n_out, dim = u.shape
    jd = n_out * dim
    uf = u.reshape(bsz, n_in, jd)
    quad = _quad(n_out, dim, threads)
    lanes = jd // 4 if quad else jd             # threads of a row in the FC
    groups = max(1, min(threads // lanes, 1024 // jd))
    ranges = [(n_in * r // splits, n_in * (r + 1) // splits)
              for r in range(splits)]
    if mode == "taylor":
        def exp(x):
            return approx_math.taylor_exp(x, range_reduce=True)
    else:
        exp = torch.exp
    b = torch.zeros(bsz, n_in, n_out)
    c = v = None
    for it in range(n_iters):
        e = exp(b - b.max(-1, keepdim=True).values)
        denom = torch.zeros(bsz, n_in)
        for j in range(n_out):
            denom = denom + e[..., j]
        c = e / denom.clamp_min(1e-30)[..., None]
        cj = c.repeat_interleave(dim, dim=-1)           # c[i, col // D]
        s = torch.zeros(bsz, jd)
        for i0, i1 in ranges:
            part = torch.zeros(bsz, jd)
            for g in range(groups):
                acc = torch.zeros(bsz, jd)
                for i in range(i0 + g, i1, groups):
                    acc = _fma(cj[:, i], uf[:, i], acc)
                part = part + acc
            s = s + part
        s3 = s.view(bsz, n_out, dim)
        sq = _over_d(s3, s3, quad)
        f = sq * torch.rsqrt(sq + 1e-9) / (1.0 + sq)
        v = s3 * f[..., None]
        if it < n_iters - 1:
            b = b + _over_d(u, v[:, None].expand_as(u), quad)
    return v, c


ROUTING_CASES = [pytest.param(i, s, id=f"case{i}-splits{s}")
                 for i in range(len(port_registry.get(
                     "fused_routing").example_cases))
                 for s in rk.I_SPLITS]


class TestSummationOrder:
    @pytest.mark.parametrize("idx,splits", ROUTING_CASES)
    def test_emulation_within_case_tolerance(self, idx, splits):
        case = port_registry.get("fused_routing").example_cases[idx]
        u = to_torch(rand(case.get("seed", 0), case["shape"], 0.2))
        mode = case["softmax_mode"]
        v, c = emulate_routing(u, 3, mode, splits)
        v_ref, c_ref = fused_routing_ref(u, n_iters=3, softmax_mode=mode)
        np.testing.assert_allclose(v.numpy(), v_ref.numpy(), atol=case["atol"])
        np.testing.assert_allclose(c.numpy(), c_ref.numpy(), atol=case["atol"])

    @pytest.mark.parametrize("shape,threads", [((2, 20, 3, 12), 1024),
                                               ((3, 7, 3, 5), 1024),
                                               ((2, 24, 10, 16), 32),
                                               ((1, 252, 10, 16), 256)])
    def test_emulation_off_the_registry_shapes(self, shape, threads):
        """The run-time body (D = 12, D = 5, and J = 10, D = 16 with fewer
        threads than a row's quads), and the quad body at 256 threads."""
        u = to_torch(rand(3, shape, 0.2))
        v_ref, c_ref = fused_routing_ref(u, n_iters=3, softmax_mode="taylor")
        for splits in rk.I_SPLITS:
            v, c = emulate_routing(u, 3, "taylor", splits, threads)
            np.testing.assert_allclose(v.numpy(), v_ref.numpy(), atol=1e-4)
            np.testing.assert_allclose(c.numpy(), c_ref.numpy(), atol=1e-4)

    def test_registry_cases_are_the_references(self):
        assert (tuple(dict(c) for c in port_registry.get(
            "fused_routing").example_cases)
            == tuple(dict(c) for c in ref_registry.get(
                "fused_routing").example_cases))


# -- the softmax tile kernel ------------------------------------------------


class TestSoftmaxPlan:
    @pytest.mark.parametrize("n,body", [(1, "tile"), (10, "tile"),
                                        (32, "tile"), (33, "warp"),
                                        (128, "warp"), (129, "block"),
                                        (1024, "block")])
    def test_dispatch_boundaries(self, n, body):
        assert sk.softmax_body(n) == body

    @pytest.mark.parametrize("rows,n,elem,threads,want", [
        (32 * 252, 10, 4, 256, 64),     # the routing softmax: 126 blocks
        (32 * 252, 10, 2, 256, 64),
        (1000, 10, 4, 256, 32),
        (1, 10, 4, 256, 32),
        (10 ** 6, 10, 4, 256, 256),     # capped by the threads asked for
        (10 ** 6, 32, 4, 1024, 256),    # capped by the tile's bytes
        (10 ** 6, 32, 2, 1024, 512),
    ])
    def test_tile_rows(self, rows, n, elem, threads, want):
        got = sk.softmax_tile_rows(rows, n, elem, threads)
        assert got == want and got % 32 == 0
        assert got * n * elem <= sk.TILE_BYTES

    def test_tile_gives_about_one_block_per_sm(self):
        r = sk.softmax_tile_rows(32 * 252, 10, 4, 256)
        blocks = -(-32 * 252 // r)
        assert SMS - 32 <= blocks <= SMS

    @pytest.mark.parametrize("shape", [(8064, 10), (999, 7), (100, 32)])
    def test_one_thread_per_row_order(self, shape):
        """A row's exps summed in element order, as the tile kernel's
        thread does, agree with the plain version to 1e-6."""
        x = to_torch(rand(4, shape, 5.0))
        e = approx_math.taylor_exp(x - x.max(-1, keepdim=True).values,
                                   range_reduce=True)
        denom = torch.zeros(shape[0])
        for k in range(shape[1]):
            denom = denom + e[:, k]
        got = e / denom.clamp_min(1e-30)[:, None]
        np.testing.assert_allclose(got.numpy(), taylor_softmax_ref(x).numpy(),
                                   atol=1e-6)


# -- tuner cache entries from before i_splits -------------------------------


def test_cached_entry_with_only_threads_resolves(tmp_path, monkeypatch):
    """A winner cached as ``{"threads": 256}`` (before the cluster size
    was a tunable) merges with the base config and is legalized: the size
    is planned, the threads kept."""
    monkeypatch.setenv(port_tuning.CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(port_tuning, "backend_of", lambda args: "cuda")
    spec = port_registry.get("fused_routing")
    u = torch.zeros(32, 252, 10, 16)
    cache = port_tuning.default_cache()
    cache.put(port_tuning.cache_key_for(spec, (u,)), {"threads": 256}, {})
    cfg = port_registry.resolve_config("fused_routing", u, tune=True,
                                       n_iters=3, softmax_mode="taylor")
    assert cfg == {"i_splits": 4, "threads": 256}
