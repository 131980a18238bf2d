"""Port parity for the kernel subsystem (``repro_torch.kernels``) on the CPU.

The plain PyTorch versions of both CUDA kernels are held against the
reference's Pallas kernels, run as the reference's own tests run them on the
CPU (interpret mode, the default off a TPU), on every ``example_cases`` shape
with that case's ``atol``.  The CUDA kernels themselves run only on the card
and are checked there by ``chip_smoke.py``; here the wrappers are shown to
take the plain version for a CPU tensor and to refuse what they do not take.
Registry, legalisation, tuning policy and cache are compared with the
reference's where they share semantics.
"""

import importlib
import os
import threading

import numpy as np
import pytest
import torch

from repro import kernels as ref_kernels
from repro.kernels import tuning as ref_tuning
from repro_torch import kernels as port_kernels
from repro_torch.kernels import build
from repro_torch.kernels import tuning as port_tuning
from repro_torch.kernels.registry import registry as port_registry
from repro_torch.kernels.routing import routing_kernel
from repro_torch.kernels.softmax import kernel as softmax_kernel
from torch_testlib import f32, rand, to_jax, to_torch

torch.set_num_threads(1)

# the packages re-export the registry *object* under the module's name
ref_registry_mod = importlib.import_module("repro.kernels.registry")
port_registry_mod = importlib.import_module("repro_torch.kernels.registry")
ref_registry = ref_registry_mod.registry
PORTED = ("fused_routing", "taylor_softmax")

CASES = [pytest.param(name, i, id=f"{name}-case{i}")
         for name in PORTED
         for i in range(len(port_registry.get(name).example_cases))]


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _case_input(case):
    scale = 0.2 if "softmax_mode" in case else case.get("scale", 5.0)
    return rand(case.get("seed", 0), case["shape"], scale)


class TestRegistryEntries:
    def test_inventory(self):
        """The reference's kernels, plus the backward of row 2, which the
        reference leaves to ``jax.grad`` of its plain softmax, and the
        fixed-order GEMM, which the reference leaves to XLA's dot."""
        assert port_registry.names() == sorted(
            PORTED + ("flash_attention", "flash_attention_dequant",
                      "decode_attention", "fused_sampling",
                      "taylor_softmax_bwd", "fixed_order_matmul"))
        assert port_registry.names() == sorted(
            ref_registry.names() + ["taylor_softmax_bwd",
                                    "fixed_order_matmul"])

    @pytest.mark.parametrize("name", PORTED)
    def test_example_cases_copied_from_reference(self, name):
        assert (tuple(dict(c) for c in port_registry.get(name).example_cases)
                == tuple(dict(c) for c in ref_registry.get(name).example_cases))

    @pytest.mark.parametrize("name", PORTED)
    def test_ref_accepts_copied(self, name):
        assert (port_registry.get(name).ref_accepts
                == ref_registry.get(name).ref_accepts)

    def test_unknown_kernel_raises(self):
        with pytest.raises(ValueError, match="unknown kernel"):
            port_registry.get("no_such_kernel")

    @pytest.mark.parametrize("name", PORTED)
    def test_tunable_is_launch_geometry(self, name):
        """Threads per block for both; the routing kernel also tunes its
        cluster size (portable sizes; 0 in the base config asks the
        planner)."""
        spec = port_registry.get(name)
        want = (("i_splits", "threads") if name == "fused_routing"
                else ("threads",))
        assert spec.tuned == want
        assert all(t % 32 == 0 and 32 <= t <= 1024
                   for t in spec.space["threads"])
        assert spec.base_config["threads"] in spec.space["threads"]
        if name == "fused_routing":
            assert spec.space["i_splits"] == (1, 2, 4, 8)
            assert spec.base_config["i_splits"] == 0


class TestPlainVersionsMatchReferenceKernels:
    @pytest.mark.parametrize("name,idx", CASES)
    def test_plain_version_vs_pallas_interpret(self, name, idx):
        case = port_registry.get(name).example_cases[idx]
        dtype = case.get("dtype", "float32")
        x = _case_input(case)
        kwargs = ({"n_iters": 3, "softmax_mode": case["softmax_mode"]}
                  if name == "fused_routing" else {})
        want = getattr(ref_kernels, name)(to_jax(x, dtype), **kwargs)
        got = port_registry.get(name).ref_call(to_torch(x, dtype), **kwargs)
        for g, w in zip(_leaves(got), _leaves(want)):
            assert tuple(g.shape) == tuple(w.shape)
            np.testing.assert_allclose(f32(g), f32(w), atol=case["atol"])

    @pytest.mark.parametrize("name,idx", CASES)
    def test_wrapper_on_cpu_tensor_is_the_plain_version(self, name, idx):
        spec = port_registry.get(name)
        case = spec.example_cases[idx]
        args, kwargs = spec.make_example(case, device="cpu")
        before = spec.build().launches
        got = port_registry.call(name, *args, **kwargs)
        want = spec.ref_call(*args, **kwargs)
        for g, w in zip(_leaves(got), _leaves(want)):
            assert g.dtype == w.dtype
            assert torch.equal(g, w)
        assert spec.build().launches == before      # no kernel was launched

    @pytest.mark.parametrize("mode,atol", [("exact", 1e-5), ("taylor", 1e-4)])
    @pytest.mark.parametrize("n_iters", [1, 2, 3])
    def test_routing_iterations(self, mode, atol, n_iters):
        u = rand(11, (2, 24, 10, 16), 0.2)
        v_ref, c_ref = ref_kernels.fused_routing(
            to_jax(u), n_iters=n_iters, softmax_mode=mode)
        v, c = port_kernels.fused_routing(
            to_torch(u), n_iters=n_iters, softmax_mode=mode)
        np.testing.assert_allclose(f32(v), f32(v_ref), atol=atol)
        np.testing.assert_allclose(f32(c), f32(c_ref), atol=atol)

    def test_routing_bf16_output_types(self):
        u = to_torch(rand(12, (2, 24, 10, 16), 0.2), "bfloat16")
        v, c = port_kernels.fused_routing(u, softmax_mode="taylor")
        assert v.dtype == torch.bfloat16 and c.dtype == torch.float32
        v_ref, c_ref = ref_kernels.fused_routing(
            to_jax(f32(u), "bfloat16"), softmax_mode="taylor")
        # bf16 output rounds at 2^-8 relative; the couplings are float32
        np.testing.assert_allclose(f32(v), f32(v_ref), atol=1e-2)
        np.testing.assert_allclose(f32(c), f32(c_ref), atol=1e-4)


class TestWrapperChecks:
    def test_routing_rejects_bad_rank(self):
        with pytest.raises(ValueError, match=r"\(B, I, J, D\)"):
            routing_kernel.fused_routing_cuda(torch.zeros(2, 3, 4))

    def test_routing_rejects_bad_mode(self):
        with pytest.raises(ValueError, match="softmax_mode"):
            routing_kernel.fused_routing_cuda(torch.zeros(1, 2, 3, 4),
                                              softmax_mode="fast")

    def test_routing_rejects_zero_iters(self):
        with pytest.raises(ValueError, match="n_iters"):
            routing_kernel.fused_routing_cuda(torch.zeros(1, 2, 3, 4),
                                              n_iters=0)

    def test_routing_rejects_meta_device(self):
        """On the meta device (a dry run) what the card refuses is refused;
        a u_hat it takes gives meta (v, c) and no launch."""
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            routing_kernel.fused_routing_cuda(
                torch.zeros(1, 2, 3, 4, device="meta", dtype=torch.float64))
        with pytest.raises(ValueError, match="shared memory"):
            routing_kernel.fused_routing_cuda(
                torch.zeros(1, 4000, 10, 16, device="meta"))
        launches = routing_kernel.fused_routing_cuda.launches
        v, c = routing_kernel.fused_routing_cuda(
            torch.zeros(1, 2, 3, 4, device="meta"))
        assert (v.shape, c.shape) == ((1, 3, 4), (1, 2, 3))
        assert v.device.type == c.device.type == "meta"
        assert routing_kernel.fused_routing_cuda.launches == launches

    def test_softmax_rejects_meta_device(self):
        """The same for the softmax: float64 refused, float32 a meta
        result and no launch."""
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            softmax_kernel.taylor_softmax_cuda(
                torch.zeros(2, 3, device="meta", dtype=torch.float64))
        launches = softmax_kernel.taylor_softmax_cuda.launches
        y = softmax_kernel.taylor_softmax_cuda(torch.zeros(2, 3,
                                                           device="meta"))
        assert y.device.type == "meta" and y.shape == (2, 3)
        assert softmax_kernel.taylor_softmax_cuda.launches == launches

    def test_softmax_rejects_scalar(self):
        with pytest.raises(ValueError, match="at least one axis"):
            softmax_kernel.taylor_softmax_cuda(torch.tensor(1.0))

    def test_launch_counters_exist_and_start_at_zero_or_more(self):
        assert isinstance(routing_kernel.fused_routing_cuda.launches, int)
        assert isinstance(softmax_kernel.taylor_softmax_cuda.launches, int)

    def test_check_launch_raises_on_error_code(self):
        build.check_launch(0, "ok")
        with pytest.raises(build.KernelLaunchError, match="code 9"):
            build.check_launch(9, "fused_routing")


class TestBuild:
    def test_sources_are_in_the_package(self):
        for name in build.SOURCES + build.HEADERS:
            assert (build.CSRC_DIR / name).is_file(), name

    def test_flags_target_hopper(self):
        assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
        assert "-std=c++17" in build.NVCC_FLAGS

    def test_build_dir_override(self, monkeypatch, tmp_path):
        monkeypatch.setenv(build.BUILD_DIR_ENV, str(tmp_path))
        assert build.build_dir() == tmp_path
        monkeypatch.delenv(build.BUILD_DIR_ENV)
        assert build.build_dir().name == "build"

    def test_missing_nvcc_raises_build_error(self, monkeypatch):
        monkeypatch.setenv("PATH", "")
        monkeypatch.delenv("CUDA_HOME", raising=False)
        if os.path.exists("/usr/local/cuda/bin/nvcc"):
            pytest.skip("a CUDA toolkit is installed on this host")
        with pytest.raises(build.KernelBuildError, match="nvcc not found"):
            build.find_nvcc()

    def test_every_included_header_is_hashed(self):
        """A header a source includes is part of the build's content hash,
        so editing it rebuilds the library."""
        import re

        for name in build.SOURCES + build.HEADERS:
            text = (build.CSRC_DIR / name).read_text()
            for inc in re.findall(r'#include "([^"]+)"', text):
                assert inc in build.HEADERS, (name, inc)

    def test_stream_query_takes_the_private_query_where_it_exists(
            self, monkeypatch):
        """The wrappers take PyTorch's private raw-stream query when the
        build has it, and the public current_stream route when it does not
        (a PyTorch that renames the private one still launches)."""
        def private(index):
            return 1000 + index

        class FakeStream:
            def __init__(self, index):
                self.cuda_stream = 2000 + index

        monkeypatch.setattr(torch.cuda, "current_stream", FakeStream)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", private,
                            raising=False)
        assert build.stream_query() is private
        monkeypatch.setattr(build, "_raw_stream", None)
        assert build.raw_stream(3) == 1003
        monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream")
        assert build.stream_query()(3) == 2003
        monkeypatch.setattr(build, "_raw_stream", None)
        assert build.raw_stream(1) == 2001

    def test_source_hash_is_stable(self):
        assert build._source_hash() == build._source_hash()
        assert len(build._source_hash()) == 16

    def test_kernel_sources_share_one_polynomial(self):
        """The Eq. 2 constants are written once, in the shared header."""
        header = (build.CSRC_DIR / "approx_math.cuh").read_text()
        for c in ("0.60653f", "0.60659f", "0.30260f", "0.10347f",
                  "0.02118f", "0.00833f", "1.6487212707001282f"):
            assert c in header
            for src in build.SOURCES:
                assert c not in (build.CSRC_DIR / src).read_text()


class TestLegalize:
    @pytest.mark.parametrize("asked,want", [(1, 32), (31, 32), (32, 32),
                                            (100, 96), (512, 512),
                                            (1024, 1024), (5000, 1024)])
    def test_threads_become_whole_warps(self, asked, want):
        got = port_registry_mod._legalize_threads({"threads": asked})
        assert got == {"threads": want}
        assert port_registry_mod._legalize_threads(dict(got)) == got

    @pytest.mark.parametrize("name", PORTED)
    def test_default_config_deterministic(self, name):
        spec = port_registry.get(name)
        args, kwargs = spec.make_example(spec.example_cases[0])
        c1 = port_registry.default_config(name, *args, **kwargs)
        assert c1 == port_registry.default_config(name, *args, **kwargs)
        # the routing cluster size is planned: 4 images of 24 capsules
        # take the largest cluster, 8 blocks an image
        planned = {"i_splits": 8} if name == "fused_routing" else {}
        assert c1 == {**spec.base_config, **planned}

    def test_override_is_legalized(self):
        u = torch.zeros(1, 4, 3, 8)
        cfg = port_registry.resolve_config("fused_routing", u,
                                           overrides={"threads": 200})
        # 4 capsules: no more blocks than capsules
        assert cfg == {"i_splits": 4, "threads": 192}


@pytest.fixture
def tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(port_tuning.CACHE_ENV, str(tmp_path))
    monkeypatch.delenv(port_tuning.TUNE_ENV, raising=False)
    return port_tuning.default_cache()


class TestTuning:
    @pytest.mark.parametrize("n,cap", [(9, 8), (32, 8), (7, 16), (1, 1),
                                       (252, 16), (1152, 100)])
    def test_largest_divisor_matches_reference(self, n, cap):
        assert (port_tuning.largest_divisor(n, cap)
                == ref_tuning.largest_divisor(n, cap))

    @pytest.mark.parametrize("n,cap", [(0, 4), (4, 0), (-1, 2)])
    def test_largest_divisor_rejects_nonpositive(self, n, cap):
        with pytest.raises(ValueError):
            port_tuning.largest_divisor(n, cap)

    def test_shape_bucket_and_label_match_reference(self):
        shapes = [(9, 252, 10, 16), (3,), ()]
        assert port_tuning.shape_bucket(shapes) == ref_tuning.shape_bucket(shapes)
        cfg = {"threads": 256, "a": 1}
        assert port_tuning.config_label(cfg) == ref_tuning.config_label(cfg)

    def test_cache_key_names_device_and_dtype(self):
        spec = port_registry.get("fused_routing")
        u = torch.zeros(9, 252, 10, 16)
        assert (port_tuning.cache_key_for(spec, (u,))
                == "fused_routing|cpu|16x256x16x16|float32")
        assert port_tuning.cache_key_for(
            spec, (u.to(torch.bfloat16),)).endswith("|bfloat16")

    def test_scope_overrides_env(self, monkeypatch):
        monkeypatch.setenv(port_tuning.TUNE_ENV, "1")
        assert port_tuning.tune_enabled()
        with port_tuning.tuning(False):
            assert not port_tuning.tune_enabled()
        assert port_tuning.tune_enabled()
        monkeypatch.setenv(port_tuning.TUNE_ENV, "0")
        assert not port_tuning.tune_enabled()
        with port_tuning.tuning(True):
            assert port_tuning.tune_enabled()

    def test_scope_is_thread_local(self):
        seen = {}

        def other():
            seen["tune"] = port_tuning.tune_enabled()

        with port_tuning.tuning(True):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert seen["tune"] is False

    def test_cache_roundtrip_and_persistence(self, tune_cache):
        key = port_tuning.TuneCache.key("k", "cuda", "8x8", "float32")
        assert tune_cache.get(key) is None
        tune_cache.put(key, {"threads": 256}, {"threads=256": 1e-4})
        assert tune_cache.get(key) == {"threads": 256}
        fresh = port_tuning.TuneCache(tune_cache.path)
        assert fresh.get(key) == {"threads": 256}
        assert fresh.entry(key)["timings"] == {"threads=256": 1e-4}

    def test_corrupt_cache_degrades_to_empty(self, tmp_path):
        path = tmp_path / "autotune.json"
        path.write_text("{not json")
        assert port_tuning.TuneCache(str(path)).get("x") is None

    def test_candidates_are_legal_and_include_base(self):
        spec = port_registry.get("fused_routing")
        u = torch.zeros(2, 24, 10, 16)
        cands = port_tuning.candidate_configs(spec, u)
        assert cands[0] == {**spec.base_config, "i_splits": 8}
        assert sorted((c["i_splits"], c["threads"]) for c in cands) == [
            (s, t) for s in (1, 2, 4, 8) for t in (128, 256, 512, 1024)]

    def test_autotune_picks_fastest_with_injected_timer(self, tune_cache):
        spec = port_registry.get("fused_routing")
        u = to_torch(rand(0, (2, 24, 10, 16), 0.2))
        kwargs = {"n_iters": 3, "softmax_mode": "taylor"}
        cands = port_tuning.candidate_configs(spec, u, **kwargs)
        cost = {(c["i_splits"], c["threads"]): 10.0 + k
                for k, c in enumerate(cands)}
        cost[(2, 256)] = 1.0
        calls = []

        def timer(fn, warmup, iters):
            out = fn()                      # the candidate really runs
            assert out[0].shape == (2, 10, 16)
            c = cands[len(calls)]           # measured in candidate order
            calls.append(1)
            return cost[(c["i_splits"], c["threads"])]

        best, timings = port_tuning.autotune(
            spec, (u,), kwargs, cache=tune_cache, timer=timer)
        assert best == {"i_splits": 2, "threads": 256}
        assert len(calls) == len(cands) == 16
        assert timings["i_splits=2,threads=256"] == 1.0
        assert timings["i_splits=8,threads=256"] == 10.0   # the base, first
        assert tune_cache.get(port_tuning.cache_key_for(spec, (u,))) == best

    def test_cpu_tensors_never_tune(self, tune_cache):
        """With tuning on, a CPU tensor still resolves the defaults and
        measures nothing: its wrapper runs the plain version."""
        u = to_torch(rand(0, (2, 24, 10, 16), 0.2))
        with port_tuning.tuning(True):
            cfg = port_registry.resolve_config("fused_routing", u)
            v, c = port_kernels.fused_routing(u, softmax_mode="taylor")
        assert cfg == {"i_splits": 8, "threads": 256}
        assert not os.path.exists(tune_cache.path)
        assert v.shape == (2, 10, 16) and c.shape == (2, 24, 10)
