"""Port parity for fused sampling on the CPU.

The plain version (``repro_torch.kernels.sampling.sample_tokens``, which
the ``fused_sampling`` wrapper takes for CPU tensors) must give the same
integer tokens as the reference's ``sample_tokens`` on the registry's
example cases and on a full llama vocabulary; the counter hash must give
the same bits; the host path must give the same tokens as the reference's
host path.  The CUDA kernel runs only on the card (``chip_smoke.py`` holds
it against the plain version there, integer-equal).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sampling import ref as jref
from repro_torch import kernels as port_kernels
from repro_torch.kernels.registry import registry as port_registry
from repro_torch.kernels.sampling import kernel as port_kernel
from repro_torch.kernels.sampling import ref as pref

torch.set_num_threads(1)

ref_registry = importlib.import_module("repro.kernels.registry").registry
SPEC = port_registry.get("fused_sampling")
CASES = [pytest.param(i, id=f"case{i}") for i in range(len(SPEC.example_cases))]


def _jax(x):
    return jnp.asarray(x.numpy())


def test_example_cases_copied_from_reference():
    assert (tuple(dict(c) for c in SPEC.example_cases)
            == tuple(dict(c) for c in ref_registry.get("fused_sampling")
                     .example_cases))


@pytest.mark.parametrize("idx", CASES)
def test_plain_version_equals_reference(idx):
    args, _ = SPEC.make_example(SPEC.example_cases[idx], device="cpu")
    want = np.asarray(jref.sample_tokens(*map(_jax, args)))
    got = port_registry.call("fused_sampling", *args)
    assert got.dtype == torch.int32 and got.shape == (args[0].shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    ((0.0, 0.0), (0, 0), (1.0, 1.0)),
    ((0.8, 1.0), (50, 0), (0.9, 1.0)),
    ((0.8, 1.3), (0, 7), (0.95, 0.5)),
])
def test_full_vocabulary_equals_reference(temperature, top_k, top_p):
    v = 128256
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(
        (rng.standard_normal((2, v)) * 3.0).astype(np.float32))
    rows = (torch.tensor(temperature, dtype=torch.float32),
            torch.tensor([123, 0x7FFFFFF0], dtype=torch.int32),
            torch.tensor([17, 700], dtype=torch.int32),
            torch.tensor(top_k, dtype=torch.int32),
            torch.tensor(top_p, dtype=torch.float32))
    want = np.asarray(jref.sample_tokens(_jax(logits), *map(_jax, rows)))
    got = port_kernel.fused_sampling_cuda(logits, *rows)
    np.testing.assert_array_equal(got.numpy(), want)


def test_counter_hash_bits_equal_reference():
    rng = np.random.RandomState(1)
    seeds = rng.randint(-2**31, 2**31 - 1, 16).astype(np.int32)
    pos = rng.randint(0, 1 << 20, 16).astype(np.int32)
    want = np.asarray(jref._uniform_lanes(jnp.asarray(seeds),
                                          jnp.asarray(pos), 16, 300))
    got = pref._uniform_lanes(torch.from_numpy(seeds), torch.from_numpy(pos),
                              300).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(temperature=0.0),
                                dict(temperature=0.8, top_k=8, top_p=0.95),
                                dict(temperature=1.2, top_k=0, top_p=0.5),
                                dict(temperature=0.5, top_k=3)])
def test_host_path_equals_reference_host_path(kw):
    rng = np.random.RandomState(3)
    for r in range(4):
        row = (rng.standard_normal(300) * 2.0).astype(np.float32)
        args = dict(kw, seed=1000 + r, pos=7 * r + 1)
        temperature = args.pop("temperature")
        assert (pref.sample_token_host(row, temperature, **args)
                == jref.sample_token_host(row, temperature, **args))


def test_greedy_is_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 5.0, 5.0, 5.0]])
    got = port_kernels.fused_sampling(logits, 0.0, 0, 0)
    assert got.tolist() == [1, 0]


def test_ergonomic_wrapper_broadcasts_and_wraps_seeds():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    got = port_kernels.fused_sampling(logits, 0.9, np.uint32(0xF0000001),
                                      np.array([1, 2, 3]), top_k=5)
    seeds = torch.full((3,), np.int32(np.uint32(0xF0000001).view(np.int32)),
                       dtype=torch.int32)
    want = pref.sample_tokens(logits, torch.full((3,), 0.9), seeds,
                              torch.tensor([1, 2, 3], dtype=torch.int32),
                              torch.full((3,), 5, dtype=torch.int32),
                              torch.ones(3))
    assert torch.equal(got, want)


def test_ergonomic_wrapper_keeps_per_row_floats():
    """The per-row settings travel as one int32 block with the float rows
    bit-cast; float64 host values round to float32 as a cast would."""
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    temp = np.array([0.0, 0.7, 1.3, 0.9])
    top_p = np.array([1.0, 0.35, 0.9, 0.6])
    got = port_kernels.fused_sampling(logits, temp, [3, 4, 5, 6],
                                      [9, 8, 7, 6], top_k=[0, 9, 3, 0],
                                      top_p=top_p)
    want = pref.sample_tokens(
        logits, torch.tensor(temp, dtype=torch.float32),
        torch.tensor([3, 4, 5, 6], dtype=torch.int32),
        torch.tensor([9, 8, 7, 6], dtype=torch.int32),
        torch.tensor([0, 9, 3, 0], dtype=torch.int32),
        torch.tensor(top_p, dtype=torch.float32))
    assert torch.equal(got, want)


def test_cpu_call_launches_nothing():
    args, _ = SPEC.make_example(SPEC.example_cases[1], device="cpu")
    before = port_kernel.fused_sampling_cuda.launches
    port_registry.call("fused_sampling", *args)
    assert port_kernel.fused_sampling_cuda.launches == before


class TestWrapperChecks:
    def _rows(self, b, device="cpu"):
        return (torch.zeros(b, device=device),
                torch.zeros(b, dtype=torch.int32, device=device),
                torch.zeros(b, dtype=torch.int32, device=device),
                torch.zeros(b, dtype=torch.int32, device=device),
                torch.ones(b, device=device))

    def test_rejects_bad_shapes(self):
        with pytest.raises(ValueError, match=r"\(B, V\)"):
            port_kernel.fused_sampling_cuda(torch.zeros(4), *self._rows(4))
        with pytest.raises(ValueError, match="temperature"):
            port_kernel.fused_sampling_cuda(torch.zeros(3, 8), *self._rows(4))

    def test_rejects_meta_and_mixed_devices(self):
        # on the meta device (a dry run) the card's checks hold; a call it
        # takes gives meta tokens and no launch
        with pytest.raises(TypeError, match="float32 logits"):
            port_kernel.fused_sampling_cuda(
                torch.zeros(2, 8, device="meta", dtype=torch.float64),
                *self._rows(2, "meta"))
        launches = port_kernel.fused_sampling_cuda.launches
        tok = port_kernel.fused_sampling_cuda(
            torch.zeros(2, 8, device="meta"), *self._rows(2, "meta"))
        assert tok.device.type == "meta" and tok.dtype == torch.int32
        assert tok.shape == (2,)
        assert port_kernel.fused_sampling_cuda.launches == launches
        with pytest.raises(ValueError, match="on meta"):
            port_kernel.fused_sampling_cuda(torch.zeros(2, 8),
                                            *self._rows(2, "meta"))


# ---------------------------------------------------------------------------
# The cluster kernel's arithmetic (csrc/sampling.cu), modelled on the CPU
# ---------------------------------------------------------------------------

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402


def _multilevel_lo(lo, hi, pred, levels, steps=pref._BISECT_STEPS):
    """The kernel's bisection: per pass the 2^L - 1 midpoints the next L
    steps can take (heap order, each 0.5 * (lo' + hi') of its own
    interval), the predicate at every one of them in one sweep, then the L
    decisions walked.  ``pred(mid)`` maps (b,) midpoints to (b,) bools."""
    done = 0
    while done < steps:
        n_levels = min(levels, steps - done)
        nodes = (1 << n_levels) - 1
        nlo, nhi, mids = [lo] + [None] * nodes, [hi] + [None] * nodes, []
        for n in range(nodes):
            mids.append(0.5 * (nlo[n] + nhi[n]))
            if 2 * n + 2 < nodes:
                nlo[2 * n + 1], nhi[2 * n + 1] = nlo[n], mids[n]
                nlo[2 * n + 2], nhi[2 * n + 2] = mids[n], nhi[n]
        ge = [pred(m) for m in mids]
        node = torch.zeros_like(lo, dtype=torch.int64)
        for _ in range(n_levels):
            mid = torch.stack(mids, dim=-1).gather(-1, node[:, None])[:, 0]
            up = torch.stack(ge, dim=-1).gather(-1, node[:, None])[:, 0]
            lo = torch.where(up, mid, lo)
            hi = torch.where(up, hi, mid)
            node = torch.where(up, 2 * node + 2, 2 * node + 1)
        done += n_levels
    return lo


def _kernel_lo(z, k, p, levels):
    """(lo_k, lo_p) of the multi-level walk, as the kernel runs it."""
    b, v = z.shape
    k_eff = torch.clamp(torch.where(k <= 0, v, k), 1, v)
    probs = pref._probs(z)
    lo_k = _multilevel_lo(
        z.amin(dim=-1), z.amax(dim=-1),
        lambda mid: (z >= mid[:, None]).sum(dim=-1) >= k_eff, levels)
    lo_p = _multilevel_lo(
        z.amin(dim=-1) - 1.0, z.amax(dim=-1),
        lambda mid: torch.where(z > mid[:, None], probs, 0.0).sum(dim=-1)
        >= p, levels)
    return lo_k, lo_p


_ROW_VALUES = st.sampled_from([-3.0, -1.0, 0.0, 0.5, 1.0, 2.0, 7.25])


@st.composite
def _rows(draw):
    """A row with ties (values from a small set), a constant row, or
    arbitrary floats; k in {1, V - 1, V} or any; p near 0 or 1 or any."""
    v = draw(st.integers(2, 48))
    kind = draw(st.sampled_from(["ties", "constant", "floats"]))
    if kind == "ties":
        row = draw(st.lists(_ROW_VALUES, min_size=v, max_size=v))
    elif kind == "constant":
        row = [draw(_ROW_VALUES)] * v
    else:
        row = draw(st.lists(st.floats(-30, 30, width=32), min_size=v,
                            max_size=v))
    k = draw(st.sampled_from([1, v - 1, v, draw(st.integers(1, v))]))
    p = draw(st.sampled_from([1e-6, 0.01, 0.5, 0.9, 0.999, 0.999999,
                              draw(st.floats(0.0, 1.0, width=32))]))
    t = draw(st.sampled_from([0.5, 0.8, 1.0, 1.7]))
    return row, k, p, t


@pytest.mark.parametrize("levels", [1, 2, port_kernel.SAMPLE_LEVELS, 4, 5])
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(case=_rows())
def test_multilevel_bisection_takes_the_sequential_floats(levels, case):
    """The kernel's L-levels-per-pass walk ends on the very floats lo_k
    and lo_p of the 30-step sequential bisection of sample_tokens, for the
    kernel's L and others (30 % L != 0 ends with a shorter pass)."""
    row, k, p, t = case
    x = torch.tensor([row], dtype=torch.float32)
    z = x / torch.clamp(torch.tensor([t], dtype=torch.float32), min=1e-6)[:, None]
    kt = torch.tensor([k], dtype=torch.int64)
    pt = torch.tensor([p], dtype=torch.float32)
    lo_k, lo_p = _kernel_lo(z, kt, pt, levels)
    assert torch.equal(lo_k, pref._topk_lo(z, kt))
    assert torch.equal(lo_p, pref._topp_lo(z, pt, pref._probs(z)))


def test_multilevel_bisection_on_a_llama_row():
    rng = np.random.RandomState(11)
    z = torch.from_numpy((rng.standard_normal((3, 128256)) * 3.0 / 0.8)
                         .astype(np.float32))
    k = torch.tensor([50, 1, 128255])
    p = torch.tensor([0.9, 1e-4, 0.999], dtype=torch.float32)
    lo_k, lo_p = _kernel_lo(z, k, p, port_kernel.SAMPLE_LEVELS)
    assert torch.equal(lo_k, pref._topk_lo(z, k))
    assert torch.equal(lo_p, pref._topp_lo(z, p, pref._probs(z)))


@pytest.mark.parametrize("constant,name", [
    ("kSampleLevels", "SAMPLE_LEVELS"),
    ("kSampleVals", "SAMPLE_VALS"),
    ("kSampleMaxWarps", "SAMPLE_MAX_WARPS"),
    ("kSampleMaxCluster", "SAMPLE_MAX_CLUSTER"),
    ("kSampleMaxSmem", "MAX_DYNAMIC_SMEM"),
])
def test_planner_constants_match_cuda_source(constant, name):
    """The registry plans cluster sizes from the wrapper module's copy of
    the kernel's geometry; it must be the source's own."""
    import re

    from repro_torch.kernels import build

    text = (build.CSRC_DIR / "sampling.cu").read_text()
    found = re.findall(rf"constexpr int {constant} = (\d+);", text)
    assert found == [str(getattr(port_kernel, name))]


def test_planner_formulas_match_cuda_source():
    """The slice and shared-memory sums, as the source writes them."""
    from repro_torch.kernels import build

    text = " ".join((build.CSRC_DIR / "sampling.cu").read_text().split())
    assert "return ((V + cluster - 1) / cluster + 3) / 4 * 4;" in text
    assert ("return 2LL * sampling_slice(V, cluster) + (long long)"
            "(kSampleMaxWarps + 3) * kSampleVals + 2LL * kSampleMaxCluster;"
            ) in text


@pytest.mark.parametrize("v", [33, 50, 64, 4096, 32000, 128256, 128257,
                               151936, 262144, 400000])
def test_every_legal_config_fits_shared_memory(v):
    """Every config of the space is planned to a cluster whose slice fits a
    block's shared memory; a row that fits no cluster (more than 230144
    logits, here 262144 and 400000) is refused for every config."""
    spec = port_registry.get("fused_sampling")
    logits = torch.zeros(2, v)
    fits = (port_kernel.sampling_smem_bytes(
        v, port_kernel.SAMPLE_MAX_CLUSTER) <= port_kernel.MAX_DYNAMIC_SMEM)
    assert fits == (v <= 230144)
    for cluster in spec.space["cluster"]:
        for threads in spec.space["threads"]:
            def resolve():
                return port_registry.resolve_config(
                    "fused_sampling", logits, *([torch.zeros(2)] * 5),
                    overrides={"cluster": cluster, "threads": threads},
                    tune=False)

            if not fits:
                with pytest.raises(ValueError, match="shared memory"):
                    resolve()
                continue
            cfg = resolve()
            assert cfg["cluster"] in port_kernel.CLUSTER_SIZES
            assert cfg["cluster"] <= max(cluster, 1) or (
                port_kernel.sampling_smem_bytes(v, cluster)
                > port_kernel.MAX_DYNAMIC_SMEM)
            assert (port_kernel.sampling_smem_bytes(v, cfg["cluster"])
                    <= port_kernel.MAX_DYNAMIC_SMEM)
            slice_ = port_kernel.sampling_slice(v, cfg["cluster"])
            assert slice_ % 4 == 0 and cfg["cluster"] * slice_ >= v


@pytest.mark.parametrize("v,want", [(64, 1), (33, 1), (50, 1), (8192, 4),
                                    (128256, 8), (151936, 8), (230144, 8)])
def test_default_cluster(v, want):
    """Small rows (the CPU cases) run on one block; a llama or qwen
    vocabulary, and the longest row the kernel takes, on the default 8."""
    logits = torch.zeros(2, v)
    cfg = port_registry.default_config("fused_sampling", logits,
                                       *([torch.zeros(2)] * 5))
    assert cfg == {"cluster": want, "threads": 512}


def test_a_row_too_long_for_any_cluster_is_refused():
    """A row that fits no cluster of the portable 8 blocks is refused by
    the planner and by the wrapper's checks, with the same message."""
    v = 230145
    assert (port_kernel.sampling_smem_bytes(v, 8)
            > port_kernel.MAX_DYNAMIC_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        port_kernel.plan_cluster(v, 8, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        port_kernel._check_cuda(torch.zeros(1, v), tuple(
            torch.zeros(1, dtype=dt) for _, dt in port_kernel._ROWS), 8,
            1024)
    with pytest.raises(ValueError, match="cluster must be one of"):
        port_kernel._check_cuda(torch.zeros(1, 64), tuple(
            torch.zeros(1, dtype=dt) for _, dt in port_kernel._ROWS), 16,
            512)
