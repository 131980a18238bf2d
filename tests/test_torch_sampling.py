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
        with pytest.raises(ValueError, match="unsupported device"):
            port_kernel.fused_sampling_cuda(
                torch.zeros(2, 8, device="meta"), *self._rows(2, "meta"))
        with pytest.raises(ValueError, match="on meta"):
            port_kernel.fused_sampling_cuda(torch.zeros(2, 8),
                                            *self._rows(2, "meta"))
