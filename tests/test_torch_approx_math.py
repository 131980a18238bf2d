"""Port parity: ``repro_torch.core.approx_math`` against
``repro.core.approx_math`` on the same numpy inputs (CPU, float32)."""

import numpy as np
import pytest
import torch

from repro.core import approx_math as ref
from repro_torch.core import approx_math as port
from torch_testlib import f32, rand, to_jax, to_torch

torch.set_num_threads(1)

# One elementwise float32 formula evaluated by two frameworks: the results
# differ by rounding only (fused multiply-adds on one side), so 1e-6 absolute
# on values of order one.
ATOL = 1e-6


def test_constants_are_the_papers():
    assert port.TAYLOR_COEFFS == ref.TAYLOR_COEFFS
    assert port.E_A == ref.E_A
    assert port.TAYLOR_A == ref.TAYLOR_A


@pytest.mark.parametrize("seed,scale", [(0, 0.5), (1, 1.0), (2, 1.5)])
def test_taylor_exp_raw(seed, scale):
    x = rand(seed, (64, 33), scale)
    np.testing.assert_allclose(f32(port.taylor_exp_raw(to_torch(x))),
                               f32(ref.taylor_exp_raw(to_jax(x))),
                               rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 5.0), (2, 20.0),
                                        (3, 100.0)])
def test_taylor_exp_range_reduced(seed, scale):
    # inputs <= 0, as after the row maximum was subtracted; beyond -32 the
    # clip takes over
    x = -np.abs(rand(seed, (32, 50), scale))
    got = f32(port.taylor_exp(to_torch(x), range_reduce=True))
    want = f32(ref.taylor_exp(to_jax(x), range_reduce=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
    assert np.isfinite(got).all() and (got >= 0).all()


def test_taylor_exp_default_is_raw():
    x = rand(4, (16,), 0.5)
    np.testing.assert_array_equal(f32(port.taylor_exp(to_torch(x))),
                                  f32(port.taylor_exp_raw(to_torch(x))))


def test_taylor_exp_tracks_exp_on_routing_range():
    x = np.linspace(-8.0, 0.0, 200).astype(np.float32)
    got = f32(port.taylor_exp(to_torch(x), range_reduce=True))
    np.testing.assert_allclose(got, np.exp(x), rtol=2e-2, atol=1e-4)


@pytest.mark.parametrize("shape,axis", [((8, 16), -1), ((4, 7, 10), -1),
                                        ((5, 6, 7), 1), ((33, 250), -1)])
def test_taylor_softmax(shape, axis):
    x = rand(5, shape, 5.0)
    got = f32(port.taylor_softmax(to_torch(x), axis=axis))
    want = f32(ref.taylor_softmax(to_jax(x), axis=axis))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got.sum(axis=axis), 1.0, atol=1e-5)


def test_taylor_softmax_div_exp_log():
    x = rand(6, (12, 10), 2.0)
    got = f32(port.taylor_softmax(to_torch(x), use_div_exp_log=True))
    want = f32(ref.taylor_softmax(to_jax(x), use_div_exp_log=True))
    # exp(log a - log b): two transcendental calls per element on each side
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_div_exp_log():
    a = np.abs(rand(7, (40,), 3.0)) + 0.1
    b = np.abs(rand(8, (40,), 3.0)) + 0.1
    np.testing.assert_allclose(
        f32(port.div_exp_log(to_torch(a), to_torch(b))),
        f32(ref.div_exp_log(to_jax(a), to_jax(b))), rtol=1e-5)


@pytest.mark.parametrize("fn", ["squash", "squash_fast"])
@pytest.mark.parametrize("shape,axis,scale", [((4, 10, 16), -1, 1.0),
                                              ((3, 252, 8), -1, 0.05),
                                              ((2, 8, 5), 1, 3.0)])
def test_squash(fn, shape, axis, scale):
    s = rand(9, shape, scale)
    got = f32(getattr(port, fn)(to_torch(s), axis=axis))
    want = f32(getattr(ref, fn)(to_jax(s), axis=axis))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("fn", ["squash", "squash_fast"])
def test_squash_of_zero_is_zero(fn):
    z = torch.zeros(2, 3, 4)
    out = getattr(port, fn)(z)
    assert torch.isfinite(out).all() and float(out.abs().max()) == 0.0


def test_squash_variants_agree():
    s = to_torch(rand(10, (6, 10, 16), 0.7))
    np.testing.assert_allclose(f32(port.squash(s)), f32(port.squash_fast(s)),
                               atol=1e-6)
