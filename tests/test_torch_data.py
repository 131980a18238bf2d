"""Port parity: ``repro_torch.data.synthetic_digits`` against
``repro.data.synthetic_digits`` — the same config gives bit-identical
arrays and the same batch order, in both variants."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.data import synthetic_digits as ref_sd
from repro_torch.data import synthetic_digits as port_sd

torch.set_num_threads(1)

VARIANTS = ("digits", "fashion")


def _both(variant, **kw):
    kw = dict(dict(n_train=48, n_test=16, seed=3), **kw)
    return (ref_sd.load(ref_sd.DigitsConfig(variant=variant, **kw)),
            port_sd.load(port_sd.DigitsConfig(variant=variant, **kw)))


def test_config_fields_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(port_sd.DigitsConfig)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(ref_sd.DigitsConfig)}
    assert ours == theirs


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("split", ("train", "test"))
def test_arrays_bit_identical(variant, split):
    ref, port = _both(variant)
    (rx, ry), (px, py) = ref[split], port[split]
    assert px.dtype == rx.dtype == np.float32
    assert py.dtype == ry.dtype == np.int32
    assert px.shape == rx.shape
    np.testing.assert_array_equal(px, rx)
    np.testing.assert_array_equal(py, ry)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kw", [dict(noise=0.0), dict(sigma=0.08, seed=11)])
def test_arrays_bit_identical_other_settings(variant, kw):
    ref, port = _both(variant, n_train=12, n_test=4, **kw)
    for split in ("train", "test"):
        np.testing.assert_array_equal(port[split][0], ref[split][0])
        np.testing.assert_array_equal(port[split][1], ref[split][1])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("batch,epochs,seed", [(8, 1, 0), (5, 3, 7),
                                               (48, 2, 1)])
def test_batch_order_identical(variant, batch, epochs, seed):
    ref, _ = _both(variant)
    x, y = ref["train"]
    a = list(ref_sd.batches(x, y, batch, seed, epochs=epochs))
    b = list(port_sd.batches(x, y, batch, seed, epochs=epochs))
    assert len(a) == len(b) == epochs * (len(x) // batch)
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(bx, ax)
        np.testing.assert_array_equal(by, ay)


@pytest.mark.parametrize("variant", VARIANTS)
def test_images_in_unit_range_and_labels_cover_classes(variant):
    _, port = _both(variant, n_train=200)
    x, y = port["train"]
    assert x.shape == (200, port_sd.HW, port_sd.HW, 1)
    assert 0.0 <= x.min() and x.max() <= 1.0
    assert set(np.unique(y)) == set(range(10))
