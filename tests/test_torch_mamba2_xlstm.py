"""Port parity for the recurrent blocks (``repro_torch.models.mamba2``,
``repro_torch.models.xlstm``) on the CPU.

The tiny configs are the reference's own (``tests/test_mamba2_xlstm.py``):
d_model 16, a Mamba-2 block of 2 x 8 channels and d_state 4, an xLSTM of 2
heads; chunk 8.  Parameters are the reference's, converted leaf by leaf;
inputs are numpy draws handed to both packages.  Each block runs at a prime
length (13: the chunk rule halves to 1, a chunk a position), at lengths
that the chunk divides (16, 32), from a fresh start and from a carried
state (the state a prefill of another input left, so the sLSTM's
normaliser n is the positive value a real state holds).

Tolerances, float32 throughout: block outputs and states within 1e-5 of
the reference (they agree to a few float32 ulp: both packages run the
same einsums in the same order of chunks); the port's chunked scan against
its own one-token steps within 1e-4 (a different order of the same sums
over up to 32 steps; the reference's own test allows 1e-3); gradients at
another chunk size against the reference's at 8 within GRAD_TOL * max(1,
max |reference gradient|), as ``test_torch_lm_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as ref_mamba
from repro.models import xlstm as ref_xlstm
from repro.models.common import LMConfig as RefLMConfig
from repro.models.common import SSMConfig as RefSSMConfig
from repro.models.common import XLSTMConfig as RefXLSTMConfig
from repro.models.common import init_params as ref_init_params
from repro_torch import convert
from repro_torch.models import mamba2 as port_mamba
from repro_torch.models import xlstm as port_xlstm
from repro_torch.models.common import (LMConfig, SSMConfig, XLSTMConfig,
                                       init_params)
from torch_testlib import f32

torch.set_num_threads(1)

LENGTHS = (13, 16, 32)
ATOL = 1e-5
STEP_ATOL = 1e-4
GRAD_TOL = 1e-4


def mamba_cfgs(chunk=8):
    kw = dict(arch_id="m", family="hybrid", n_layers=1, d_model=16,
              n_heads=2, n_kv_heads=2, d_ff=32, vocab=32,
              compute_dtype="float32", param_dtype="float32")
    ssm = dict(d_state=4, d_conv=4, expand=2, head_dim=8, n_groups=1,
               chunk_size=chunk)
    return (RefLMConfig(**kw, ssm=RefSSMConfig(**ssm)),
            LMConfig(**kw, ssm=SSMConfig(**ssm)))


def xlstm_cfgs(chunk=8):
    kw = dict(arch_id="x", family="ssm", n_layers=2, d_model=16, n_heads=2,
              n_kv_heads=2, d_ff=0, vocab=32, compute_dtype="float32",
              param_dtype="float32")
    xl = dict(slstm_every=2, chunk_size=chunk)
    return (RefLMConfig(**kw, xlstm=RefXLSTMConfig(**xl)),
            LMConfig(**kw, xlstm=XLSTMConfig(**xl)))


# block name -> (configs, reference module, port module, state-shape fn)
BLOCKS = {
    "mamba2": (mamba_cfgs, ref_mamba, port_mamba, "mamba2"),
    "mlstm": (xlstm_cfgs, ref_xlstm, port_xlstm, "mlstm"),
    "slstm": (xlstm_cfgs, ref_xlstm, port_xlstm, "slstm"),
}


def _block(name, chunk=8):
    cfgs, ref_mod, port_mod, prefix = BLOCKS[name]
    rcfg, pcfg = cfgs(chunk)
    rp = ref_init_params(getattr(ref_mod, f"{prefix}_defs")(rcfg),
                         jax.random.key(0), jnp.float32)
    pp = convert.params_from_numpy(jax.tree.map(np.asarray, rp))
    return (rcfg, pcfg, rp, pp, getattr(ref_mod, f"{prefix}_apply"),
            getattr(port_mod, f"{prefix}_apply"),
            getattr(ref_mod, f"{prefix}_state_defs"))


def _x(seed, s, b=2):
    return np.random.RandomState(seed).standard_normal((b, s, 16)).astype(
        np.float32)


def _zero_state(state_defs, cfg, b=2):
    return {k: np.zeros(sd.shape, np.float32)
            for k, sd in state_defs(cfg, b).items()}


def _carried_state(name, s=9):
    """The state the reference's prefill of another draw leaves."""
    rcfg, _, rp, _, rapply, _, sdefs = _block(name)
    _, st = rapply(rp, rcfg, jnp.asarray(_x(7, s)),
                   {k: jnp.asarray(v)
                    for k, v in _zero_state(sdefs, rcfg).items()})
    return {k: np.asarray(v) for k, v in st.items()}


def _both(name, x, state=None, chunk=8):
    rcfg, pcfg, rp, pp, rapply, papply, _ = _block(name, chunk)
    rs = None if state is None else {k: jnp.asarray(v)
                                     for k, v in state.items()}
    ps = None if state is None else {k: torch.from_numpy(v.copy())
                                     for k, v in state.items()}
    yr, str_ = rapply(rp, rcfg, jnp.asarray(x), rs)
    yp, stp = papply(pp, pcfg, torch.from_numpy(x), ps)
    return (yr, str_), (yp, stp)


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("start", ["fresh", "zero_state", "carried_state"])
def test_block_matches_reference(name, s, start):
    rcfg, _, _, _, _, _, sdefs = _block(name)
    state = {"fresh": None, "zero_state": _zero_state(sdefs, rcfg),
             "carried_state": None}[start]
    if start == "carried_state":
        state = _carried_state(name)
    (yr, sr), (yp, sp) = _both(name, _x(s, s), state)
    np.testing.assert_allclose(f32(yp), f32(yr), atol=ATOL, rtol=ATOL)
    if state is None:
        assert sr is None and sp is None
        return
    assert sorted(sp) == sorted(sr)
    for k in sr:
        assert sp[k].dtype == torch.float32, k
        np.testing.assert_allclose(f32(sp[k]), f32(sr[k]), atol=ATOL,
                                   rtol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["mamba2", "mlstm"])
@pytest.mark.parametrize("chunk", [1, 4, 32])
def test_chunk_size_does_not_change_the_output(name, chunk):
    """The chunk only orders the sums (the reference's invariance test,
    held to the reference's chunk-8 output)."""
    x = _x(3, 32)
    (want, _), _ = _both(name, x, chunk=8)
    _, (got, _) = _both(name, x, chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), atol=STEP_ATOL,
                               rtol=STEP_ATOL)


@pytest.mark.parametrize("name", ["mamba2", "mlstm"])
@pytest.mark.parametrize("chunk", [1, 4, 32])
def test_chunk_size_does_not_change_the_gradient(name, chunk):
    """The gradient twin of the test above: loss = <output, a fixed random
    projection>; the port's gradients of every parameter and of the input
    at ``chunk`` against ``jax.grad`` of the reference's at chunk 8, within
    GRAD_TOL * max(1, max |reference gradient|) (as
    ``test_torch_lm_train.py``)."""
    x = _x(3, 32)
    proj = _x(4, 32)
    rcfg, _, rp, _, rapply, _, _ = _block(name, 8)
    _, pcfg, _, pp, _, papply, _ = _block(name, chunk)

    def ref_loss(p, xj):
        y, _ = rapply(p, rcfg, xj, None)
        return jnp.sum(y * jnp.asarray(proj))

    want_p, want_x = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = {k: v.requires_grad_(True) for k, v in pp.items()}
    y, _ = papply(leaves, pcfg, xt, None)
    loss = (y * torch.from_numpy(proj)).sum()
    grads = torch.autograd.grad(loss, [xt, *leaves.values()])
    got = {"x": grads[0], **dict(zip(leaves, grads[1:]))}
    want = {"x": want_x, **want_p}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert np.abs(w).max() > 0, k
        err = np.abs(f32(got[k]) - w).max()
        assert err <= GRAD_TOL * max(1.0, np.abs(w).max()), (k, err)


@pytest.mark.parametrize("name", sorted(BLOCKS))
@pytest.mark.parametrize("s", [13, 16])
def test_chunked_equals_stepwise(name, s):
    """The prefill's chunked scan against the decode's one-token steps,
    both in the port, from the same carried state: outputs and final
    states agree."""
    _, pcfg, _, pp, _, papply, _ = _block(name)
    state = _carried_state(name)
    x = torch.from_numpy(_x(5, s))
    y_full, st_full = papply(pp, pcfg, x, {k: torch.from_numpy(v.copy())
                                           for k, v in state.items()})
    st = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ys = []
    for t in range(s):
        y_t, st = papply(pp, pcfg, x[:, t:t + 1], st)
        ys.append(y_t)
    np.testing.assert_allclose(f32(torch.cat(ys, dim=1)), f32(y_full),
                               atol=STEP_ATOL, rtol=STEP_ATOL)
    for k in st:
        np.testing.assert_allclose(f32(st[k]), f32(st_full[k]),
                                   atol=STEP_ATOL, rtol=STEP_ATOL,
                                   err_msg=k)


def test_mlstm_step_matches_reference():
    """The one-token decode cell itself, on a carried state."""
    rng = np.random.RandomState(11)
    b, h, dk = 2, 2, 16
    q, k, v = (rng.standard_normal((b, h, dk)).astype(np.float32)
               for _ in range(3))
    logi = rng.standard_normal((b, h)).astype(np.float32)
    logf = -np.abs(rng.standard_normal((b, h))).astype(np.float32)
    st = _carried_state("mlstm")
    carry = (st["c"], st["n"], st["m"])
    hr, cr = ref_xlstm._mlstm_step(*map(jnp.asarray, (q, k, v, logi, logf)),
                                   tuple(map(jnp.asarray, carry)))
    hp, cp = port_xlstm._mlstm_step(
        *map(torch.from_numpy, (q, k, v, logi, logf)),
        tuple(torch.from_numpy(c.copy()) for c in carry))
    np.testing.assert_allclose(f32(hp), f32(hr), atol=ATOL, rtol=ATOL)
    for a, b_ in zip(cp, cr):
        np.testing.assert_allclose(f32(a), f32(b_), atol=ATOL, rtol=ATOL)


def test_empty_mlstm_rows_stay_finite():
    """A fresh carry starts at m = -inf; the chunk body clamps its maxima
    at -1e30, so a row whose every weight is -inf (an input gate of -inf
    under a forget gate of 1) gives zeros, not NaN, as the reference's
    does."""
    b, s, h, d = 1, 4, 2, 8
    z = np.zeros((b, s, h, d), np.float32)
    logi = np.full((b, s, h), -np.inf, np.float32)
    logf = np.zeros((b, s, h), np.float32)
    hr, _ = ref_xlstm._mlstm_chunked(*map(jnp.asarray, (z, z, z, logi, logf)),
                                     chunk=4)
    hp, (c, n, m) = port_xlstm._mlstm_chunked(
        *map(torch.from_numpy, (z, z, z, logi, logf)), chunk=4)
    assert np.isfinite(f32(hp)).all() and np.isfinite(f32(hr)).all()
    np.testing.assert_array_equal(f32(hp), f32(hr))
    assert float(m.min()) == float(np.float32(-1e30))


@pytest.mark.parametrize("chunk,s,want", [(256, 700, 4), (256, 653, 1),
                                          (256, 512, 256), (256, 16, 16),
                                          (8, 13, 1), (8, 24, 8)])
def test_chunk_rule_is_the_reference_one(chunk, s, want):
    """min(chunk, S), halved until it divides S: an odd S above the chunk
    scans one position a chunk."""
    assert port_mamba.chunk_len(chunk, s) == want


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_state_shapes_and_specs_match_reference(name):
    rcfg, pcfg, _, _, _, _, sdefs = _block(name)
    prefix = BLOCKS[name][3]
    mod = BLOCKS[name][2]
    ours = getattr(mod, f"{prefix}_state_shapes")(pcfg, 3)
    theirs = sdefs(rcfg, 3)
    assert sorted(ours) == sorted(theirs)
    for k, (shape, dtype) in ours.items():
        assert shape == tuple(theirs[k].shape) and dtype == torch.float32
        assert theirs[k].dtype == jnp.float32
    assert (getattr(mod, f"{prefix}_state_specs")()
            == getattr(BLOCKS[name][1], f"{prefix}_state_specs")())


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_defs_match_reference(name):
    """Leaf names, shapes and logical axes of the block's parameters."""
    rcfg, pcfg = BLOCKS[name][0]()
    prefix = BLOCKS[name][3]
    ours = getattr(BLOCKS[name][2], f"{prefix}_defs")(pcfg)
    theirs = getattr(BLOCKS[name][1], f"{prefix}_defs")(rcfg)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].shape == theirs[k].shape, k
        assert ours[k].axes == theirs[k].axes, k


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_init_draws_the_reference_constants(name):
    """The leaves the reference initialises to constants (the Mamba-2
    decays log(1..16), the mLSTM gate biases -3 and 3..6, ones and zeros)
    are the port's too."""
    rcfg, pcfg = BLOCKS[name][0]()
    prefix = BLOCKS[name][3]
    ours = convert.params_to_numpy(init_params(
        getattr(BLOCKS[name][2], f"{prefix}_defs")(pcfg),
        torch.Generator().manual_seed(0), torch.float32))
    theirs = ref_init_params(getattr(BLOCKS[name][1], f"{prefix}_defs")(rcfg),
                             jax.random.key(0), jnp.float32)
    for k in ("a_log", "dt_bias", "d_skip", "norm_scale", "b_gates",
              "conv_b", "skip_scale"):
        if k in ours:
            np.testing.assert_allclose(ours[k], np.asarray(theirs[k]),
                                       atol=1e-6, err_msg=k)
