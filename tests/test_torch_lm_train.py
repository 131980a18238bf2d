"""Port parity for the LM training surface on the CPU: the token stream,
``lm.loss_fn`` and its gradients for every assigned LM architecture, the
chunked cross-entropy, remat, the ``Trainer`` on an LM, the parameter specs
and the launcher.

Inputs are drawn with numpy from a seed and handed to both packages; the
parameters are the reference's, converted leaf by leaf.  Tolerances:

* token batches: bit-equal;
* loss: within 1e-5 relative (float32 compute, ``reduced()`` configs);
* gradients: every leaf within 1e-4 * max(1, max |reference leaf|) in max
  |difference| (``value_and_grad`` of the reference against autograd of
  the port), compared by path;
* chunked against unchunked cross-entropy, remat on against off: the same
  arithmetic in the same order on the CPU, so equal (the chunked sum adds
  chunk totals, so it is held to 1e-6 relative of the one-pass mean);
* three ``Trainer`` steps on both packages: every parameter within 1e-5 of
  the reference's (AdamW divides by the root of the second moment, which
  magnifies the gradients' float32 rounding in leaves whose gradients are
  tiny).
"""

import dataclasses
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data import tokens as ref_tokens
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import lm as ref_lm
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.training import Trainer as RefTrainer
from repro.training import TrainerConfig as RefTrainerConfig
from repro_torch import configs as port_configs
from repro_torch import convert
from repro_torch.data import tokens as port_tokens
from repro_torch.launch import train as port_train
from repro_torch.models import attention as port_attention
from repro_torch.models import common as port_common
from repro_torch.models import lm as port_lm
from repro_torch.models.common import LeafSpec, LMConfig, tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.training import Trainer, TrainerConfig

torch.set_num_threads(1)

LM_ARCHS = [a for a in ref_configs.list_archs() if not a.startswith("capsnet")]
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(
                ref_configs.reduced(ref_configs.get_config(arch)), **kw),
            dataclasses.replace(
                port_configs.reduced(port_configs.get_config(arch)), **kw))


def _batch(cfg, seed=1, b=B, s=S):
    """Labels and the family's inputs: tokens, audio features, or tokens
    plus vlm image features."""
    rng = np.random.RandomState(seed)
    batch = {"labels": rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["features"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.family == "vlm":
        batch["image_features"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _walk(tree, path=()):
    """``(path, leaf)`` pairs of a tree of dicts and lists (a tuple is a
    leaf: the reference's axes)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _walk(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _walk(v, path + (i,))]
    return [(path, tree)]


def _paths(tree):
    """{path: numpy array} of a tree of either package."""
    return {p: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for p, v in _walk(tree)}


def _port_grads(pp, pcfg, batch):
    leaves = [t.requires_grad_(True) for t in tree_leaves(pp)]
    loss, metrics = port_lm.loss_fn(pp, pcfg, _t(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss, metrics, port_common.tree_unflatten(pp, grads)


_RUNS = {}


def _run(arch):
    """Loss, metrics and gradients of both packages on one batch; cached
    per module (each arch's reference step is a compile)."""
    if arch not in _RUNS:
        jcfg, pcfg = _cfgs(arch)
        jp = ref_lm.init(jcfg, jax.random.key(0))
        batch = _batch(jcfg)
        (jl, jm), jg = jax.value_and_grad(
            lambda p: ref_lm.loss_fn(p, jcfg, _j(batch)), has_aux=True)(jp)
        pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
        pl, pm, pg = _port_grads(pp, pcfg, batch)
        _RUNS[arch] = dict(jl=float(jl), jm={k: float(v) for k, v in
                                             jm.items()},
                           jg=_paths(jg), pl=float(pl.detach()),
                           pm={k: float(v.detach()) for k, v in pm.items()},
                           pg=_paths(pg))
    return _RUNS[arch]


# ---------------------------------------------------------------------------
# The token stream
# ---------------------------------------------------------------------------


class TestTokenStream:
    @pytest.mark.parametrize("vocab,seed", [(1024, 0), (128256, 0), (64, 5)])
    def test_batches_bit_equal_reference(self, vocab, seed):
        ref = ref_tokens.TokenStream(ref_tokens.TokenStreamConfig(
            vocab=vocab, seed=seed))
        port = port_tokens.TokenStream(port_tokens.TokenStreamConfig(
            vocab=vocab, seed=seed))
        np.testing.assert_array_equal(port.successors, ref.successors)
        for a, b in zip(ref.batches(3, 40, 4, seed=7),
                        port.batches(3, 40, 4, seed=7)):
            assert sorted(a) == sorted(b) == ["labels", "tokens"]
            for k in a:
                assert b[k].dtype == a[k].dtype == np.int32
                np.testing.assert_array_equal(b[k], a[k])
        np.testing.assert_array_equal(port.sample(2, 9, seed=11)["labels"],
                                      ref.sample(2, 9, seed=11)["labels"])

    def test_labels_are_the_next_tokens(self):
        b = port_tokens.TokenStream(port_tokens.TokenStreamConfig()).sample(
            4, 32, seed=0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# loss_fn and its gradients, every assigned LM architecture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
class TestLossAndGrads:
    def test_loss_matches_reference(self, arch):
        r = _run(arch)
        assert np.isfinite(r["pl"])
        assert abs(r["pl"] - r["jl"]) <= LOSS_RTOL * abs(r["jl"])

    def test_metrics_match_reference(self, arch):
        """``{"loss", "ce", "aux"}``; the moe aux is positive, the others'
        is 0, and loss = ce + AUX_LOSS_COEF * aux."""
        r = _run(arch)
        assert sorted(r["pm"]) == sorted(r["jm"]) == ["aux", "ce", "loss"]
        for k, v in r["jm"].items():
            assert abs(r["pm"][k] - v) <= LOSS_RTOL * max(1.0, abs(v)), k
        assert (r["pm"]["aux"] > 0) == (_cfgs(arch)[1].moe is not None)
        assert port_lm.AUX_LOSS_COEF == ref_lm.AUX_LOSS_COEF
        assert abs(r["pm"]["loss"] - r["pm"]["ce"]
                   - port_lm.AUX_LOSS_COEF * r["pm"]["aux"]) < 1e-5

    def test_gradients_match_reference(self, arch):
        r = _run(arch)
        assert sorted(r["pg"]) == sorted(r["jg"])
        for path, want in r["jg"].items():
            got = r["pg"][path]
            assert got.shape == want.shape, path
            assert np.isfinite(got).all(), path
            err = np.abs(got - want).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(want).max()), (path, err)


def test_recurrent_gradients_have_no_nan_across_chunks():
    """xlstm and zamba2 at a length of several scan chunks (the carry and
    the -1e30 / -inf stabiliser starts on every path), and an odd length
    (chunk 1): finite gradients, equal to the reference's."""
    for arch in ("xlstm-1.3b", "zamba2-1.2b"):
        for s in (24, 13):
            jcfg, pcfg = _cfgs(arch)
            jp = ref_lm.init(jcfg, jax.random.key(2))
            batch = _batch(jcfg, seed=4, s=s)
            _, jg = jax.value_and_grad(
                lambda p: ref_lm.loss_fn(p, jcfg, _j(batch)),
                has_aux=True)(jp)
            pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
            _, _, pg = _port_grads(pp, pcfg, batch)
            want, got = _paths(jg), _paths(pg)
            for path, w in want.items():
                assert np.isfinite(got[path]).all(), (arch, s, path)
                assert np.abs(got[path] - w).max() <= GRAD_TOL * max(
                    1.0, np.abs(w).max()), (arch, s, path)


# ---------------------------------------------------------------------------
# Chunked cross-entropy and remat
# ---------------------------------------------------------------------------


def _tiny(**kw):
    base = dict(arch_id="t", family="dense", n_layers=2, d_model=16,
                n_heads=2, n_kv_heads=1, d_ff=32, vocab=64,
                compute_dtype="float32")
    base.update(kw)
    return LMConfig(**base)


def _tiny_params(cfg, seed=0):
    return port_lm.init(cfg, torch.Generator().manual_seed(seed), "cpu")


class TestChunkedCE:
    @pytest.mark.parametrize("s,n_chunks", [(2048, 2), (3100, 2), (1000, 1),
                                            (96, 1)])
    def test_chunk_rule_and_unchunked_equal(self, s, n_chunks):
        """S 2048: two chunks of 1024; S 3100: three do not divide, so two;
        under 1024: one.  Each equals the one-pass mean cross-entropy."""
        cfg = _tiny()
        pp = _tiny_params(cfg)
        rng = np.random.RandomState(s)
        x = torch.from_numpy(rng.standard_normal((1, s, 16)).astype(
            np.float32))
        labels = torch.from_numpy(rng.randint(0, 64, (1, s)).astype(np.int32))
        seen = []
        unembed = port_common.unembed

        def spy(params, c, xk):
            seen.append(xk.shape[1])
            return unembed(params, c, xk)

        port_lm.common.unembed = spy
        try:
            got = port_lm.chunked_ce_loss(pp, cfg, x, labels)
        finally:
            port_lm.common.unembed = unembed
        assert seen == [s // n_chunks] * n_chunks
        logits = unembed(pp["embed"], cfg, x)
        want = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 64), labels.reshape(-1).long())
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))

    @pytest.mark.parametrize("s,n_chunks", [(3100, 0), (60, 4), (60, 7)])
    def test_matches_reference(self, s, n_chunks):
        """The rule (``n_chunks`` 0: S // 1024, decremented; 7 does not
        divide 60, so 6) and the value, against the reference's."""
        jcfg = ref_common.LMConfig(**dataclasses.asdict(_tiny()))
        jp = ref_lm.init(jcfg, jax.random.key(1))
        pp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
        rng = np.random.RandomState(7)
        x = rng.standard_normal((2, s, 16)).astype(np.float32)
        labels = rng.randint(0, 64, (2, s)).astype(np.int32)
        want = float(ref_lm.chunked_ce_loss(jp, jcfg, jnp.asarray(x),
                                            jnp.asarray(labels), n_chunks))
        got = float(port_lm.chunked_ce_loss(pp, _tiny(), torch.from_numpy(x),
                                            torch.from_numpy(labels),
                                            n_chunks))
        assert abs(got - want) <= LOSS_RTOL * abs(want)


def _grads(cfg, pp, batch):
    return _port_grads(pp, cfg, batch)[2]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "llama-3.2-vision-90b", "xlstm-1.3b",
                                  "zamba2-1.2b", "hubert-xlarge"])
def test_remat_changes_no_gradient(arch):
    """remat and loss_remat on (each unit, each CE chunk recomputed in the
    backward) and off give the same gradients; so does a remat group of
    two units."""
    _, pcfg = _cfgs(arch)
    pp = port_lm.init(pcfg, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(pcfg)
    off = _grads(dataclasses.replace(pcfg, remat=False, loss_remat=False),
                 pp, batch)
    for kw in (dict(remat=True, loss_remat=True),
               dict(remat=True, remat_group=2, loss_remat=False)):
        on = _grads(dataclasses.replace(pcfg, **kw), pp, batch)
        for a, b in zip(tree_leaves(off), tree_leaves(on)):
            assert torch.equal(a, b), kw


def test_remat_recomputes_units_in_the_backward():
    """With remat the backward runs each unit's forward again (the reference's
    jax.checkpoint); without it, once; serving with caches, never."""
    cfg = _tiny(remat=True)
    pp = _tiny_params(cfg)
    batch = _batch(cfg)
    calls = []
    inner = port_lm._apply_self_block

    def spy(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    port_lm._apply_self_block = spy
    try:
        _port_grads(pp, cfg, batch)
        with_remat = len(calls)
        calls.clear()
        _port_grads(pp, dataclasses.replace(cfg, remat=False), batch)
        without = len(calls)
    finally:
        port_lm._apply_self_block = inner
    assert (with_remat, without) == (2 * cfg.n_layers, cfg.n_layers)


# ---------------------------------------------------------------------------
# The Trainer on an LM
# ---------------------------------------------------------------------------


def test_trainer_three_steps_track_reference():
    """Three Trainer steps of reduced llama3.2-1b in both packages, from the
    reference's initial parameters and the same token batches."""
    jcfg, pcfg = _cfgs("llama3.2-1b")
    stream = ref_tokens.TokenStream(ref_tokens.TokenStreamConfig(
        vocab=jcfg.vocab))
    jp0 = ref_lm.init(jcfg, jax.random.key(0))
    np0 = jax.tree.map(np.asarray, jp0)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    ref = RefTrainer(RefTrainerConfig(optim=RefAdamWConfig(**ocfg),
                                      log_every=1),
                     lambda p, b: ref_lm.loss_fn(p, jcfg, b),
                     lambda k: jp0).run(stream.batches(4, 16, 3, seed=2), 3)
    port = Trainer(TrainerConfig(optim=AdamWConfig(**ocfg), log_every=1),
                   lambda p, b: port_lm.loss_fn(p, pcfg, b),
                   lambda g: convert.params_from_numpy(np0), device="cpu"
                   ).run(port_tokens.TokenStream(port_tokens.TokenStreamConfig(
                       vocab=pcfg.vocab)).batches(4, 16, 3, seed=2), 3)
    assert port.step == ref.step == 3
    for hj, hp in zip(ref.history, port.history):
        assert abs(hp["loss"] - hj["loss"]) <= LOSS_RTOL * abs(hj["loss"])
    want, got = _paths(ref.params), _paths(port.params)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, atol=1e-5, err_msg=path)
    assert not np.array_equal(got[("embed", "tok")],
                              np0["embed"]["tok"])


# ---------------------------------------------------------------------------
# Specs, structs, FLOPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_specs_and_structs_match_reference_at_full_size(arch):
    """Every leaf's shape and type equal the reference's ``param_structs``
    (``eval_shape`` of its init) and its axes the reference's ``specs``,
    at the published size; nothing is allocated (the trees hold
    ``LeafSpec``s only)."""
    jcfg = ref_configs.get_config(arch)
    pcfg = port_configs.get_config(arch)
    want_structs = [(p, (tuple(s.shape), str(s.dtype)))
                    for p, s in _walk(ref_lm.param_structs(jcfg))]
    want_axes = dict(_walk(ref_lm.specs(jcfg)))
    for fn in (port_lm.specs, port_lm.param_structs):
        got = dict(_walk(fn(pcfg)))
        assert sorted(got) == sorted(dict(want_structs))
        for path, (shape, dtype) in want_structs:
            leaf = got[path]
            assert isinstance(leaf, LeafSpec), path
            assert leaf.shape == shape, path
            assert str(leaf.dtype) == f"torch.{dtype}", path
            assert leaf.axes == tuple(want_axes[path]), path
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(port_lm.specs(pcfg)))
    assert n * 4 == port_lm.param_bytes(pcfg)


def test_stack_specs_matches_reference():
    cfg = port_configs.reduced(port_configs.get_config("xlstm-1.3b"))
    unit = port_common.param_specs(port_lm.unit_defs(cfg), torch.float32)
    stacked = port_common.stack_specs(unit, 5)
    want = ref_common.stack_specs(ref_common.param_specs(
        ref_lm.unit_defs(ref_configs.reduced(
            ref_configs.get_config("xlstm-1.3b")))))
    want = dict(_walk(want))
    got = dict(_walk(stacked))
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        assert leaf.axes == tuple(want[path])
        assert leaf.shape[0] == 5
        assert leaf.shape[1:] == dict(_walk(unit))[path].shape
    assert isinstance(stacked["mlstm"], list)


def test_kv_cache_specs_match_reference():
    for stacked in (True, False):
        assert (port_attention.kv_cache_specs(stacked)
                == ref_attention.kv_cache_specs(stacked))


def test_model_flops_per_token_matches_reference():
    cfg = port_configs.get_config("llama3.2-1b")
    jcfg = ref_configs.get_config("llama3.2-1b")
    for n, act in ((1_235_814_400, None), (16_000_000_000, 2_800_000_000)):
        assert (port_lm.model_flops_per_token(cfg, n, act)
                == ref_lm.model_flops_per_token(jcfg, n, act))
    assert port_lm.model_flops_per_token(cfg, 10) == 60.0


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b"])
def test_launcher_trains_an_lm_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_train.main(["--arch", arch, "--reduced", "--steps", "3",
                         "--seq", "16", "--batch", "2", "--log-every", "1",
                         "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"[{arch}] 3 steps in ")
    assert "steps/s) on cpu" in lines[0]
    losses = [float(line.split("'loss': ")[1].split(",")[0])
              for line in lines[1:]]
    assert len(losses) == 3 and all(np.isfinite(losses))
