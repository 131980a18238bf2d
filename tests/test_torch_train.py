"""Port parity of the CapsNet training path: the loss half of
``core.capsnet`` (``margin_loss``, ``decode``, ``loss_fn`` and its
gradients), ``core.pruning.mask_gradients``, ``training.Trainer`` against
``repro`` on converted params and the same numpy batches; the kernel
wrappers' refusal of a gradient; ``DeployedCapsNet.save``; and the port's
counterpart of ``tests/test_system.py`` (the Fig. 6 pipeline, train ->
LAKP prune -> masked fine-tune -> compact -> deploy) at its sizes and bars,
with ``--device cpu`` runs of ``launch.train`` and the examples."""

import dataclasses
import json
import pathlib
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as ref_ck
from repro.core import capsnet as ref_cn
from repro.core import pruning as ref_pruning
from repro.deploy import FastCapsPipeline as RefPipeline
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.training import Trainer as RefTrainer
from repro.training import TrainerConfig as RefTrainerConfig
from repro_torch import convert
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.core import capsnet as cn
from repro_torch.core import pruning as pr
from repro_torch.data import synthetic_digits as sd
from repro_torch.deploy import FastCapsPipeline, RoutingSpec
from repro_torch.kernels.routing.routing_kernel import fused_routing_cuda
from repro_torch.kernels.softmax.kernel import taylor_softmax_cuda
from repro_torch.launch import train as port_train
from repro_torch.models.common import LeafSpec, tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.training import Trainer, TrainerConfig
from torch_testlib import f32, images, paired_params, small_cfgs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the loss and its parts: float32 convolutions and routing in two
# frameworks, sums in another order
LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    ref_cfg, port_cfg = small_cfgs(conv1_channels=16)
    ref_params, port_params = paired_params(ref_cfg, seed=0)
    return ref_cfg, port_cfg, ref_params, port_params


_JITTED = {}


def _ref_loss(cfg):
    """The reference's loss_fn, jitted once per config."""
    if ("loss", cfg) not in _JITTED:
        _JITTED["loss", cfg] = jax.jit(
            lambda p, x, y: ref_cn.loss_fn(p, cfg, x, y))
    return _JITTED["loss", cfg]


def _ref_grad(cfg):
    if ("grad", cfg) not in _JITTED:
        _JITTED["grad", cfg] = jax.jit(jax.grad(
            lambda p, x, y: ref_cn.loss_fn(p, cfg, x, y)[0]))
    return _JITTED["grad", cfg]


def _batch(seed, n, cfg):
    x = images(seed, n, cfg)
    y = np.random.RandomState(seed + 1).randint(0, 10, n).astype(np.int32)
    return x, y


def _tree_close(port_tree, ref_tree, atol, rtol=0.0, what=""):
    ref = jax.tree.map(np.asarray, ref_tree)
    for k in ref:
        for kk in ref[k]:
            np.testing.assert_allclose(f32(port_tree[k][kk]), ref[k][kk],
                                       atol=atol, rtol=rtol,
                                       err_msg=f"{what} {k}/{kk}")


# ---------------------------------------------------------------------------
# The loss half of core.capsnet
# ---------------------------------------------------------------------------


class TestLoss:
    @pytest.mark.parametrize("seed", (0, 1, 2))
    def test_margin_loss(self, model, seed):
        ref_cfg, port_cfg, _, _ = model
        rng = np.random.RandomState(seed)
        lengths = rng.rand(16, 10).astype(np.float32)
        labels = rng.randint(0, 10, 16).astype(np.int32)
        want = ref_cn.margin_loss(jnp.asarray(lengths), jnp.asarray(labels),
                                  ref_cfg)
        got = cn.margin_loss(torch.from_numpy(lengths),
                             torch.from_numpy(labels), port_cfg)
        assert abs(float(got) - float(want)) <= LOSS_TOL

    @pytest.mark.parametrize("seed", (0, 1))
    def test_decode(self, model, seed):
        ref_cfg, port_cfg, ref_p, port_p = model
        rng = np.random.RandomState(seed)
        v = (rng.standard_normal((6, 10, 16)) * 0.3).astype(np.float32)
        labels = rng.randint(0, 10, 6).astype(np.int32)
        want = ref_cn.decode(ref_p, ref_cfg, jnp.asarray(v),
                             jnp.asarray(labels))
        got = cn.decode(port_p, port_cfg, torch.from_numpy(v),
                        torch.from_numpy(labels))
        assert got.shape == (6, 784)
        np.testing.assert_allclose(f32(got), np.asarray(want), atol=LOSS_TOL,
                                   rtol=0)

    @pytest.mark.parametrize("seed", (0, 3))
    def test_loss_fn(self, model, seed):
        ref_cfg, port_cfg, ref_p, port_p = model
        x, y = _batch(seed, 6, ref_cfg)
        want_loss, want = _ref_loss(ref_cfg)(ref_p, jnp.asarray(x),
                                             jnp.asarray(y))
        got_loss, got = cn.loss_fn(port_p, port_cfg, torch.from_numpy(x),
                                   torch.from_numpy(y))
        assert set(got) == set(want) == {"loss", "margin", "recon", "acc"}
        assert float(got_loss) == float(got["loss"])
        for k in want:
            # recon is a sum over 784 pixels (about 100): relative there
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       atol=LOSS_TOL, rtol=LOSS_TOL,
                                       err_msg=k)

    @pytest.mark.parametrize("seed", (0, 4))
    def test_loss_fn_grads(self, model, seed):
        ref_cfg, port_cfg, ref_p, port_p = model
        x, y = _batch(seed, 6, ref_cfg)
        want = _ref_grad(ref_cfg)(ref_p, jnp.asarray(x), jnp.asarray(y))
        live = {k: {kk: v.clone().requires_grad_(True)
                    for kk, v in sub.items()} for k, sub in port_p.items()}
        loss, _ = cn.loss_fn(live, port_cfg, torch.from_numpy(x),
                             torch.from_numpy(y))
        loss.backward()
        got = {k: {kk: v.grad for kk, v in sub.items()}
               for k, sub in live.items()}
        _tree_close(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, what="grad")

    def test_specs_are_shapes_types_and_axes(self, model):
        _, port_cfg, _, port_p = model
        sp = cn.specs(port_cfg)
        defs = cn.capsnet_defs(port_cfg)
        for k in port_p:
            for kk, v in port_p[k].items():
                leaf = sp[k][kk]
                assert isinstance(leaf, LeafSpec)
                assert leaf.shape == tuple(v.shape)
                assert leaf.dtype == v.dtype == torch.float32
                assert leaf.axes == defs[k][kk].axes

    def test_specs_axes_equal_reference(self, model):
        ref_cfg, port_cfg, _, _ = model
        want = ref_cn.specs(ref_cfg)
        sp = cn.specs(port_cfg)
        for k in want:
            for kk in want[k]:
                assert sp[k][kk].axes == tuple(want[k][kk])


# ---------------------------------------------------------------------------
# The kernel wrappers refuse a gradient
# ---------------------------------------------------------------------------


class TestKernelsRefuseGrad:
    @pytest.mark.parametrize("spec", (RoutingSpec.cuda(),
                                      RoutingSpec.cuda(softmax="exact"),
                                      RoutingSpec.optimized()),
                             ids=("cuda-taylor", "cuda-exact", "optimized"))
    def test_loss_backward_raises(self, model, spec):
        """The fused routing kernel (``cuda``) refuses a gradient; the
        ``optimized`` spec, whose Eq. 2 softmax has a backward kernel,
        trains: every leaf gets a finite gradient (its agreement with the
        reference is ``test_torch_softmax_grad.py``'s)."""
        _, port_cfg, _, port_p = model
        cfg = dataclasses.replace(port_cfg, routing=spec)
        x, y = _batch(0, 4, cfg)
        live = {k: {kk: v.clone().requires_grad_(True)
                    for kk, v in sub.items()} for k, sub in port_p.items()}
        if spec.mode == "optimized":
            loss, _ = cn.loss_fn(live, cfg, torch.from_numpy(x),
                                 torch.from_numpy(y))
            loss.backward()
            for sub in live.values():
                for v in sub.values():
                    assert v.grad is not None
                    assert bool(torch.isfinite(v.grad).all())
            return
        with pytest.raises(RuntimeError, match=r"RoutingSpec\.reference\(\)"):
            loss, _ = cn.loss_fn(live, cfg, torch.from_numpy(x),
                                 torch.from_numpy(y))
            loss.backward()

    def test_trainer_through_cuda_raises(self, model):
        _, port_cfg, _, port_p = model
        cfg = dataclasses.replace(port_cfg, routing=RoutingSpec.cuda())
        x, y = _batch(1, 4, cfg)
        tr = Trainer(TrainerConfig(), lambda p, b: cn.loss_fn(
            p, cfg, b["images"], b["labels"]), lambda g: port_p,
            device="cpu")
        with pytest.raises(RuntimeError, match="no backward"):
            tr.run(iter([{"images": x, "labels": y}]), 1)

    def test_wrappers_refuse_a_tensor_that_needs_grad(self):
        """``fused_routing`` refuses a tensor that needs a gradient;
        ``taylor_softmax`` has a backward kernel and hands back an output
        the gradient passes through."""
        u = torch.randn(2, 6, 3, 4, requires_grad=True)
        with pytest.raises(RuntimeError, match="fused_routing"):
            fused_routing_cuda(u)
        b = torch.randn(5, 10, requires_grad=True)
        out = taylor_softmax_cuda(b)
        assert out.grad_fn is not None
        out[:, 0].sum().backward()
        assert b.grad is not None and bool(torch.isfinite(b.grad).all())

    def test_no_grad_forwards_unchanged(self):
        g = torch.Generator().manual_seed(3)
        u = torch.randn((2, 6, 3, 4), generator=g)
        b = torch.randn((5, 10), generator=g)
        want_v, want_c = fused_routing_cuda(u, softmax_mode="taylor")
        want_s = taylor_softmax_cuda(b)
        launches = (fused_routing_cuda.launches, taylor_softmax_cuda.launches)
        ug, bg = u.clone().requires_grad_(True), b.clone().requires_grad_(True)
        with torch.no_grad():
            v, c = fused_routing_cuda(ug, softmax_mode="taylor")
            s = taylor_softmax_cuda(bg)
        with torch.inference_mode():
            v2, _ = fused_routing_cuda(u, softmax_mode="taylor")
        for got, want in ((v, want_v), (c, want_c), (s, want_s),
                          (v2, want_v)):
            assert torch.equal(got, want)
        # a tensor that needs no gradient passes with autograd on
        assert torch.equal(taylor_softmax_cuda(b), want_s)
        # the plain versions ran: no kernel launch was counted
        assert (fused_routing_cuda.launches,
                taylor_softmax_cuda.launches) == launches

    def test_deployed_forward_under_cuda_still_serves(self, model):
        _, port_cfg, _, port_p = model
        pipe = FastCapsPipeline(port_cfg, params=port_p, device="cpu")
        x = torch.from_numpy(images(5, 4, port_cfg))
        ref = pipe.compile(routing="reference").forward(x)
        got = pipe.compile(routing="cuda").forward(x)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# mask_gradients and the Trainer
# ---------------------------------------------------------------------------


def _masks(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.rand(cfg.conv1_channels, 1) > 0.3).astype(np.float32),
            (rng.rand(cfg.primary_conv_channels, cfg.conv1_channels)
             > 0.5).astype(np.float32))


def test_mask_gradients_matches_reference(model):
    ref_cfg, port_cfg, ref_p, port_p = model
    m1, m2 = _masks(port_cfg)
    want = ref_pruning.mask_gradients(ref_p, (jnp.asarray(m1),
                                              jnp.asarray(m2)))
    got = pr.mask_gradients(port_p, (torch.from_numpy(m1),
                                     torch.from_numpy(m2)))
    _tree_close(got, want, atol=0)
    # a new tree: the gradients it was given are left as they were
    assert got["conv1"] is not port_p["conv1"]
    assert got["decoder"] is port_p["decoder"]


def _digit_batches(cfg, batch, seed, n_train=64, skip=0):
    data = sd.load(sd.DigitsConfig(n_train=n_train, n_test=8))
    x, y = data["train"]
    for i, (bx, by) in enumerate(sd.batches(x, y, batch, seed, epochs=50)):
        if i >= skip:
            yield {"images": bx, "labels": by}


@pytest.mark.parametrize("grad_accum", (1, 2))
def test_trainer_matches_reference(model, grad_accum):
    """Five steps from converted params on the same batches."""
    ref_cfg, port_cfg, ref_p, port_p = model
    kw = dict(lr=1e-3, weight_decay=0.0, warmup_steps=2, total_steps=5)

    def stacked(it):
        for b in it:
            if grad_accum == 1:
                yield b
            else:
                yield {k: v.reshape((grad_accum, -1) + v.shape[1:])
                       for k, v in b.items()}

    ref = RefTrainer(
        RefTrainerConfig(optim=RefAdamWConfig(**kw), grad_accum=grad_accum,
                         log_every=1),
        lambda p, b: ref_cn.loss_fn(p, ref_cfg, b["images"], b["labels"]),
        lambda k: ref_p).run(stacked(_digit_batches(ref_cfg, 8, 5)), 5)
    got = Trainer(
        TrainerConfig(optim=AdamWConfig(**kw), grad_accum=grad_accum,
                      log_every=1),
        lambda p, b: cn.loss_fn(p, port_cfg, b["images"], b["labels"]),
        lambda g: port_p, device="cpu").run(
            stacked(_digit_batches(port_cfg, 8, 5)), 5)
    assert got.step == ref.step == 5
    _tree_close(got.params, ref.params, atol=PARAM_TOL, what="params")
    assert len(got.history) == len(ref.history) == 5
    for a, b in zip(got.history, ref.history):
        assert set(a) == set(b)
        for k in ("loss", "margin", "lr", "acc"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


def test_trainer_keeps_callers_params(model):
    _, port_cfg, _, port_p = model
    before = [p.clone() for p in tree_leaves(port_p)]
    res = Trainer(TrainerConfig(optim=AdamWConfig(warmup_steps=1)),
                  lambda p, b: cn.loss_fn(p, port_cfg, b["images"],
                                          b["labels"]),
                  lambda g: port_p, device="cpu").run(
                      _digit_batches(port_cfg, 4, 1), 2)
    for a, b in zip(before, tree_leaves(port_p)):
        assert torch.equal(a, b)
    assert not torch.equal(res.params["conv1"]["w"], port_p["conv1"]["w"])


def test_trainer_donate_writes_in_place(model):
    _, port_cfg, _, port_p = model
    params = {k: {kk: v.clone() for kk, v in sub.items()}
              for k, sub in port_p.items()}
    keep = Trainer(TrainerConfig(optim=AdamWConfig(warmup_steps=1)),
                   lambda p, b: cn.loss_fn(p, port_cfg, b["images"],
                                           b["labels"]),
                   lambda g: port_p, device="cpu").run(
                       _digit_batches(port_cfg, 4, 1), 2)
    res = Trainer(TrainerConfig(optim=AdamWConfig(warmup_steps=1),
                                donate=True),
                  lambda p, b: cn.loss_fn(p, port_cfg, b["images"],
                                          b["labels"]),
                  lambda g: params, device="cpu").run(
                      _digit_batches(port_cfg, 4, 1), 2)
    assert res.params["conv1"]["w"] is params["conv1"]["w"]
    for a, b in zip(tree_leaves(res.params), tree_leaves(keep.params)):
        assert torch.equal(a, b)


def test_masked_finetune_keeps_kernels_at_zero(model):
    _, port_cfg, _, port_p = model
    pipe = FastCapsPipeline(port_cfg, params=port_p, device="cpu")
    pipe.prune(0.5, 0.7, type_keep=3)
    m1, m2 = pipe.masks

    def finetune(masked, masks):
        return Trainer(
            TrainerConfig(optim=AdamWConfig(lr=1e-2, warmup_steps=1,
                                            weight_decay=0.1)),
            lambda p, b: cn.loss_fn(p, port_cfg, b["images"], b["labels"]),
            lambda g: masked, mask_fn=lambda g: pr.mask_gradients(g, masks),
            device="cpu").run(_digit_batches(port_cfg, 8, 2), 4).params

    pipe.finetune(finetune)
    for name, m in (("conv1", m1), ("conv2", m2)):
        w = pipe.params[name]["w"]
        assert (w[m == 0] == 0).all(), name
        assert (w[m > 0].abs().sum(dim=(1, 2)) > 0).all(), name


def test_trainer_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainerConfig(), lambda p, b: None, lambda g: None)


# ---------------------------------------------------------------------------
# DeployedCapsNet.save
# ---------------------------------------------------------------------------


def test_deployed_save_matches_reference(model, tmp_path):
    """deploy.json has the reference's keys and values, and the params
    file of either package loads into the other's specs."""
    ref_cfg, port_cfg, ref_p, port_p = model
    ref_dep = RefPipeline(ref_cfg, params=ref_p).compile(routing="reference")
    ref_dep.save(str(tmp_path / "ref"))
    dep = FastCapsPipeline(port_cfg, params=port_p,
                           device="cpu").compile(routing="reference")
    dep.save(str(tmp_path / "port"))
    meta = json.load(open(tmp_path / "port" / "deploy.json"))
    ref_meta = json.load(open(tmp_path / "ref" / "deploy.json"))
    assert set(meta) == {"cfg", "routing", "n_params", "flops_per_image"}
    for k in ("cfg", "n_params", "flops_per_image"):
        assert meta[k] == ref_meta[k], k
    assert meta["cfg"]["routing"] is None
    assert meta["routing"] == {"mode": "reference", "softmax": "exact",
                               "div_exp_log": False}
    ref_loaded = ck.load(str(tmp_path / "ref"), 0, cn.specs(port_cfg),
                         device="cpu")
    _tree_close(ref_loaded, ref_p, atol=0)
    port_loaded = ref_ck.load(str(tmp_path / "port"), 0, ref_p)
    _tree_close(port_p, port_loaded, atol=0)


def test_deployed_save_reloads_and_classifies_identically(model, tmp_path):
    _, port_cfg, _, port_p = model
    pipe = FastCapsPipeline(port_cfg, params=port_p, device="cpu")
    pipe.prune(0.5, 0.7, type_keep=2).compact()
    dep = pipe.compile(routing="cuda")
    path = dep.save(str(tmp_path), step=3)
    assert path.endswith("step_000000000003")
    meta = json.load(open(tmp_path / "deploy.json"))
    assert meta["cfg"]["caps_types"] == 2
    assert meta["routing"]["mode"] == "cuda"
    assert meta["n_params"] == dep.n_params
    loaded = ck.load(str(tmp_path), 3, cn.specs(dep.cfg), device="cpu")
    again = FastCapsPipeline(dataclasses.replace(dep.cfg, routing=None),
                             params=loaded, device="cpu").compile("cuda")
    xt = torch.from_numpy(images(9, 16, port_cfg))
    assert torch.equal(again.classify(xt), dep.classify(xt))
    assert torch.equal(again.forward(xt), dep.forward(xt))


# ---------------------------------------------------------------------------
# The Fig. 6 pipeline end to end (the port's tests/test_system.py)
# ---------------------------------------------------------------------------


def test_fastcaps_pipeline_end_to_end():
    cfg = cn.CapsNetConfig(arch_id="capsnet-tiny", conv1_channels=16,
                           caps_types=8, decoder_hidden=(32, 64))
    data = sd.load(sd.DigitsConfig(n_train=256, n_test=128))
    tr_x, tr_y = data["train"]
    te_x, te_y = data["test"]

    def loss_fn(p, b):
        return cn.loss_fn(p, cfg, b["images"], b["labels"])

    def batches(seed=0):
        for bx, by in sd.batches(tr_x, tr_y, 32, seed, epochs=100):
            yield {"images": bx, "labels": by}

    tcfg = TrainerConfig(optim=AdamWConfig(lr=2e-3, weight_decay=0.0,
                                           warmup_steps=5, total_steps=60),
                         log_every=20)
    res = Trainer(tcfg, loss_fn, lambda g: cn.init(cfg, g),
                  device="cpu").run(batches(), 60)
    assert res.history[-1]["loss"] < res.history[0]["loss"]

    pipe = FastCapsPipeline(cfg, params=res.params, device="cpu")
    x = torch.from_numpy(te_x)
    dep_dense = pipe.compile(routing="reference")
    acc_dense = float((dep_dense.classify(x).numpy() == te_y).mean())
    assert acc_dense > 0.5, f"dense model failed to learn ({acc_dense})"

    def finetune(masked, masks):
        ft = Trainer(
            TrainerConfig(optim=AdamWConfig(lr=5e-4, weight_decay=0.0,
                                            warmup_steps=1, total_steps=30),
                          log_every=30),
            loss_fn, lambda g: masked,
            mask_fn=lambda g: pr.mask_gradients(g, masks), device="cpu")
        return ft.run(batches(seed=7), 30).params

    pipe.prune(0.5, 0.5, method="lakp", type_keep=4)
    pipe.finetune(finetune)
    pipe.compact()
    dep = pipe.compile(routing=RoutingSpec.cuda(softmax="taylor"))
    acc_pruned = float((dep.classify(x).numpy() == te_y).mean())
    n_dense = cn.param_count(res.params)

    assert dep.cfg.caps_types == 4
    assert dep.n_params < 0.6 * n_dense
    assert acc_pruned > acc_dense - 0.15, (acc_dense, acc_pruned)
    assert pipe.index_overhead_frac < 0.02


def test_pruned_model_output_consistency():
    """The cuda deployment (the kernel's plain version here) == reference
    routing on the compacted model."""
    cfg = cn.CapsNetConfig(arch_id="t", conv1_channels=16, caps_types=8,
                           decoder_hidden=(32, 64))
    pipe = FastCapsPipeline(cfg, device="cpu").build(seed=0)
    pipe.prune(0.6, 0.6, type_keep=4).compact()
    dep_ref = pipe.compile(routing="reference")
    dep_opt = pipe.compile(routing=RoutingSpec.cuda(softmax="taylor"))
    imgs = torch.rand((8, 28, 28, 1), generator=torch.Generator()
                      .manual_seed(1))
    l_ref, l_opt = dep_ref.forward(imgs), dep_opt.forward(imgs)
    assert torch.equal(l_ref.argmax(-1), l_opt.argmax(-1))
    np.testing.assert_allclose(l_ref.numpy(), l_opt.numpy(), atol=2e-3)


# ---------------------------------------------------------------------------
# The launcher and the examples on the host
# ---------------------------------------------------------------------------

LAUNCH_ARGS = ["--arch", "capsnet-mnist", "--reduced", "--steps", "8",
               "--prune", "lakp:0.7", "--finetune-steps", "4", "--n-train",
               "64", "--n-test", "32", "--batch", "8"]


def test_launch_train_on_cpu(capsys, tmp_path):
    port_train.main(LAUNCH_ARGS + ["--device", "cpu", "--ckpt-dir",
                                   str(tmp_path), "--ckpt-every", "4"])
    out = capsys.readouterr().out
    assert "trained 8 steps on cpu" in out
    assert "test acc (dense)" in out and "test acc (pruned+finetuned)" in out
    assert "routing reference:" in out and "routing cuda:" in out
    assert ck.list_steps(str(tmp_path)) == [4, 8]


def test_launch_train_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.main(LAUNCH_ARGS)


def test_launch_train_lm_names_the_roadmap_item(capsys):
    """The roadmap item this named (queue A item 6, the LM training
    surface) is done: an LM arch no longer exits 2 naming it, it trains."""
    port_train.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "2",
                     "--seq", "8", "--batch", "2", "--device", "cpu"])
    captured = capsys.readouterr()
    assert "ROADMAP.md" not in captured.err
    assert captured.out.startswith("[llama3.2-1b] 2 steps in ")


def _run_example(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(str(ROOT / "examples" / name), run_name="__main__")


def test_example_train_capsnet_on_cpu(capsys, monkeypatch):
    _run_example("pt_train_capsnet_fastcaps.py",
                 ["--steps", "6", "--finetune-steps", "3", "--n-train", "64",
                  "--device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert "trained 6 steps on cpu" in out
    assert "deployed[cuda] test acc" in out and "FPS" in out


def test_example_quickstart_on_cpu(capsys, monkeypatch):
    _run_example("pt_quickstart.py", ["--device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert "prediction agreement: 100%" in out
