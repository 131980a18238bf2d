"""Checkpointing of the port: atomic publish, keep-N, async, crash/resume
(``tests/test_checkpoint.py``'s contracts, with a CapsNet loss in place of
the LM), and the on-disk layout shared with ``repro.checkpointing``: a
checkpoint written by either package loads in the other bit for bit."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as ref_ck
from repro.optim import adamw as ref_adamw
from repro_torch.checkpointing import checkpoint as ck
from repro_torch.core import capsnet as cn
from repro_torch.data import synthetic_digits as sd
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.models import lm
from repro_torch.models.common import LMConfig
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.optim import adamw
from repro_torch.training import Trainer, TrainerConfig
from torch_testlib import paired_params, small_cfgs

torch.set_num_threads(1)


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "d": [torch.ones(3), torch.zeros(())]}}


def ref_tree(t):
    """The same tree as JAX arrays."""
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), t,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


class TestSaveLoad:
    def test_roundtrip(self, tmp_path):
        t = tree()
        ck.save(str(tmp_path), 7, t)
        got = ck.load(str(tmp_path), 7, t, device="cpu")
        assert_trees_equal(got, t)
        assert isinstance(got["b"]["d"], list)
        assert got["b"]["c"].dtype == torch.int32

    def test_load_latest(self, tmp_path):
        for s in (1, 5, 3):
            ck.save(str(tmp_path), s, tree(s))
        step, got = ck.load_latest(str(tmp_path), tree(), device="cpu")
        assert step == 5
        np.testing.assert_array_equal(got["a"].numpy(), tree(5)["a"].numpy())

    def test_load_latest_empty(self, tmp_path):
        assert ck.load_latest(str(tmp_path / "none"), tree(),
                              device="cpu") is None

    def test_keep_n(self, tmp_path):
        for s in range(6):
            ck.save(str(tmp_path), s, tree(), keep=2)
        assert ck.list_steps(str(tmp_path)) == [4, 5]

    def test_atomic_partial_ignored(self, tmp_path):
        ck.save(str(tmp_path), 1, tree())
        # a crashed writer: an orphan tmp dir + a step dir w/o manifest
        os.makedirs(tmp_path / "step_000000000099.tmp")
        os.makedirs(tmp_path / "step_000000000050")
        assert ck.list_steps(str(tmp_path)) == [1]
        step, _ = ck.load_latest(str(tmp_path), tree(), device="cpu")
        assert step == 1
        # the next save garbage-collects the tmp dir
        ck.save(str(tmp_path), 2, tree())
        assert not (tmp_path / "step_000000000099.tmp").exists()

    def test_shape_mismatch_raises(self, tmp_path):
        ck.save(str(tmp_path), 1, tree())
        bad = tree()
        bad["a"] = torch.zeros((2, 2))
        with pytest.raises(ValueError):
            ck.load(str(tmp_path), 1, bad, device="cpu")

    def test_missing_leaf_raises(self, tmp_path):
        ck.save(str(tmp_path), 1, tree())
        more = dict(tree(), e=torch.zeros(2))
        with pytest.raises(KeyError):
            ck.load(str(tmp_path), 1, more, device="cpu")

    def test_restore_onto_specs(self, tmp_path):
        """The counterpart of the reference's elastic restore: the target
        is shapes only (``capsnet.specs``), the placement the caller's."""
        _, cfg = small_cfgs(conv1_channels=16)
        params = cn.init(cfg, torch.Generator().manual_seed(0))
        ck.save(str(tmp_path), 3, params)
        got = ck.load(str(tmp_path), 3, cn.specs(cfg), device="cpu")
        assert_trees_equal(got, params)
        assert all(x.device.type == "cpu" for x in tree_leaves(got))

    @pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float64,
                                       torch.int64, torch.float16))
    def test_other_dtypes_refused(self, tmp_path, dtype):
        with pytest.raises(TypeError):
            ck.save(str(tmp_path), 1, {"x": torch.zeros(3, dtype=dtype)})
        assert ck.list_steps(str(tmp_path)) == []

    def test_load_refuses_other_dtypes(self, tmp_path):
        ref_ck.save(str(tmp_path), 1, {"x": jnp.zeros(3, jnp.bfloat16)})
        with pytest.raises(TypeError):
            ck.load(str(tmp_path), 1, {"x": torch.zeros(3)}, device="cpu")

    def test_no_card_raises(self, tmp_path, monkeypatch):
        ck.save(str(tmp_path), 1, tree())
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ck.load(str(tmp_path), 1, tree())

    def test_async_checkpointer(self, tmp_path):
        c = ck.AsyncCheckpointer(str(tmp_path), keep=3)
        for s in (1, 2, 3):
            c.save(s, tree(s))
        c.close()
        assert ck.list_steps(str(tmp_path)) == [1, 2, 3]
        _, got = ck.load_latest(str(tmp_path), tree(), device="cpu")
        assert_trees_equal(got, tree(3))

    def test_async_snapshot_is_taken_at_save(self, tmp_path):
        t = tree()
        want = t["a"].clone()
        c = ck.AsyncCheckpointer(str(tmp_path))
        c.save(1, t)
        t["a"].add_(1.0)                     # an in-place update after save
        c.close()
        got = ck.load(str(tmp_path), 1, tree(), device="cpu")
        np.testing.assert_array_equal(got["a"].numpy(), want.numpy())


class TestLayoutSharedWithReference:
    def test_keys_are_jax_key_paths(self, tmp_path):
        t = tree()
        ck.save(str(tmp_path), 2, t)
        with open(tmp_path / "step_000000000002" / "manifest.json") as f:
            manifest = json.load(f)
        flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree(t))
        want = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path) for path, _ in flat]
        assert list(manifest["leaves"]) == want
        assert manifest["step"] == 2
        assert manifest["leaves"]["b/d/1"] == {
            "file": "b__d__1.npy", "shape": [], "dtype": "float32"}

    def test_manifest_equals_reference(self, tmp_path):
        t = tree()
        ck.save(str(tmp_path / "port"), 4, t)
        ref_ck.save(str(tmp_path / "ref"), 4, ref_tree(t))
        read = lambda d: json.load(open(  # noqa: E731
            tmp_path / d / "step_000000000004" / "manifest.json"))
        assert read("port") == read("ref")

    def test_port_checkpoint_loads_in_reference(self, tmp_path):
        t = tree(3)
        ck.save(str(tmp_path), 1, t)
        got = ref_ck.load(str(tmp_path), 1, ref_tree(tree()))
        assert_trees_equal(jax.tree.map(np.asarray, got),
                           jax.tree.map(np.asarray, ref_tree(t)))

    def test_reference_checkpoint_loads_in_port(self, tmp_path):
        t = tree(4)
        ref_ck.save(str(tmp_path), 1, ref_tree(t))
        got = ck.load(str(tmp_path), 1, tree(), device="cpu")
        assert_trees_equal(got, t)

    @pytest.mark.parametrize("writer", ("port", "reference"))
    def test_train_state_crosses_packages(self, tmp_path, writer):
        """A CapsNet train state (params, AdamW moments, int32 step) of one
        package restores bit for bit in the other."""
        ref_cfg, _ = small_cfgs(conv1_channels=16)
        ref_params, port_params = paired_params(ref_cfg, seed=2)
        ref_state = {"params": ref_params,
                     "opt": ref_adamw.init_state(ref_params)}
        port_state = {"params": port_params,
                      "opt": adamw.init_state(port_params)}
        rng = np.random.RandomState(0)
        for leaf in tree_leaves(port_state["opt"]["m"]):
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32)))
        port_state["opt"]["step"].fill_(17)
        if writer == "port":
            ck.save(str(tmp_path), 17, port_state)
            got = ref_ck.load(str(tmp_path), 17, ref_state)
            got_np = jax.tree.map(np.asarray, got)
            assert got_np["opt"]["step"].dtype == np.int32
            for a, b in ((got_np["params"], port_state["params"]),
                         (got_np["opt"]["m"], port_state["opt"]["m"])):
                for k in b:
                    for kk in b[k]:
                        np.testing.assert_array_equal(a[k][kk],
                                                      b[k][kk].numpy())
            assert int(got_np["opt"]["step"]) == 17
        else:
            ref_state["opt"]["step"] = jnp.int32(17)
            ref_ck.save(str(tmp_path), 17, ref_state)
            got = ck.load(str(tmp_path), 17, port_state, device="cpu")
            assert got["opt"]["step"].dtype == torch.int32
            assert int(got["opt"]["step"]) == 17
            want = jax.tree.map(np.asarray, ref_params)
            for k in want:
                for kk in want[k]:
                    np.testing.assert_array_equal(
                        got["params"][k][kk].numpy(), want[k][kk])


class TestCrashResume:
    @staticmethod
    def _trainer(cfg, d):
        tcfg = TrainerConfig(
            optim=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12),
            ckpt_dir=str(d), ckpt_every=4, log_every=4)
        return Trainer(tcfg, lambda p, b: cn.loss_fn(p, cfg, b["images"],
                                                     b["labels"]),
                       lambda g: cn.init(cfg, g), device="cpu")

    @staticmethod
    def _batches(skip=0):
        data = sd.load(sd.DigitsConfig(n_train=48, n_test=8))
        x, y = data["train"]
        for i, (bx, by) in enumerate(sd.batches(x, y, 8, 3, epochs=10)):
            if i >= skip:
                yield {"images": bx, "labels": by}

    def test_kill_and_resume_bit_exact(self, tmp_path):
        """Crash at step 10 (last ckpt 8) -> resume completes to 12 and
        matches an uninterrupted run (same data order)."""
        _, cfg = small_cfgs(conv1_channels=16)
        d1, d2 = tmp_path / "a", tmp_path / "b"
        ref = self._trainer(cfg, d1).run(self._batches(), 12)

        with pytest.raises(RuntimeError, match="simulated crash"):
            self._trainer(cfg, d2).run(self._batches(), 12, crash_at=10)
        assert ck.list_steps(str(d2))[-1] == 8
        # the resumed run replays from step 8 -> feed batches 9..12
        res = self._trainer(cfg, d2).run(self._batches(skip=8), 12)
        assert res.step == 12
        for a, b in zip(tree_leaves(ref.params), tree_leaves(res.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=0)
        assert int(res.opt_state["step"]) == 12


class TestCrashResumeLM:
    """The reference's ``tests/test_checkpoint.py`` ``TestCrashResume`` on
    the port: an LM on the token stream, checkpointed and resumed."""

    @staticmethod
    def _trainer(cfg, d):
        tcfg = TrainerConfig(
            optim=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30),
            ckpt_dir=str(d), ckpt_every=10, log_every=10)
        return Trainer(tcfg, lambda p, b: lm.loss_fn(p, cfg, b),
                       lambda g: lm.init(cfg, g, "cpu"), device="cpu")

    @staticmethod
    def _batches(cfg, skip=0):
        stream = TokenStream(TokenStreamConfig(vocab=cfg.vocab))
        for i, b in enumerate(stream.batches(4, 16, 30, seed=3)):
            if i >= skip:
                yield b

    def test_kill_and_resume_bit_exact(self, tmp_path):
        """Crash at step 25 (last ckpt 20) -> resume completes to 30 and
        matches an uninterrupted run (same data order)."""
        cfg = LMConfig(arch_id="t", family="dense", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                       remat=False)
        d1, d2 = tmp_path / "a", tmp_path / "b"
        ref = self._trainer(cfg, d1).run(self._batches(cfg), 30)
        with pytest.raises(RuntimeError, match="simulated crash"):
            self._trainer(cfg, d2).run(self._batches(cfg), 30, crash_at=25)
        assert ck.list_steps(str(d2))[-1] == 20
        # the resumed run replays from step 20 -> feed batches 21..30
        res = self._trainer(cfg, d2).run(self._batches(cfg, skip=20), 30)
        assert res.step == 30
        for a, b in zip(tree_leaves(ref.params), tree_leaves(res.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=0)
        assert int(res.opt_state["step"]) == 30

    def test_checkpoint_loads_onto_lm_specs(self, tmp_path):
        """A saved LM state restores onto ``lm.specs`` (nothing allocated
        for the target), and a checkpoint of the port loads in the
        reference onto its own init."""
        from repro.models import lm as ref_lm
        from repro.models.common import LMConfig as RefLMConfig
        kw = dict(arch_id="t", family="vlm", n_layers=3, d_model=16,
                  n_heads=2, n_kv_heads=1, d_ff=32, vocab=64,
                  cross_attn_every=2, n_image_tokens=4)
        cfg = LMConfig(**kw)
        params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        ck.save(str(tmp_path), 3, params)
        got = ck.load(str(tmp_path), 3, lm.specs(cfg), device="cpu")
        assert isinstance(got["units"]["selfs"], list)
        assert_trees_equal(got, params)
        ref = ref_ck.load(str(tmp_path), 3,
                          ref_lm.init(RefLMConfig(**kw), jax.random.key(0)))
        jax.tree.map(np.testing.assert_array_equal,
                     jax.tree.map(np.asarray, ref),
                     jax.tree.map(lambda t: t.numpy(), params,
                                  is_leaf=lambda x: isinstance(
                                      x, torch.Tensor)))
