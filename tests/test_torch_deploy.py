"""Port parity: ``repro_torch.deploy`` (FastCapsPipeline, DeployedCapsNet)
against ``repro.deploy`` on converted parameters, the configs, the device
rule of every entry point, and the import rule of the whole port."""

import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.deploy import FastCapsPipeline as RefPipeline
from repro.deploy.pipeline import capsnet_flops_per_image as ref_flops
from repro_torch import configs as port_configs
from repro_torch import resolve_device
from repro_torch.core import capsnet as port_cn
from repro_torch.deploy import (DeployedCapsNet, FastCapsPipeline,
                                PipelineError, RoutingSpec,
                                capsnet_flops_per_image)
from repro_torch.launch import serve as port_serve
from repro_torch.serving import CapsuleEngine
from torch_testlib import (f32, images, paired_params, small_cfgs, to_jax,
                           to_torch)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-4     # float32 forward in two frameworks, sums in another order


def _pipelines(seed=0):
    ref_cfg, port_cfg = small_cfgs()
    ref_params, port_params = paired_params(ref_cfg, seed)
    return (RefPipeline(ref_cfg, params=ref_params),
            FastCapsPipeline(port_cfg, params=port_params, device="cpu"))


class TestConfigs:
    def test_archs(self):
        assert port_configs.PAPER_ARCHS == ["capsnet-mnist", "capsnet-fmnist"]
        assert port_configs.PAPER_ARCHS == ref_configs.PAPER_ARCHS
        assert port_configs.list_archs(include_paper=False) == [
            "llama3.2-1b", "qwen3-1.7b", "mistral-large-123b",
            "qwen1.5-110b", "deepseek-moe-16b", "dbrx-132b",
            "llama-3.2-vision-90b", "xlstm-1.3b", "zamba2-1.2b",
            "hubert-xlarge"]

    @pytest.mark.parametrize("arch", ["capsnet-mnist", "capsnet-fmnist"])
    def test_published_configs_match_reference(self, arch):
        ours = dataclasses.asdict(port_configs.get_config(arch))
        theirs = dataclasses.asdict(ref_configs.get_config(arch))
        ours.pop("routing"), theirs.pop("routing")
        assert ours == theirs
        assert port_configs.get_config(arch).routing == RoutingSpec.reference()

    @pytest.mark.parametrize("arch", ["capsnet-mnist", "capsnet-fmnist"])
    def test_reduced_matches_reference(self, arch):
        ours = dataclasses.asdict(port_configs.reduced(
            port_configs.get_config(arch)))
        theirs = dataclasses.asdict(ref_configs.reduced(
            ref_configs.get_config(arch)))
        ours.pop("routing"), theirs.pop("routing")
        assert ours == theirs

    def test_optimized_variant_uses_the_cuda_kernel(self):
        from repro_torch.configs import capsnet_mnist
        assert capsnet_mnist.OPTIMIZED.routing == RoutingSpec.cuda("taylor")

    def test_unknown_arch_and_config_raise(self):
        with pytest.raises(ValueError, match="unknown arch"):
            port_configs.get_config("no-such-arch-1b")
        with pytest.raises(TypeError):
            port_configs.reduced(object())

    @pytest.mark.parametrize("kw", [{}, {"conv1_channels": 103,
                                         "caps_types": 7}])
    def test_flops_per_image(self, kw):
        a, b = small_cfgs(**kw)
        assert capsnet_flops_per_image(b) == ref_flops(a)
        full = type(ref_configs.get_config("capsnet-mnist"))(**kw)
        assert capsnet_flops_per_image(port_cn.CapsNetConfig(**kw)) == ref_flops(full)


class TestPipelineStages:
    def test_order_is_enforced(self):
        _, pipe = _pipelines()
        with pytest.raises(PipelineError):
            pipe.compact()
        with pytest.raises(PipelineError):
            pipe.finetune(lambda p, m: p)
        pipe.prune(0.5, 0.5)
        with pytest.raises(PipelineError):
            pipe.prune(0.5, 0.5)
        with pytest.raises(PipelineError):
            pipe.build()
        pipe.compact()
        assert pipe.stage == "compacted"
        pipe.prune(0.2, 0.2)            # a second round after compaction
        assert pipe.stage == "pruned"

    def test_build_needs_init_stage_and_is_seeded(self):
        _, cfg = small_cfgs()
        a = FastCapsPipeline(cfg, device="cpu").build(seed=5)
        b = FastCapsPipeline(cfg, device="cpu").build(seed=5)
        c = FastCapsPipeline(cfg, device="cpu").build(seed=6)
        assert a.stage == "built"
        assert torch.equal(a.params["digit"]["w"], b.params["digit"]["w"])
        assert not torch.equal(a.params["digit"]["w"], c.params["digit"]["w"])
        g = torch.Generator().manual_seed(5)
        d = FastCapsPipeline(cfg, device="cpu").build(generator=g)
        assert torch.equal(a.params["conv1"]["w"], d.params["conv1"]["w"])

    def test_finetune_is_injected(self):
        _, pipe = _pipelines()
        seen = {}

        def tune(params, masks):
            seen["masks"] = masks
            out = dict(params)
            out["digit"] = {"w": params["digit"]["w"] * 2.0}
            return out

        before = pipe.params["digit"]["w"].clone()
        pipe.prune(0.5, 0.5).finetune(tune)
        assert pipe.stage == "finetuned" and seen["masks"] is pipe.masks
        assert torch.equal(pipe.params["digit"]["w"], before * 2.0)
        pipe.compact()

    @pytest.mark.parametrize("s1,s2,keep", [(0.6, 0.9, 2), (0.5, 0.5, None)])
    def test_prune_compact_identical_to_reference(self, s1, s2, keep):
        ref_pipe, pipe = _pipelines(seed=2)
        ref_pipe.prune(s1, s2, type_keep=keep).compact()
        pipe.prune(s1, s2, type_keep=keep).compact()
        for g, w in zip(pipe.masks, ref_pipe.masks):
            np.testing.assert_array_equal(f32(g), f32(w))
        for k in ("conv1_out", "caps_types"):
            np.testing.assert_array_equal(pipe.index[k].numpy(),
                                          np.asarray(ref_pipe.index[k]))
        assert pipe.cfg.n_primary_caps == ref_pipe.cfg.n_primary_caps
        assert pipe.compression == pytest.approx(ref_pipe.compression)
        assert pipe.index_overhead_frac == pytest.approx(
            ref_pipe.index_overhead_frac)
        for layer in ("conv1", "conv2", "digit"):
            assert (tuple(pipe.params[layer]["w"].shape)
                    == tuple(ref_pipe.params[layer]["w"].shape))


class TestDeployed:
    @pytest.mark.parametrize("name,ref_name", [("reference", "reference"),
                                               ("optimized", "optimized"),
                                               ("cuda", "pallas")])
    @pytest.mark.parametrize("pruned", [False, True])
    def test_forward_and_classify_match_reference(self, name, ref_name,
                                                  pruned):
        ref_pipe, pipe = _pipelines(seed=3)
        if pruned:
            ref_pipe.prune(0.6, 0.9, type_keep=2).compact()
            pipe.prune(0.6, 0.9, type_keep=2).compact()
        ref_dep = ref_pipe.compile(routing=ref_name)
        dep = pipe.compile(routing=name)
        assert dep.spec == RoutingSpec.named(name)
        assert dep.cfg.routing == dep.spec
        assert dep.n_params == ref_dep.n_params
        assert dep.flops_per_image == ref_dep.flops_per_image
        assert dep.device == torch.device("cpu")
        x = images(7, 9, dep.cfg)
        want = f32(ref_dep.forward(to_jax(x)))
        got = dep.forward(to_torch(x))
        assert not got.requires_grad
        np.testing.assert_allclose(f32(got), want, atol=ATOL)
        np.testing.assert_array_equal(
            dep.classify(to_torch(x)).numpy(),
            np.asarray(ref_dep.classify(to_jax(x))))
        np.testing.assert_array_equal(f32(dep(to_torch(x))), f32(got))

    def test_compile_keeps_config_spec_and_accepts_spec_objects(self):
        _, pipe = _pipelines()
        assert pipe.compile().spec == RoutingSpec.reference()
        spec = RoutingSpec.optimized(softmax="exact")
        assert pipe.compile(routing=spec).spec == spec
        with pytest.raises(ValueError, match="unknown routing variant"):
            pipe.compile(routing="pallas")

    def test_deploy_one_call(self):
        ref_cfg, cfg = small_cfgs()
        _, params = paired_params(ref_cfg, 4)
        dep = FastCapsPipeline(cfg, params=params, device="cpu").deploy(
            0.6, 0.9, type_keep=2)
        assert dep.spec.mode == "cuda" and dep.cfg.caps_types == 2
        dep2 = FastCapsPipeline(cfg, device="cpu").deploy(
            0.5, 0.5, routing="optimized",
            finetune_fn=lambda p, m: p)
        assert dep2.spec.mode == "optimized"

    def test_deployed_is_frozen_and_sets_full_float32(self):
        _, pipe = _pipelines()
        torch.backends.cudnn.allow_tf32 = True
        dep = pipe.compile(routing="optimized")
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        with pytest.raises(dataclasses.FrozenInstanceError):
            dep.spec = RoutingSpec.reference()
        assert callable(dep.save)             # tests/test_torch_train.py

    def test_serve_returns_engine_on_the_artifact_device(self):
        _, pipe = _pipelines()
        eng = pipe.compile(routing="cuda").serve(batch_size=4)
        assert isinstance(eng, CapsuleEngine)
        assert eng.capacity == 4 and eng.device == torch.device("cpu")


class TestDeviceRule:
    """``device=None`` means the card; without one every entry point raises
    instead of moving to the CPU."""

    def _no_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: device=None is legal here")

    def test_resolve_device(self):
        assert resolve_device("cpu") == torch.device("cpu")
        assert resolve_device(torch.device("cpu")) == torch.device("cpu")
        self._no_card()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")

    def test_pipeline_raises(self):
        self._no_card()
        _, cfg = small_cfgs()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FastCapsPipeline(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FastCapsPipeline(cfg, device=None)

    def test_deployed_raises(self):
        self._no_card()
        _, pipe = _pipelines()
        dep = pipe.compile(routing="optimized")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeployedCapsNet(cfg=dep.cfg, params=dep.params, spec=dep.spec,
                            n_params=dep.n_params,
                            flops_per_image=dep.flops_per_image)

    def test_engine_raises(self):
        self._no_card()
        _, pipe = _pipelines()
        dep = pipe.compile(routing="optimized")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CapsuleEngine(dep, batch_size=4)

    def test_launcher_defaults_to_the_card_and_raises(self):
        self._no_card()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_serve.main(["--arch", "capsnet-mnist"])

    def test_engine_rejects_a_device_other_than_the_artifacts(self):
        _, pipe = _pipelines()
        dep = pipe.compile(routing="optimized")
        with pytest.raises(ValueError, match="differs"):
            CapsuleEngine(dep, batch_size=4, device="meta")


class TestLauncher:
    @pytest.mark.parametrize("extra", [[], ["--routing", "optimized",
                                            "--scheduler", "slo"],
                                       ["--priority", "--sparsity", "0"],
                                       ["--routing", "reference",
                                        "--kernel-tune"]])
    def test_cli_on_cpu(self, capsys, extra):
        port_serve.main(["--arch", "capsnet-mnist", "--requests", "3",
                         "--batch", "4", "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert "deployed on cpu" in out and "served 3 requests" in out

    def test_cli_rejects_waiting_options(self):
        """``--scheduler sharded`` serves now; ``--multihost`` is for LM
        serving behind ``--scheduler disagg`` only."""
        for bad in (["--multihost"],
                    ["--scheduler", "disagg", "--multihost"],
                    ["--routing", "pallas"],
                    ["--arch", "no-such-arch-1b"]):
            with pytest.raises(SystemExit):
                port_serve.main(["--arch", "capsnet-mnist", "--device", "cpu"]
                                + bad)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("pt_*.py"))


def test_port_has_files_to_check():
    assert len(PORT_FILES) > 20
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("models/attention.py", "models/lm.py", "models/mlp.py",
                "serving/engine.py", "serving/pages.py",
                "kernels/attention/kernel.py",
                "kernels/attention/ref.py", "kernels/sampling/kernel.py",
                "kernels/sampling/ref.py", "configs/llama3p2_1b.py",
                "configs/qwen3_1p7b.py", "data/synthetic_digits.py",
                "optim/adamw.py", "checkpointing/checkpoint.py",
                "training/trainer.py", "core/pruning.py", "launch/train.py",
                "serving/transport.py", "serving/disagg.py",
                "traffic/traces.py", "traffic/replay.py",
                "traffic/controller.py", "traffic/admission.py"):
        assert f"src/repro_torch/{mod}" in names, mod


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro"), (
            f"{path.relative_to(ROOT)} imports {name}")
