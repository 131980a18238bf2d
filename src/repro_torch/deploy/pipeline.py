"""FastCapsPipeline: the paper's Fig. 6 methodology as one object.

    pipe = FastCapsPipeline(cfg).build(seed=0)           # on the card
    pipe.prune(sparsity_conv1=0.6, sparsity_conv2=0.9, type_keep=7)
    pipe.finetune(finetune_fn)          # optional (masked fine-tuning)
    pipe.compact()                      # 1152 -> 252 capsules
    deployed = pipe.compile(routing="cuda")

``compile`` returns an immutable :class:`DeployedCapsNet`: config + params
frozen together with a fixed-signature forward and parameter/FLOP
accounting — the artifact :class:`repro_torch.serving.CapsuleEngine`
serves.  On the card the forward is compiled the way the reference's
``jax.jit`` compiles it, once per input shape: the first call of a shape
captures a CUDA graph of the forward (:mod:`repro_torch.graphs`), every
later call replays it.  ``deployed.serve(scheduler=...)`` wraps it in that
engine directly, so the Fig. 6 pipeline flows into SLO-scheduled serving
in one chain.

Stages are enforced in order (``prune`` before ``compact``; ``compact``
before a second ``prune``), matching the one-way arrows of Fig. 6; every
stage returns ``self`` so the pipeline chains.

``device=None`` means the card and raises when there is none; the tests
pass ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch import graphs
from repro_torch.checkpointing import checkpoint
from repro_torch.core import capsnet as capsnet_lib
from repro_torch.core import lakp as lakp_lib
from repro_torch.core import routing as routing_lib
from repro_torch.deploy.registry import RoutingSpec, normalize
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves


class PipelineError(RuntimeError):
    """A pipeline stage was invoked out of Fig. 6 order."""


def capsnet_flops_per_image(cfg: capsnet_lib.CapsNetConfig) -> int:
    """Analytic forward FLOPs (conv + prediction + routing) per image."""
    conv1 = 2 * cfg.conv1_out_hw ** 2 * cfg.conv1_channels * (
        cfg.in_channels * cfg.conv1_kernel ** 2)
    conv2 = 2 * cfg.caps_out_hw ** 2 * cfg.primary_conv_channels * (
        cfg.conv1_channels * cfg.caps_kernel ** 2)
    pred = 2 * cfg.n_primary_caps * cfg.n_classes * cfg.caps_dim * \
        cfg.digit_dim
    route = routing_lib.routing_flops(
        1, cfg.n_primary_caps, cfg.n_classes, cfg.digit_dim,
        cfg.routing_iters)
    return conv1 + conv2 + pred + route


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


@dataclasses.dataclass(frozen=True)
class DeployedCapsNet:
    """Immutable deployment artifact: config + params + forward.

    The forward runs under ``torch.inference_mode()`` on parameters that
    were moved to ``device`` once, when the artifact was built
    (``device=None`` means the card and raises when there is none).  On
    the card it replays one CUDA graph per input shape and type, captured
    at the shape's first call (the counterpart of the reference's
    ``jax.jit`` retracing per shape; :mod:`repro_torch.graphs`): the images
    are copied into the graph's static input (from the device, or
    asynchronously from pinned host memory), and the lengths come back as
    a fresh tensor.  On the CPU the same forward runs eagerly.  Building
    an artifact switches TF32 off for cuDNN convolutions and for matmuls
    (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` are set to False, process
    wide): cuDNN would otherwise run a float32 convolution in TF32, which
    keeps about three decimal digits and breaks the 1e-4 agreement with the
    reference.
    """

    cfg: capsnet_lib.CapsNetConfig
    params: Dict[str, Any]
    spec: RoutingSpec
    n_params: int
    flops_per_image: int
    device: Union[None, str, torch.device] = None     # None: the card

    def __post_init__(self):
        device = resolve_device(self.device)
        # full float32 in the convolutions and the einsum (see above)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "params", _to_device(self.params, device))
        object.__setattr__(
            self, "cfg", dataclasses.replace(self.cfg, routing=self.spec))
        # one captured forward per input (shape, type, tuning policy); not
        # a field, so dataclasses.replace makes a replica with graphs of
        # its own.  The lock keeps two threads' calls off one static input.
        object.__setattr__(self, "_graphs", {})
        object.__setattr__(self, "_lock", threading.Lock())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, C) -> class capsule lengths (B, n_classes),
        a fresh tensor.  The images are copied into the static input of
        their shape (from ``device``, or asynchronously from pinned host
        memory); on the card that shape's graph is replayed (captured at
        its first call under the current tuning policy:
        :func:`repro_torch.graphs.config_key`), on the CPU the same
        forward runs eagerly."""
        key = (tuple(images.shape), images.dtype) + graphs.config_key()
        with self._lock, torch.inference_mode():
            call = self._graphs.get(key)
            if call is None:
                call = graphs.CapturedCall(
                    self._forward_body,
                    {"images": torch.empty(images.shape, dtype=images.dtype,
                                           device=self.device)},
                    name=f"DeployedCapsNet.forward {key}")
                self._graphs[key] = call
            call.stage(images=images)
            return call(reads=tree_leaves(self.params))

    __call__ = forward

    def _forward_eager(self, images: torch.Tensor) -> torch.Tensor:
        """The forward run eagerly on ``images`` on ``device``, no graph
        and no static input: what the graphs are held against."""
        with torch.inference_mode():
            return self._forward_body(images)

    def _forward_body(self, images: torch.Tensor) -> torch.Tensor:
        """What a graph captures: the forward on its static images."""
        return capsnet_lib.forward(self.params, self.cfg, images)[0]

    def graph_stats(self) -> Dict[str, float]:
        """Graphs captured, re-captured and replayed, eager runs and
        capture seconds of this artifact's forward."""
        return graphs.graph_stats(list(self._graphs.values()))

    def classify(self, images: torch.Tensor) -> torch.Tensor:
        """images -> predicted class ids (B,)."""
        return torch.argmax(self.forward(images), dim=-1)

    def serve(self, batch_size: int = 32, scheduler: Any = None,
              kernel_tune: Any = None):
        """Wrap this artifact in a
        :class:`repro_torch.serving.CapsuleEngine` so the Fig. 6 pipeline
        flows straight into serving:

            engine = pipe.compile(routing="cuda").serve(
                scheduler=SLOBatchScheduler(target_p95_ms=20))

        ``batch_size`` is the engine capacity (max frames per tick);
        ``scheduler`` is any :class:`repro_torch.serving.Scheduler` (FIFO
        when None).  The returned engine's ``submit()`` is thread-safe and
        non-blocking; drive it with ``run_until_idle()`` or a ``tick()``
        loop and read per-class latency p50/p95 from ``stats()``.
        ``kernel_tune=True`` makes ``engine.warmup()`` autotune the fused
        routing kernel's launch geometry (see
        :mod:`repro_torch.kernels.tuning`).
        """
        from repro_torch.serving import CapsuleEngine

        return CapsuleEngine(self, batch_size=batch_size,
                             scheduler=scheduler, kernel_tune=kernel_tune,
                             device=self.device)

    def save(self, directory: str, step: int = 0) -> str:
        """Checkpoint the params (atomic publish) + a deploy manifest, in
        the reference's layout and keys."""
        path = checkpoint.save(directory, step, self.params)
        meta = {"cfg": dataclasses.asdict(
                    dataclasses.replace(self.cfg, routing=None)),
                "routing": dataclasses.asdict(self.spec),
                "n_params": self.n_params,
                "flops_per_image": self.flops_per_image}
        with open(os.path.join(directory, "deploy.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return path


class FastCapsPipeline:
    """Chainable Fig. 6 pipeline; the canonical `repro_torch.deploy` entry
    point.

    ``FastCapsPipeline(cfg, params=...)`` adopts already-trained params
    (skipping ``build``); otherwise call ``build(seed=...)`` first.
    """

    _ORDER = ("init", "built", "pruned", "finetuned", "compacted")

    def __init__(self, cfg: capsnet_lib.CapsNetConfig,
                 params: Optional[Dict[str, Any]] = None,
                 device: Union[None, str, torch.device] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = (_to_device(params, self.device)
                       if params is not None else None)
        self.masks: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.index: Dict[str, torch.Tensor] = {}
        self.compression: Optional[float] = None
        self.index_overhead_frac: Optional[float] = None
        self._stage = "built" if params is not None else "init"

    # -- stage machinery ---------------------------------------------------

    def _require(self, *stages: str) -> None:
        if self._stage not in stages:
            raise PipelineError(
                f"stage {self._stage!r} cannot run this step; expected one "
                f"of {stages}")

    @property
    def stage(self) -> str:
        return self._stage

    # -- Fig. 6 stages -----------------------------------------------------

    def build(self, seed: int = 0,
              generator: Optional[torch.Generator] = None
              ) -> "FastCapsPipeline":
        """Initialize dense params from ``seed`` (or from a generator the
        caller owns)."""
        self._require("init")
        if generator is None:
            generator = torch.Generator(device="cpu")
            generator.manual_seed(seed)
        self.params = capsnet_lib.init(self.cfg, generator, self.device)
        self._stage = "built"
        return self

    def prune(self, sparsity_conv1: float, sparsity_conv2: float,
              method: str = "lakp", norm: str = "l1",
              type_keep: Optional[int] = None) -> "FastCapsPipeline":
        """LAKP/KP kernel scoring + masking (+ capsule-type elimination)."""
        self._require("built", "compacted")
        self.masks = capsnet_lib.lakp_masks(
            self.params, self.cfg, sparsity_conv1, sparsity_conv2,
            method=method, norm=norm, type_keep=type_keep)
        conv_ws = [self.params["conv1"]["w"], self.params["conv2"]["w"]]
        self.compression = lakp_lib.effective_compression(
            list(self.masks), conv_ws)
        self.params = capsnet_lib.apply_masks(self.params, self.masks)
        self._stage = "pruned"
        return self

    def finetune(self, finetune_fn: Callable[[Dict[str, Any], Any],
                                             Dict[str, Any]]
                 ) -> "FastCapsPipeline":
        """Masked fine-tuning: ``finetune_fn(masked_params, masks)`` is
        injected by the trainer (keeps the pipeline optimizer-free)."""
        self._require("pruned")
        self.params = finetune_fn(self.params, self.masks)
        self._stage = "finetuned"
        return self

    def compact(self) -> "FastCapsPipeline":
        """Physically remove dead kernels/capsule types (index study)."""
        self._require("pruned", "finetuned")
        self.params, self.cfg, self.index = capsnet_lib.compact(
            self.params, self.cfg, self.masks)
        surviving = capsnet_lib.param_count(self.params)
        self.index_overhead_frac = lakp_lib.index_overhead_bytes(
            list(self.masks)) / max(surviving * 4, 1)
        self._stage = "compacted"
        return self

    def compile(self, routing: Union[None, str, RoutingSpec] = None,
                ) -> DeployedCapsNet:
        """Freeze the current model into a :class:`DeployedCapsNet`.

        ``routing``: a :class:`RoutingSpec`, a variant name (deployment
        defaults via ``RoutingSpec.named``), or None to keep the config's
        own spec.  Valid from any stage with params (deploy-the-dense-model
        is the Fig. 1 baseline).  The artifact's forward is compiled per
        input shape at its first call on the card, as the reference's
        ``jax.jit`` is: a CUDA graph captured then and replayed after
        (:meth:`DeployedCapsNet.forward`).
        """
        self._require("built", "pruned", "finetuned", "compacted")
        if routing is None:
            spec = self.cfg.routing_spec()
        elif isinstance(routing, str):
            spec = RoutingSpec.named(routing)
        else:
            spec = routing
        return DeployedCapsNet(
            cfg=self.cfg,                 # the artifact binds spec into cfg
            params=self.params,
            spec=normalize(spec),
            n_params=capsnet_lib.param_count(self.params),
            flops_per_image=capsnet_flops_per_image(self.cfg),
            device=self.device,
        )

    # -- one-call convenience ----------------------------------------------

    def deploy(self, sparsity_conv1: float, sparsity_conv2: float,
               method: str = "lakp", type_keep: Optional[int] = None,
               finetune_fn: Optional[Callable] = None,
               routing: Union[None, str, RoutingSpec] = "cuda",
               ) -> DeployedCapsNet:
        """build -> prune -> [finetune] -> compact -> compile in one call."""
        if self._stage == "init":
            self.build()
        self.prune(sparsity_conv1, sparsity_conv2, method=method,
                   type_keep=type_keep)
        if finetune_fn is not None:
            self.finetune(finetune_fn)
        self.compact()
        return self.compile(routing=routing)
