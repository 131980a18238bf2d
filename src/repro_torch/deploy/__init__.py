"""``repro_torch.deploy`` — the canonical FastCaps deployment API.

  * :mod:`repro_torch.deploy.registry` — typed :class:`RoutingSpec` + the
    routing-variant registry;
  * :mod:`repro_torch.deploy.pipeline` — :class:`FastCapsPipeline`, the
    Fig. 6 methodology as one chainable object
    (``build() -> prune() -> finetune() -> compact() -> compile()``)
    producing an immutable :class:`DeployedCapsNet`;
  * :class:`repro_torch.serving.CapsuleEngine` consumes the deployed model
    for batched, FPS-measured image serving — ``deployed.serve(
    scheduler=...)`` wires the pipeline straight into the serving engine.
"""

from repro_torch.deploy.registry import (RoutingRegistry,  # noqa: F401
                                         RoutingSpec, RoutingVariant,
                                         normalize, registry, resolve)

# pipeline imports core.capsnet, which itself imports this package for
# RoutingSpec — load it lazily (PEP 562) to keep the import graph acyclic.
_PIPELINE_ATTRS = ("FastCapsPipeline", "DeployedCapsNet", "PipelineError",
                   "capsnet_flops_per_image", "pipeline")


def __getattr__(name):
    if name in _PIPELINE_ATTRS:
        import importlib

        pipeline = importlib.import_module("repro_torch.deploy.pipeline")
        if name == "pipeline":
            return pipeline
        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_PIPELINE_ATTRS))
