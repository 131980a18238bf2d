"""AdamW + schedules + global-norm clipping, functional on trees of tensors.

The port of ``repro.optim.adamw``.  State is a plain tree {m, v, step}:
moments are float32 whatever the parameter's type, ``step`` a 0-d int32
tensor.  The arithmetic is the reference's, in its order (``mask_fn``, then
the clip, then the moments, bias correction, ``delta + wd * p`` and
``p - lr * delta``), so the two packages agree to float32 rounding.  It is
not ``torch.optim.AdamW``: that one decays the weights before the moment
step and rounds differently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"      # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor), float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * (1 - frac)
    else:
        decay = torch.ones((), dtype=torch.float32, device=s.device)
    return cfg.lr * warm * decay


def state_specs(param_axes: Any) -> Dict[str, Any]:
    """Logical axes of :func:`init_state`'s tree: the moments shard exactly
    like their parameters, ``step`` is replicated."""
    return {"m": param_axes, "v": param_axes, "step": None}


def init_state(params: Any) -> Dict[str, Any]:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = tree_leaves(params)[0].device
    return {"m": zeros,
            "v": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32)))
              for g in tree_leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: Dict[str, Any],
                  cfg: AdamWConfig,
                  mask_fn: Optional[Callable[[Any], Any]] = None
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  ``mask_fn`` (e.g. pruning masks) is applied to the
    gradients before the clip and the moment update, so pruned weights stay
    zero.  Returns new trees; the inputs are left as they were."""
    if mask_fn is not None:
        grads = mask_fn(grads)
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        gnorm = global_norm(grads)
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        m_n = b1 * m + (1 - b1) * g
        v_n = b2 * v + (1 - b2) * torch.square(g)
        mh = m_n / bc1
        vh = v_n / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m_n, v_n

    out = []                       # in the params' leaf order, by key
    tree_map(lambda *leaf: out.append(upd(*leaf)), params, grads,
             state["m"], state["v"])
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_state = {"m": tree_unflatten(params, [o[1] for o in out]),
                 "v": tree_unflatten(params, [o[2] for o in out]),
                 "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
