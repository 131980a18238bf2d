"""Trainer: train step (grad-accum microbatches), fault tolerance
(checkpoint/restart).

The port of ``repro.training.trainer``.  Fault-tolerance contract:
  * every ``ckpt_every`` steps the full state (params, opt, step) is saved
    asynchronously with atomic publish;
  * ``Trainer.run`` always begins by restoring the latest valid checkpoint
    (missing -> fresh start), so a killed/preempted process resumes by
    simply being re-executed — this is the unit-tested crash/resume path;
  * checkpoints hold whole tensors, so the restart may run on another
    device.

The step is eager: gradients by ``torch.autograd.grad`` over the flat
parameter leaves, then the functional AdamW of ``repro_torch.optim`` (no
``torch.compile``, no CUDA graph).  The reference's ``jax.jit`` with
donated buffers has no counterpart; ``donate=True`` writes each step's
results into the tensors it was given instead of returning new ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.checkpointing import checkpoint as ckpt_lib
from repro_torch.device import resolve_device
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import adamw

LossFn = Callable[[Any, Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


@dataclasses.dataclass
class TrainerConfig:
    optim: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    grad_accum: int = 1           # microbatches per step
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    # write (params, opt_state) in place each step.  Off by default so
    # callers that keep a reference to the initial params (e.g. the
    # prune->finetune pipeline, which reuses masked_params after
    # fine-tuning) stay valid.
    donate: bool = False


def make_train_step(loss_fn: LossFn, tcfg: TrainerConfig,
                    mask_fn: Optional[Callable[[Any], Any]] = None,
                    donate: bool = True):
    """Build a (params, opt_state, batch) -> (params, opt_state, metrics)
    step.  ``batch`` leaves have a leading microbatch dim when grad_accum >
    1 (accumulated in float32, the metrics the last microbatch's)."""

    def grads_of(params, batch):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(live, grads)]
        return (tree_unflatten(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def step(params, opt_state, batch):
        if tcfg.grad_accum > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            for i in range(tcfg.grad_accum):
                grads, metrics = grads_of(
                    params, tree_map(lambda x: x[i], batch))
                acc = tree_map(lambda a, g: a + g.to(torch.float32),
                               acc, grads)
            grads = tree_map(lambda g: g / tcfg.grad_accum, acc)
        else:
            grads, metrics = grads_of(params, batch)
        new_params, new_state, opt_metrics = adamw.apply_updates(
            params, grads, opt_state, tcfg.optim, mask_fn=mask_fn)
        if donate:
            with torch.no_grad():
                new_params = tree_map(lambda old, new: old.copy_(new),
                                      params, new_params)
                new_state = tree_map(lambda old, new: old.copy_(new),
                                     opt_state, new_state)
        return new_params, new_state, dict(metrics, **opt_metrics)

    return step


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    step: int
    history: list


class Trainer:
    """``init_params_fn(generator)`` makes the initial params (it may
    ignore the generator, as fine-tuning does); ``device=None`` means the
    card and raises when there is none."""

    def __init__(self, tcfg: TrainerConfig, loss_fn: LossFn, init_params_fn,
                 mask_fn=None,
                 device: Union[None, str, torch.device] = None):
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.init_params_fn = init_params_fn
        self.mask_fn = mask_fn
        self.train_step = make_train_step(loss_fn, tcfg, mask_fn,
                                          donate=tcfg.donate)
        self.checkpointer = (
            ckpt_lib.AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
            if tcfg.ckpt_dir else None)

    def _restore_or_init(self, generator: torch.Generator
                         ) -> Tuple[Any, Any, int]:
        params = self.init_params_fn(generator)
        opt_state = adamw.init_state(params)
        if self.tcfg.ckpt_dir:
            state_struct = {"params": params, "opt": opt_state}
            found = ckpt_lib.load_latest(self.tcfg.ckpt_dir, state_struct,
                                         device=self.device)
            if found is not None:
                step, state = found
                return state["params"], state["opt"], step
        return params, opt_state, 0

    def run(self, batches: Iterator[Dict[str, Any]], n_steps: int,
            generator: Optional[torch.Generator] = None,
            crash_at: Optional[int] = None) -> TrainResult:
        """Train for n_steps total (resuming counts).  ``generator``
        defaults to one on the trainer's device seeded 0.  ``crash_at``
        raises mid-run after that step — used by the fault-tolerance
        tests."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        params, opt_state, start = self._restore_or_init(generator)
        history = []
        step = start
        for batch in batches:
            if step >= n_steps:
                break
            batch = tree_map(lambda x: torch.as_tensor(x, device=self.device),
                             batch)
            params, opt_state, metrics = self.train_step(
                params, opt_state, batch)
            step += 1
            if step % self.tcfg.log_every == 0 or step == n_steps:
                history.append({k: float(v) for k, v in metrics.items()})
            if self.checkpointer and step % self.tcfg.ckpt_every == 0:
                self.checkpointer.save(
                    step, {"params": params, "opt": opt_state})
            if crash_at is not None and step >= crash_at:
                if self.checkpointer:
                    self.checkpointer.wait()
                raise RuntimeError(f"simulated crash at step {step}")
        if self.checkpointer:
            self.checkpointer.save(step, {"params": params,
                                          "opt": opt_state})
            self.checkpointer.wait()
        return TrainResult(params, opt_state, step, history)
