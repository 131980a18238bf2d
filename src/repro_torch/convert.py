"""Carry parameters between the reference package and the port.

Both packages keep parameters as nested dicts (and lists: a vlm unit's
``"selfs"``) with the same keys, shapes
and layouts (conv weights OIHW, ``digit.w`` as (N_in, N_out, d_in, d_out);
the LM's unit leaves stacked on a leading layer axis, ``wq`` as (d, H, hd),
``wo`` as (H, hd, d)), so the conversion is leaf by leaf and without
permutation.  The reference's
side hands over numpy arrays (``jax.tree.map(np.asarray, params)``); this
module never sees a JAX array.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device: Any = "cpu") -> Any:
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    on ``device`` (a copy: the tensors do not alias the arrays)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts and lists of tensors -> the same tree of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()
