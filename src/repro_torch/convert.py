"""Carry parameters between the reference package and the port.

Both packages keep parameters as nested dicts (and lists: a vlm unit's
``"selfs"``) with the same keys, shapes
and layouts (conv weights OIHW, ``digit.w`` as (N_in, N_out, d_in, d_out);
the LM's unit leaves stacked on a leading layer axis, ``wq`` as (d, H, hd),
``wo`` as (H, hd, d)), so the conversion is leaf by leaf and without
permutation.  The reference's
side hands over numpy arrays (``jax.tree.map(np.asarray, params)``); this
module never sees a JAX array.

bfloat16 leaves cross bit for bit: a numpy leaf whose dtype is named
``bfloat16`` (``ml_dtypes``' type, which JAX hands over) becomes a
``torch.bfloat16`` tensor with the same bits, and a bfloat16 tensor comes
back as the same bits in such an array.  numpy has no bfloat16 of its own,
so that direction imports ``ml_dtypes`` when it meets one, and only then
(a host without it converts every other type).
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
    arr = np.array(tree, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_to_numpy(tree: Any) -> Any:
    """Nested dicts and lists of tensors -> the same tree of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_numpy_bfloat16())
    return t.numpy()


def _numpy_bfloat16() -> np.dtype:
    try:
        import ml_dtypes
    except ImportError as err:
        raise ImportError(
            "params_to_numpy: a bfloat16 leaf needs ml_dtypes, which gives "
            "numpy its bfloat16 type; it is not installed") from err
    return np.dtype(ml_dtypes.bfloat16)
