"""LM assembly, dense family: stacked transformer blocks, prefill and decode
steps, and the slot-axis cache row movement serving needs.

Parameters keep the reference's layout so they convert leaf by leaf:
``{"embed": {...}, "final_ln": {...}, "units": {"block": {...}}}``, every
unit leaf stacked on a leading ``n_layers`` axis.  ``forward`` loops over
the stacked layers in Python where the reference scans them; sharding
constraints are left out until the port shards.  Caches are
``{"kv": {"k", "v"}}`` of shape (L, B, T, K, D), bfloat16, and are updated
**in place** by the steps (the reference returns new trees; the steps here
return the same dict they were given).  A ``"kv"`` dict may also carry
``k_scale`` / ``v_scale`` (L, B, T) leaves (an int8 cache), and with
``paged_tables`` its leaves are the page pool's (L, n_pages, page, K, D)
(``repro_torch.serving.pages``).

The moe, hybrid, ssm, audio and vlm families raise ``NotImplementedError``
(``make_caches`` also builds the moe shape, which is the dense one).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import (LMConfig, init_params, init_stacked,
                                       tree_leaves)

NORM_KEYS = ("ln1", "ln2", "final_ln")


def _dense_only(cfg: LMConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: the port serves the dense family so far, not "
            f"{cfg.family!r} ({cfg.arch_id})")


# ---------------------------------------------------------------------------
# Parameter definitions and init
# ---------------------------------------------------------------------------


def _block_defs(cfg: LMConfig, kind: str) -> Dict[str, Any]:
    """One transformer block; the port has the ``self`` kind."""
    if kind != "self":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if cfg.moe is not None:
        raise NotImplementedError("moe blocks are not ported yet")
    return {"ln1": common.norm_defs(cfg),
            "attn": attn_lib.attention_defs(cfg),
            "ln2": common.norm_defs(cfg),
            "ffn": mlp_lib.mlp_defs(cfg)}


def unit_defs(cfg: LMConfig) -> Dict[str, Any]:
    """Parameter defs of ONE stacked unit (a transformer block)."""
    _dense_only(cfg, "unit_defs")
    return {"block": _block_defs(cfg, "self")}


def n_units(cfg: LMConfig) -> int:
    _dense_only(cfg, "n_units")
    return cfg.n_layers


def model_defs(cfg: LMConfig) -> Dict[str, Any]:
    _dense_only(cfg, "model_defs")
    return {"embed": common.embedding_defs(cfg),
            "final_ln": common.norm_defs(cfg)}


def init(cfg: LMConfig, generator: torch.Generator,
         device: Any = None) -> Dict[str, Any]:
    """Random parameters in ``cfg.param_dtype``: the top-level leaves, then
    ``n_layers`` stacked draws of the unit.  Values are drawn on the
    generator's device (a CUDA generator keeps a full-size init on the
    card) and placed on ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    params = init_params(model_defs(cfg), generator, cfg.pdtype(), device)
    params["units"] = init_stacked(unit_defs(cfg), n_units(cfg), generator,
                                   cfg.pdtype(), device)
    return params


def compute_params(cfg: LMConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """The parameters as the forward reads them, cast once: every weight in
    ``cfg.compute_dtype`` (the reference casts at each use; the values are
    the same), norm scales and biases left as they are (``apply_norm``
    reads them in float32), the float32 embedding table kept for the
    lookup and its compute-type copy added as ``tok_cd`` for the tied
    unembedding."""
    cd = cfg.cdtype()

    def cast(tree, path):
        if isinstance(tree, dict):
            return {k: cast(v, path + (k,)) for k, v in tree.items()}
        if any(p in NORM_KEYS for p in path) or path[-1] == "tok":
            return tree
        return tree.to(cd)

    out = cast(params, ())
    if "tok" in params["embed"]:
        out["embed"]["tok_cd"] = params["embed"]["tok"].to(cd)
    return out


def layer_params(params: Dict[str, Any], i: int) -> Any:
    """Layer ``i``'s slice of the stacked unit parameters (views)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i]

    return take(params["units"])


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


def _apply_self_block(p, cfg: LMConfig, x, positions, kv_cache, cache_index,
                      prefill_offset: int = 0, paged_tables=None):
    h = common.apply_norm(p["ln1"], x, cfg)
    a, new_kv = attn_lib.self_attention(p["attn"], cfg, h, positions,
                                        kv_cache, cache_index,
                                        prefill_offset=prefill_offset,
                                        paged_tables=paged_tables)
    x = x + a
    h = common.apply_norm(p["ln2"], x, cfg)
    x = x + mlp_lib.mlp_apply(p["ffn"], cfg, h)
    return x, new_kv, 0.0


def forward(params: Dict[str, Any], cfg: LMConfig,
            batch: Dict[str, torch.Tensor],
            caches: Optional[Dict[str, Any]] = None,
            cache_index: Any = None,
            prefill_offset: int = 0,
            paged_tables=None,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], float]:
    """Returns (final hidden states (B, S, d), caches, aux loss 0.0).

    ``prefill_offset``: continuation prefill; the caches already hold rows
    ``[0, prefill_offset)`` and this forward writes the next S rows.
    ``paged_tables`` (B, P) int: paged decode; ``caches["kv"]`` leaves are
    the page pool's (L, n_pages, page, K, D) and every layer reads and
    writes its pages through the per-slot tables."""
    _dense_only(cfg, "forward")
    x = common.embed_inputs(params["embed"], cfg, batch)
    b, s = x.shape[0], x.shape[1]
    if "positions" in batch:
        positions = batch["positions"]
    elif cache_index is not None:
        ci = torch.as_tensor(cache_index, dtype=torch.int32, device=x.device)
        if ci.dim() == 1:                 # per-slot decode positions (B,)
            positions = ci[:, None].expand(b, s)
        else:
            positions = torch.zeros((b, s), dtype=torch.int32,
                                    device=x.device) + ci
    else:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
    for i in range(n_units(cfg)):
        kv = None
        if caches is not None:
            kv = {name: leaf[i] for name, leaf in caches["kv"].items()}
        x, _, _ = _apply_self_block(layer_params(params, i)["block"], cfg, x,
                                    positions, kv, cache_index,
                                    prefill_offset=prefill_offset,
                                    paged_tables=paged_tables)
    x = common.apply_norm(params["final_ln"], x, cfg)
    return x, caches, 0.0


def prefill_step(params, cfg: LMConfig, batch: Dict[str, torch.Tensor],
                 caches: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward + cache write; returns (last-token logits (B, V), caches)."""
    x, caches, _ = forward(params, cfg, batch, caches)
    return common.unembed(params["embed"], cfg, x[:, -1:, :])[:, 0], caches


def decode_step(params, cfg: LMConfig, batch: Dict[str, torch.Tensor],
                caches: Dict[str, Any], paged_tables=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode.  batch: tokens (B, 1), pos scalar or (B,) int.  A
    vector ``pos`` gives every slot its own cache index.  With
    ``paged_tables`` (B, P), ``caches`` carries the page pool's leaves and
    decode addresses pages through the tables (no gathered view)."""
    x, caches, _ = forward(params, cfg, batch, caches,
                           cache_index=batch["pos"],
                           paged_tables=paged_tables)
    return common.unembed(params["embed"], cfg, x[:, -1:, :])[:, 0], caches


def _last_real(params, cfg: LMConfig, x: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[0], x.shape[1]
    idx = torch.clamp(lengths.to(device=x.device, dtype=torch.int64) - 1,
                      0, s - 1)
    last = x[torch.arange(b, device=x.device), idx]
    return common.unembed(params["embed"], cfg, last[:, None, :])[:, 0]


def ragged_prefill_step(params, cfg: LMConfig, batch: Dict[str, torch.Tensor],
                        caches: Dict[str, Any]
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill right-padded ragged prompts in one batched forward.

    ``tokens`` (B, S) left-aligned with a zero pad suffix, ``lengths`` (B,)
    the real lengths.  Positions run 0..S-1 and the causal mask keeps real
    tokens from attending the pad, so the dense family is exact.  Returns
    the logits at each prompt's last real token; cache rows at indices >=
    length hold pad values that the decode masks by valid length."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    fwd = {k: v for k, v in batch.items() if k != "lengths"}
    fwd["positions"] = positions
    x, caches, _ = forward(params, cfg, fwd, caches)
    return _last_real(params, cfg, x, batch["lengths"]), caches


def continuation_prefill_step(params, cfg: LMConfig,
                              batch: Dict[str, torch.Tensor],
                              caches: Dict[str, Any], offset: int
                              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Ragged prefill of prompt suffixes against cached rows ``[0,
    offset)``: positions run ``offset .. offset+S-1`` and attention covers
    the cached prefix plus the fresh span.  ``offset == 0`` is
    :func:`ragged_prefill_step`."""
    if offset == 0:
        return ragged_prefill_step(params, cfg, batch, caches)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(offset, offset + s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    fwd = {k: v for k, v in batch.items() if k != "lengths"}
    fwd["positions"] = positions
    x, caches, _ = forward(params, cfg, fwd, caches, prefill_offset=offset)
    return _last_real(params, cfg, x, batch["lengths"]), caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def make_caches(cfg: LMConfig, batch: int, max_len: int,
                device: Any = None) -> Dict[str, Any]:
    """Decode/prefill caches of the dense and moe families: ``{"kv": {"k",
    "v"}}`` (L, B, T, K, D) zeros, always bfloat16, on ``device``
    (``None`` means the card)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"make_caches: the {cfg.family!r} family's caches are not "
            f"ported yet")
    return {"kv": attn_lib.make_kv_cache(cfg, batch, max_len, cfg.n_layers,
                                         dtype=torch.bfloat16,
                                         device=resolve_device(device))}


def cache_specs(cfg: LMConfig) -> Dict[str, Any]:
    """Logical-axis tree matching :func:`make_caches`."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"cache_specs: the {cfg.family!r} family is not ported yet")
    axes = ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim")
    return {"kv": {"k": axes, "v": axes}}


def _map_leaves(fn, specs, *trees):
    if isinstance(specs, dict):
        return {k: _map_leaves(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    return fn(specs, *trees)


def gather_cache_rows(cfg: LMConfig, slot_idx, caches: Any) -> Any:
    """Copies of the cache rows of slots ``slot_idx`` (k,) along each
    leaf's ``batch`` axis: a :func:`make_caches`-shaped tree of batch k."""
    def one(axes, c):
        idx = torch.as_tensor(slot_idx, dtype=torch.int64).to(c.device)
        return torch.index_select(c, axes.index("batch"), idx)

    return _map_leaves(one, cache_specs(cfg), caches)


def concat_cache_rows(cfg: LMConfig, rows_list: List[Any]) -> Any:
    """Concatenate gathered row trees along each leaf's ``batch`` axis."""
    if not rows_list:
        raise ValueError(
            "concat_cache_rows: empty rows_list — a handoff group must "
            "contain at least one gathered row tree")
    if len(rows_list) == 1:
        return rows_list[0]

    def one(axes, *leaves):
        return torch.cat(leaves, dim=axes.index("batch"))

    return _map_leaves(one, cache_specs(cfg), *rows_list)


def scatter_cache_rows(cfg: LMConfig, slot_idx, rows: Any, caches: Any
                       ) -> Any:
    """Write the sub-batch ``rows`` into ``caches`` at slots ``slot_idx``,
    in place, and return ``caches``.  A slot index outside the caches (a
    sub-batch's pad row) drops its row, as the reference's scatter does.
    The indices are read on the host."""
    idx = torch.as_tensor(slot_idx, dtype=torch.int64).cpu()

    def one(axes, n, o):
        ax = axes.index("batch")
        keep = (idx >= 0) & (idx < o.shape[ax])
        src = torch.index_select(n, ax, torch.nonzero(keep)[:, 0]
                                 .to(n.device))
        o.index_copy_(ax, idx[keep].to(o.device), src.to(o.dtype))
        return o

    return _map_leaves(one, cache_specs(cfg), rows, caches)


def cache_row_nbytes(rows: Any) -> int:
    """Payload size in bytes of a gathered cache-row tree (0 for None)."""
    if rows is None:
        return 0
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(rows)))
