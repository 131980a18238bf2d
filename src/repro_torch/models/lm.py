"""LM assembly, dense / moe / vlm families: stacked transformer units,
prefill and decode steps, and the slot-axis cache row movement serving
needs.

Parameters keep the reference's layout so they convert leaf by leaf:
``{"embed": {...}, "final_ln": {...}, "units": {...}}``, every unit leaf
stacked on a leading ``n_units`` axis.  A unit is one transformer block
(``{"block": ...}``) for dense and moe (whose feed-forward is the expert
layer, ``repro_torch.models.moe``), and for vlm a group of
``cross_attn_every`` self-attention blocks and one cross-attention block
(``{"selfs": [...], "cross": ...}``, a list in the tree).  ``forward``
loops over the stacked units in Python where the reference scans them;
sharding constraints are left out until the port shards.

Caches are bfloat16 and updated **in place** by the steps (the reference
returns new trees; the steps here return the same dict they were given):
``{"kv": {"k", "v"}}`` of shape (L, B, T, K, D) for dense and moe, and for
vlm ``{"units": {"kv": {"k", "v"} (nu, k, B, T, K, D), "cross": {"k", "v"}
(nu, B, n_image_tokens, K, D)}}``.  A ``"kv"`` dict may also carry
``k_scale`` / ``v_scale`` leaves (an int8 cache), and with ``paged_tables``
(dense and moe) its leaves are the page pool's (L, n_pages, page, K, D)
(``repro_torch.serving.pages``).

The hybrid, ssm and audio families raise ``NotImplementedError`` (ROADMAP
A6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (LMConfig, ParamDef, init_params,
                                       init_stacked, tree_leaves)

NORM_KEYS = ("ln1", "ln2", "final_ln")
# kept in the parameter type: the router computes its logits in float32
# from the parameter itself, and a bfloat16 copy would move the top-k
ROUTER_KEYS = ("router", "router_b")
SERVED_FAMILIES = ("dense", "moe", "vlm")


def _served_only(cfg: LMConfig, what: str) -> None:
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{what}: the port serves the dense, moe and vlm families so "
            f"far, not {cfg.family!r} ({cfg.arch_id}); see ROADMAP.md, "
            f"queue A item 6")


# ---------------------------------------------------------------------------
# Parameter definitions and init
# ---------------------------------------------------------------------------


def _block_defs(cfg: LMConfig, kind: str) -> Dict[str, Any]:
    """One transformer block (kind: self | cross)."""
    if kind not in ("self", "cross"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    d: Dict[str, Any] = {"ln1": common.norm_defs(cfg),
                         "attn": attn_lib.attention_defs(
                             cfg, cross=(kind == "cross")),
                         "ln2": common.norm_defs(cfg)}
    if cfg.moe is not None and kind == "self":
        d["ffn"] = moe_lib.moe_defs(cfg)
    else:
        d["ffn"] = mlp_lib.mlp_defs(cfg)
    return d


def unit_defs(cfg: LMConfig) -> Dict[str, Any]:
    """Parameter defs of ONE stacked unit of this family."""
    _served_only(cfg, "unit_defs")
    if cfg.family == "vlm":
        return {"selfs": [_block_defs(cfg, "self")
                          for _ in range(cfg.cross_attn_every)],
                "cross": _block_defs(cfg, "cross")}
    return {"block": _block_defs(cfg, "self")}


def n_units(cfg: LMConfig) -> int:
    _served_only(cfg, "n_units")
    if cfg.family == "vlm":
        k = cfg.cross_attn_every + 1
        if cfg.n_layers % k:
            raise ValueError(f"vlm: n_layers={cfg.n_layers} is no multiple "
                             f"of cross_attn_every + 1 = {k}")
        return cfg.n_layers // k
    return cfg.n_layers


def model_defs(cfg: LMConfig) -> Dict[str, Any]:
    _served_only(cfg, "model_defs")
    defs: Dict[str, Any] = {"embed": common.embedding_defs(cfg)}
    if cfg.cross_attn_every:
        defs["embed"]["img_proj"] = ParamDef(
            (cfg.d_model, cfg.d_model), ("embed", "embed_tp"),
            common.fanin_init())
    defs["final_ln"] = common.norm_defs(cfg)
    return defs


def param_bytes(cfg: LMConfig) -> int:
    """Bytes of the parameters in ``cfg.param_dtype``, from the defs (no
    allocation)."""
    n = (common.param_numel(model_defs(cfg))
         + n_units(cfg) * common.param_numel(unit_defs(cfg)))
    return n * torch.empty((), dtype=cfg.pdtype()).element_size()


def init(cfg: LMConfig, generator: torch.Generator,
         device: Any = None) -> Dict[str, Any]:
    """Random parameters in ``cfg.param_dtype``: the top-level leaves, then
    ``n_units`` stacked draws of the unit.  Values are drawn on the
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
    reads them in float32), the router's ``router`` / ``router_b`` left in
    the parameter type (the reference computes router logits from the
    float32 parameter), the float32 embedding table kept for the lookup and
    its compute-type copy added as ``tok_cd`` for the tied unembedding."""
    cd = cfg.cdtype()

    def cast(tree, path):
        if isinstance(tree, dict):
            return {k: cast(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, path) for v in tree]
        if (any(p in NORM_KEYS for p in path) or path[-1] == "tok"
                or path[-1] in ROUTER_KEYS):
            return tree
        return tree.to(cd)

    out = cast(params, ())
    if "tok" in params["embed"]:
        out["embed"]["tok_cd"] = params["embed"]["tok"].to(cd)
    return out


def layer_params(params: Dict[str, Any], i: int) -> Any:
    """Unit ``i``'s slice of the stacked unit parameters (views)."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [take(v) for v in tree]
        return tree[i]

    return take(params["units"])


# ---------------------------------------------------------------------------
# Blocks and forward
# ---------------------------------------------------------------------------


def _apply_self_block(p, cfg: LMConfig, x, positions, kv_cache, cache_index,
                      token_mask=None, prefill_offset: int = 0,
                      paged_tables=None):
    h = common.apply_norm(p["ln1"], x, cfg)
    a, new_kv = attn_lib.self_attention(p["attn"], cfg, h, positions,
                                        kv_cache, cache_index,
                                        prefill_offset=prefill_offset,
                                        paged_tables=paged_tables)
    x = x + a
    h = common.apply_norm(p["ln2"], x, cfg)
    if cfg.moe is not None and "router" in p["ffn"]:
        y, aux = moe_lib.moe_apply(p["ffn"], cfg, h, token_mask=token_mask)
    else:
        y, aux = mlp_lib.mlp_apply(p["ffn"], cfg, h), 0.0
    return x + y, new_kv, aux


def _apply_cross_block(p, cfg: LMConfig, x, img_feats, cross_cache):
    h = common.apply_norm(p["ln1"], x, cfg)
    a, new_cache = attn_lib.cross_attention(p["attn"], cfg, h, img_feats,
                                            cross_cache)
    x = x + a
    h = common.apply_norm(p["ln2"], x, cfg)
    return x + mlp_lib.mlp_apply(p["ffn"], cfg, h), new_cache


def _slice(tree: Dict[str, torch.Tensor], *idx: int) -> Dict[str, torch.Tensor]:
    """One layer's leaves of a stacked cache dict (views)."""
    return {name: leaf[idx] for name, leaf in tree.items()}


def forward(params: Dict[str, Any], cfg: LMConfig,
            batch: Dict[str, torch.Tensor],
            caches: Optional[Dict[str, Any]] = None,
            cache_index: Any = None,
            prefill_offset: int = 0,
            paged_tables=None,
            ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Any]:
    """Returns (final hidden states (B, S, d), caches, aux loss: the moe
    layers' load-balance losses summed, 0.0 for a model without them).

    ``batch`` may carry ``token_mask`` (B, S) (moe: real tokens of a ragged
    batch) and, for vlm, ``image_features`` (B, n_image_tokens, d_model),
    projected by ``img_proj`` and cross-attended (cached at prefill; a
    prompt without them reads the cross cache as it is).
    ``prefill_offset``: continuation prefill; the caches already hold rows
    ``[0, prefill_offset)`` and this forward writes the next S rows.
    ``paged_tables`` (B, P) int: paged decode (dense and moe); the
    ``caches["kv"]`` leaves are the page pool's (L, n_pages, page, K, D)
    and every layer reads and writes its pages through the per-slot
    tables."""
    _served_only(cfg, "forward")
    if paged_tables is not None and cfg.family == "vlm":
        raise ValueError("paged_tables: dense / moe decode only")
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
    token_mask = batch.get("token_mask")
    aux: Any = 0.0
    if cfg.family == "vlm":
        img = batch.get("image_features")
        if img is not None:
            cd = cfg.cdtype()
            img = img.to(cd) @ params["embed"]["img_proj"].to(cd)
        cu = None if caches is None else caches["units"]
        for i in range(n_units(cfg)):
            p = layer_params(params, i)
            for j, pj in enumerate(p["selfs"]):
                kv = None if cu is None else _slice(cu["kv"], i, j)
                x, _, a = _apply_self_block(pj, cfg, x, positions, kv,
                                            cache_index,
                                            token_mask=token_mask,
                                            prefill_offset=prefill_offset)
                aux = aux + a
            cross = None if cu is None else _slice(cu["cross"], i)
            x, _ = _apply_cross_block(p["cross"], cfg, x, img, cross)
    else:
        for i in range(n_units(cfg)):
            kv = None if caches is None else _slice(caches["kv"], i)
            x, _, a = _apply_self_block(layer_params(params, i)["block"], cfg,
                                        x, positions, kv, cache_index,
                                        token_mask=token_mask,
                                        prefill_offset=prefill_offset,
                                        paged_tables=paged_tables)
            aux = aux + a
    x = common.apply_norm(params["final_ln"], x, cfg)
    return x, caches, aux


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


def _prefill_batch(cfg: LMConfig, batch: Dict[str, torch.Tensor],
                   offset: int) -> Dict[str, torch.Tensor]:
    """The forward batch of a ragged prefill: ``lengths`` dropped,
    positions ``offset .. offset+S-1``, and for moe the ``token_mask`` of
    each row's real tokens."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cols = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    fwd = {k: v for k, v in batch.items() if k != "lengths"}
    fwd["positions"] = (cols + offset).expand(b, s)
    if cfg.moe is not None:
        fwd["token_mask"] = cols < batch["lengths"].to(
            device=tokens.device, dtype=torch.int32)[:, None]
    return fwd


def ragged_prefill_step(params, cfg: LMConfig, batch: Dict[str, torch.Tensor],
                        caches: Dict[str, Any]
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Prefill right-padded ragged prompts in one batched forward.

    ``tokens`` (B, S) left-aligned with a zero pad suffix, ``lengths`` (B,)
    the real lengths.  Positions run 0..S-1 and the causal mask keeps real
    tokens from attending the pad, so dense and vlm are exact; moe is exact
    too: a ``token_mask`` built from ``lengths`` keeps pad tokens out of
    expert routing and gives each row the capacity of its real token
    count.  Returns the logits at each prompt's last real token; cache rows
    at indices >= length hold pad values that the decode masks by valid
    length."""
    x, caches, _ = forward(params, cfg, _prefill_batch(cfg, batch, 0),
                           caches)
    return _last_real(params, cfg, x, batch["lengths"]), caches


def continuation_prefill_step(params, cfg: LMConfig,
                              batch: Dict[str, torch.Tensor],
                              caches: Dict[str, Any], offset: int
                              ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Ragged prefill of prompt suffixes against cached rows ``[0,
    offset)``: positions run ``offset .. offset+S-1`` and attention covers
    the cached prefix plus the fresh span.  ``offset == 0`` is
    :func:`ragged_prefill_step`.  moe: expert capacity derives from the
    suffix's token count, where ``generate()`` derives it from the whole
    prompt, so drops may differ when capacity binds."""
    if offset == 0:
        return ragged_prefill_step(params, cfg, batch, caches)
    x, caches, _ = forward(params, cfg, _prefill_batch(cfg, batch, offset),
                           caches, prefill_offset=offset)
    return _last_real(params, cfg, x, batch["lengths"]), caches


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def make_caches(cfg: LMConfig, batch: int, max_len: int,
                device: Any = None) -> Dict[str, Any]:
    """Decode/prefill caches, bfloat16 zeros on ``device`` (``None`` means
    the card): ``{"kv": {"k", "v"}}`` (L, B, T, K, D) for dense and moe;
    for vlm ``{"units": {"kv": (nu, k, B, T, K, D), "cross": (nu, B,
    n_image_tokens, K, D)}}``."""
    _served_only(cfg, "make_caches")
    device = resolve_device(device)
    if cfg.family != "vlm":
        return {"kv": attn_lib.make_kv_cache(cfg, batch, max_len,
                                             cfg.n_layers,
                                             dtype=torch.bfloat16,
                                             device=device)}
    nu, k = n_units(cfg), cfg.cross_attn_every
    kv = (nu, k, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cross = (nu, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {"units": {
        "kv": {n: torch.zeros(kv, dtype=torch.bfloat16, device=device)
               for n in ("k", "v")},
        "cross": {n: torch.zeros(cross, dtype=torch.bfloat16, device=device)
                  for n in ("k", "v")}}}


def cache_specs(cfg: LMConfig) -> Dict[str, Any]:
    """Logical-axis tree matching :func:`make_caches`."""
    _served_only(cfg, "cache_specs")
    if cfg.family != "vlm":
        axes = ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim")
        return {"kv": {"k": axes, "v": axes}}
    kv = ("layers", None, "batch", "kv_seq", "kv_heads", "kv_head_dim")
    cross = ("layers", "batch", None, "kv_heads", "kv_head_dim")
    return {"units": {"kv": {"k": kv, "v": kv},
                      "cross": {"k": cross, "v": cross}}}


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
