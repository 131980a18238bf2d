"""LM assembly, every family of the reference: stacked units, the forward,
prefill and decode steps, and the slot-axis cache row movement serving
needs.

Parameters keep the reference's layout so they convert leaf by leaf:
``{"embed": {...}, "final_ln": {...}, "units": {...}}`` (plus
``"shared"``, the hybrid's one shared attention block), every unit leaf
stacked on a leading ``n_units`` axis.  A unit is one transformer block
(``{"block": ...}``) for dense, moe and audio (an encoder: bidirectional
attention, no cache); for hybrid one Mamba-2 block
(``{"block": {"ln", "mixer"}}``, ``repro_torch.models.mamba2``), after
every ``hybrid_attn_every``-th of which the shared block runs; for ssm a
group of ``slstm_every - 1`` mLSTM blocks and one sLSTM block
(``{"mlstm": [...], "slstm": ...}``, ``repro_torch.models.xlstm``); for
vlm a group of ``cross_attn_every`` self-attention blocks and one
cross-attention block (``{"selfs": [...], "cross": ...}``).  Lists sit in
the tree where the reference has them.  ``forward`` loops over the stacked
units in Python where the reference scans them; sharding constraints are
left out until the port shards.

Caches are updated **in place** by the steps (the reference returns new
trees; the steps here return the same dict they were given).  KV leaves
are bfloat16, recurrent state float32, as the reference makes them:
``{"kv": {"k", "v"}}`` of shape (L, B, T, K, D) for dense and moe; for
vlm ``{"units": {"kv": {"k", "v"} (nu, k, B, T, K, D), "cross": {"k", "v"}
(nu, B, n_image_tokens, K, D)}}``; for hybrid ``{"mamba": {"ssm" (L, B, H,
P, N), "conv" (L, B, K-1, C)}, "shared_kv": {"k", "v"} (n_sites, B, T, K,
D)}``; for ssm ``{"units": {"mlstm": {"c", "n", "m", "conv"} (nu, k-1, B,
...), "slstm": {"c", "n", "m", "h"} (nu, B, H, hd)}}``; audio has none
(``make_caches`` returns None).  A ``"kv"`` dict may also carry
``k_scale`` / ``v_scale`` leaves (an int8 cache), and with ``paged_tables``
(dense and moe) its leaves are the page pool's (L, n_pages, page, K, D)
(``repro_torch.serving.pages``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import (LMConfig, ParamDef, init_params,
                                       init_stacked, tree_leaves)

NORM_KEYS = ("ln", "ln1", "ln2", "final_ln")
# kept in the parameter type: the reference reads these leaves in float32
# at each use.  The router computes its logits from the parameter (a
# bfloat16 copy would move the top-k); the recurrent blocks' gates, decay
# and skip terms and their inner norms compound over every step, so a
# bfloat16 copy would move the state.
FLOAT32_KEYS = ("router", "router_b",                      # moe
                "a_log", "dt_bias", "d_skip",              # mamba2
                "w_gates", "b_gates", "r_gates",           # m/sLSTM gates
                "norm_scale")                              # the blocks' norms
# every family of the reference; audio (an encoder) runs through
# ``forward`` only: it has no cache, so no prefill or decode step serves it
SERVED_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
RECURRENT_FAMILIES = ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Parameter definitions and init
# ---------------------------------------------------------------------------


def _block_defs(cfg: LMConfig, kind: str) -> Dict[str, Any]:
    """One block (kind: self | cross | mamba | mlstm | slstm)."""
    mixers = {"mamba": mamba_lib.mamba2_defs, "mlstm": xlstm_lib.mlstm_defs,
              "slstm": xlstm_lib.slstm_defs}
    if kind in mixers:
        return {"ln": common.norm_defs(cfg), "mixer": mixers[kind](cfg)}
    if kind not in ("self", "cross"):
        raise ValueError(f"unknown block kind {kind!r}")
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
    fam = cfg.family
    if fam in ("dense", "moe", "audio"):
        return {"block": _block_defs(cfg, "self")}
    if fam == "hybrid":
        return {"block": _block_defs(cfg, "mamba")}
    if fam == "ssm":
        return {"mlstm": [_block_defs(cfg, "mlstm")
                          for _ in range(xlstm_lib.slstm_every(cfg) - 1)],
                "slstm": _block_defs(cfg, "slstm")}
    if fam == "vlm":
        return {"selfs": [_block_defs(cfg, "self")
                          for _ in range(cfg.cross_attn_every)],
                "cross": _block_defs(cfg, "cross")}
    raise ValueError(f"unknown family {fam!r}")


def _groups(cfg: LMConfig, k: int) -> int:
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.family}: n_layers={cfg.n_layers} is no "
                         f"multiple of the unit's {k} layers")
    return cfg.n_layers // k


def n_units(cfg: LMConfig) -> int:
    fam = cfg.family
    if fam in ("dense", "moe", "audio", "hybrid"):
        return cfg.n_layers
    if fam == "ssm":
        return _groups(cfg, xlstm_lib.slstm_every(cfg))
    if fam == "vlm":
        return _groups(cfg, cfg.cross_attn_every + 1)
    raise ValueError(f"unknown family {fam!r}")


def hybrid_sites(cfg: LMConfig) -> List[int]:
    """The hybrid layers after which the shared block runs (layer i with
    ``i % hybrid_attn_every == hybrid_attn_every - 1``); the shared KV of
    the j-th of them is site j."""
    k = cfg.hybrid_attn_every
    return [i for i in range(cfg.n_layers) if i % k == k - 1]


def model_defs(cfg: LMConfig) -> Dict[str, Any]:
    defs: Dict[str, Any] = {"embed": common.embedding_defs(cfg)}
    if cfg.cross_attn_every:
        defs["embed"]["img_proj"] = ParamDef(
            (cfg.d_model, cfg.d_model), ("embed", "embed_tp"),
            common.fanin_init())
    defs["final_ln"] = common.norm_defs(cfg)
    if cfg.family == "hybrid":
        defs["shared"] = _block_defs(cfg, "self")   # zamba2's shared block
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
    reads them in float32), the leaves of ``FLOAT32_KEYS`` left in the
    parameter type (the reference reads them in float32 at each use), the
    float32 embedding table kept for the lookup and its compute-type copy
    added as ``tok_cd`` for the tied unembedding."""
    cd = cfg.cdtype()

    def cast(tree, path):
        if isinstance(tree, dict):
            return {k: cast(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, path) for v in tree]
        if (any(p in NORM_KEYS for p in path) or path[-1] == "tok"
                or path[-1] in FLOAT32_KEYS):
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


def _store(views: Optional[Dict[str, torch.Tensor]],
           new: Optional[Dict[str, torch.Tensor]]) -> None:
    """Write a recurrent block's new state into its cache views, each leaf
    in its own type (the state leaves are float32)."""
    if views is not None:
        for name, leaf in views.items():
            leaf.copy_(new[name])


def _ssm_units(params, cfg: LMConfig, x, caches):
    """The ssm stack: per unit ``slstm_every - 1`` mLSTM blocks and one
    sLSTM block, each a pre-norm residual."""
    cu = None if caches is None else caches["units"]
    for u in range(n_units(cfg)):
        p = layer_params(params, u)
        for i, pi in enumerate(p["mlstm"]):
            st = None if cu is None else _slice(cu["mlstm"], u, i)
            y, new = xlstm_lib.mlstm_apply(
                pi["mixer"], cfg, common.apply_norm(pi["ln"], x, cfg), st)
            _store(st, new)
            x = x + y
        st = None if cu is None else _slice(cu["slstm"], u)
        ps = p["slstm"]
        y, new = xlstm_lib.slstm_apply(
            ps["mixer"], cfg, common.apply_norm(ps["ln"], x, cfg), st)
        _store(st, new)
        x = x + y
    return x


def _hybrid_layers(params, cfg: LMConfig, x, positions, caches, cache_index):
    """zamba2: the Mamba-2 stack, with the one shared attention block run
    after the layers of :func:`hybrid_sites`, its KV cache indexed by
    site."""
    sites = hybrid_sites(cfg)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)["block"]
        st = None if caches is None else _slice(caches["mamba"], i)
        y, new = mamba_lib.mamba2_apply(
            p["mixer"], cfg, common.apply_norm(p["ln"], x, cfg), st)
        _store(st, new)
        x = x + y
        if i in sites:
            kv = (None if caches is None
                  else _slice(caches["shared_kv"], sites.index(i)))
            x, _, _ = _apply_self_block(params["shared"], cfg, x, positions,
                                        kv, cache_index)
    return x


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
    tables.  audio takes ``features`` (B, S, d_model) where the others
    take ``tokens``, and no caches."""
    fam = cfg.family
    if paged_tables is not None and fam not in ("dense", "moe"):
        raise ValueError("paged_tables: dense / moe decode only")
    if prefill_offset and fam in RECURRENT_FAMILIES:
        raise ValueError("prefill_offset: attention families only")
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
    if fam == "vlm":
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
    elif fam == "ssm":
        x = _ssm_units(params, cfg, x, caches)
    elif fam == "hybrid":
        x = _hybrid_layers(params, cfg, x, positions, caches, cache_index)
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
    count.  Recurrent families (ssm, hybrid) fold a pad suffix into their
    state, which no mask takes out again: they are exact only for rows
    without one, so ``ServeEngine`` prefills them in groups of one exact
    length.  Returns the logits at each prompt's last real token; cache rows
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


def _state_leaves(shapes, lead: Tuple[int, ...], device) -> Dict[str, Any]:
    """Zero leaves of a recurrent block's state with ``lead`` axes in front
    (one per stacked layer axis)."""
    return {k: torch.zeros(lead + shape, dtype=dtype, device=device)
            for k, (shape, dtype) in shapes.items()}


def make_caches(cfg: LMConfig, batch: int, max_len: int,
                device: Any = None) -> Optional[Dict[str, Any]]:
    """Decode/prefill caches, zeros on ``device`` (``None`` means the card),
    the KV leaves bfloat16 and the recurrent state float32 (the module
    docstring lists the trees); None for audio, which has no decode."""
    device = resolve_device(device)
    fam = cfg.family

    def kv(n_layers: int) -> Dict[str, torch.Tensor]:
        return attn_lib.make_kv_cache(cfg, batch, max_len, n_layers,
                                      dtype=torch.bfloat16, device=device)

    if fam in ("dense", "moe"):
        return {"kv": kv(cfg.n_layers)}
    if fam == "audio":
        return None                                   # encoder: no decode
    if fam == "hybrid":
        return {"mamba": _state_leaves(
                    mamba_lib.mamba2_state_shapes(cfg, batch),
                    (cfg.n_layers,), device),
                "shared_kv": kv(len(hybrid_sites(cfg)))}
    nu = n_units(cfg)
    if fam == "ssm":
        k = xlstm_lib.slstm_every(cfg)
        return {"units": {
            "mlstm": _state_leaves(xlstm_lib.mlstm_state_shapes(cfg, batch),
                                   (nu, k - 1), device),
            "slstm": _state_leaves(xlstm_lib.slstm_state_shapes(cfg, batch),
                                   (nu,), device)}}
    k = cfg.cross_attn_every
    kv_shape = (nu, k, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cross = (nu, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {"units": {
        "kv": {n: torch.zeros(kv_shape, dtype=torch.bfloat16, device=device)
               for n in ("k", "v")},
        "cross": {n: torch.zeros(cross, dtype=torch.bfloat16, device=device)
                  for n in ("k", "v")}}}


def cache_nbytes(cfg: LMConfig, batch: int, max_len: int) -> int:
    """Bytes of :func:`make_caches`' tree, without allocating it."""
    return cache_row_nbytes(make_caches(cfg, batch, max_len, device="meta"))


def cache_specs(cfg: LMConfig) -> Optional[Dict[str, Any]]:
    """Logical-axis tree matching :func:`make_caches` (None for audio)."""
    fam = cfg.family
    axes = ("layers", "batch", "kv_seq", "kv_heads", "kv_head_dim")
    kv = {"k": axes, "v": axes}
    if fam in ("dense", "moe"):
        return {"kv": kv}
    if fam == "audio":
        return None
    if fam == "hybrid":
        return {"mamba": {k: ("layers",) + ax for k, ax in
                          mamba_lib.mamba2_state_specs().items()},
                "shared_kv": kv}
    if fam == "ssm":
        return {"units": {
            "mlstm": {k: ("layers", None) + ax for k, ax in
                      xlstm_lib.mlstm_state_specs().items()},
            "slstm": {k: ("layers",) + ax for k, ax in
                      xlstm_lib.slstm_state_specs().items()}}}
    if fam == "vlm":
        self_kv = ("layers", None, "batch", "kv_seq", "kv_heads",
                   "kv_head_dim")
        cross = ("layers", "batch", None, "kv_heads", "kv_head_dim")
        return {"units": {"kv": {"k": self_kv, "v": self_kv},
                          "cross": {"k": cross, "v": cross}}}
    raise ValueError(f"unknown family {fam!r}")


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
