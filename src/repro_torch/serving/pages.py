"""Block-paged KV cache: global page pool, per-slot page tables, prefix
reuse, and quantized pages.

The dense serving cache (``lm.make_caches``) gives every slot a full
``max_len`` KV allocation, so resident-request capacity is bounded by slot
count and shared system prompts re-prefill per request.  This module
replaces that layout with the paged one:

  * **Page pool** — every cache leaf whose :func:`lm.cache_specs` axes
    contain both ``batch`` and ``kv_seq`` is re-shaped so the slot axis
    becomes a *page* axis (``n_pages``) and the sequence axis becomes the
    *within-page* axis (``page_size``): for dense and moe the pool
    leaves are (L, n_pages, page, K, D), for vlm's self-attention
    (nu, k, n_pages, page, K, D).  Leaves without a ``kv_seq`` axis stay
    dense slot-axis "residual" state: vlm's cross-attention cache (nu, B,
    n_image_tokens, K, D); dense and moe have none.  The recurrent
    families (ssm, hybrid) are not pageable, as in the reference: their
    state has no ``kv_seq`` axis, so :class:`PagePool` refuses them (and
    audio, which has no cache).
  * **Page tables** — host-side ``(n_slots, max_len // page_size)`` int32
    maps from slot-local page index to pool page id (``-1`` = unmapped).
    The device ops below take a copy of them per tick.
  * **Device ops** — :meth:`PagePool.build_view` gathers a dense
    ``(n_slots, max_len)`` cache view for ``lm.decode_step``,
    :meth:`PagePool.scatter_decode_rows` writes one decoded row per slot
    back through the table, :meth:`PagePool.write_prefill_pages` scatters
    freshly prefilled rows at page granularity, and
    :meth:`PagePool.make_continuation_caches` materialises a dequantized
    shared-prefix cache for :func:`lm.continuation_prefill_step`.  They are
    functions of ``(pool tensors, tables)`` and init-time metadata; where
    the reference returns new arrays, the ops that write
    (``scatter_decode_rows``, ``write_prefill_pages``, ``import_pages``,
    ``scatter_residual_rows``) update the pool tensors **in place** and
    return the same dict.
  * **Content-addressed prefix index** — full prompt pages hash as a chain
    (``h_j = sha256(h_{j-1} || tokens_j)`` seeded with the model arch, page
    size and quantization flag; the bytes are the reference's), registered
    pages are never written again (decode writes land past the prompt, in
    privately owned pages), and a later request whose chain prefix matches
    pins the shared pages and prefills only its suffix.
  * **Quantized pages** — with ``quantize=True`` the KV pools hold int8
    with a float32 scale pool beside each (``k`` -> ``k_scale``, amax/127
    per (page, position) over heads x head_dim —
    ``attention.quantize_kv_rows``).  Prefill computes in the model's type
    and quantizes at the page write; decode reads the int8 pages and
    dequantizes on read.

Lifecycle: a page is *free*, *owned* (refcount > 0; each resident or
preempted request holds one reference per page in its table), or *cached*
(refcount 0 but still registered in the prefix index — evictable in LRU
order when the free list runs dry).  Lossless preemption is a table-row
save (pages stay owned, no device traffic); :meth:`PagePool.export_pages`
/ :meth:`PagePool.import_pages` move page payloads for a host spill.

Thread-safety: all host state is guarded by the pool's own lock (see the
``guarded-by`` annotations).
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models import lm

PAGEABLE_FAMILIES = ("dense", "moe", "vlm")


class PagePoolExhausted(RuntimeError):
    """No free or evictable page is left.  Raised by
    :meth:`PagePool.allocate`; the serving engine responds by spilling
    preempted requests' pages to host memory and retrying, so the error
    only propagates when *resident* demand genuinely exceeds the pool."""


@dataclasses.dataclass(frozen=True)
class _PagedLeaf:
    """Init-time metadata for one paged pool leaf (KV or scale)."""

    path: Tuple[str, ...]             # path in the make_caches tree
    key: str                          # "/".join(path): flat pool-dict key
    axes: Tuple[Optional[str], ...]   # logical axes (pool == view names)
    bax: int                          # batch/page axis position
    sax: int                          # kv_seq/within-page axis position
    shape: Tuple[int, ...]            # pool tensor shape
    dtype: torch.dtype                # pool type (int8 when quantized)
    view_dtype: torch.dtype           # dense-view type (the model's)
    scale_key: Optional[str] = None   # sibling scale leaf (KV leaves only)
    scale_path: Optional[Tuple[str, ...]] = None
    scale_shape: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class _ResidualLeaf:
    """A cache leaf that stays dense slot-axis (no ``kv_seq`` axis)."""

    path: Tuple[str, ...]
    key: str
    axes: Tuple[Optional[str], ...]
    bax: int                          # batch (slot) axis position
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _walk(tree: Any, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _get(tree: Any, path: Sequence[str]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _set(tree: Dict[str, Any], path: Sequence[str], val: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = val


def _index(x: Any, device: torch.device) -> torch.Tensor:
    """A table, page map or position vector as an int64 tensor."""
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x)).to(
        device=device, dtype=torch.int64)


def _host(x: Any) -> np.ndarray:
    """An index map read on the host, as int64."""
    return np.asarray(x.cpu() if torch.is_tensor(x) else x, np.int64)


class PagePool:
    """Global page pool + per-slot page tables for one serving engine.

    Splits into two halves that never mix:

      * *device* ops (``build_view`` / ``scatter_decode_rows`` /
        ``write_prefill_pages`` / ``make_continuation_caches`` /
        ``export_pages`` / ``import_pages`` and the residual-row helpers)
        — functions of explicit tensor arguments plus init-time metadata;
      * host *bookkeeping* (allocation, refcounts, the prefix index, page
        tables) — all under ``self._lock``.

    The engine owns the pool and residual tensors and calls back here for
    both halves.
    """

    def __init__(self, cfg, n_slots: int, max_len: int, page_size: int,
                 n_pages: Optional[int] = None, quantize: bool = False):
        if cfg.family not in PAGEABLE_FAMILIES:
            raise ValueError(
                f"paged KV cache requires an attention family "
                f"{PAGEABLE_FAMILIES}, not {cfg.family!r} (recurrent "
                f"state has no kv_seq axis to page)")
        if page_size <= 0 or max_len % page_size != 0:
            raise ValueError(f"page_size={page_size} must be positive and "
                             f"divide max_len={max_len}")
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = max_len // page_size
        self.n_pages = int(n_pages) if n_pages is not None \
            else self.n_slots * self.pages_per_slot
        if self.n_pages < self.pages_per_slot:
            raise ValueError(
                f"n_pages={self.n_pages} cannot hold even one full slot "
                f"({self.pages_per_slot} pages)")
        self.quantize = bool(quantize)

        specs = lm.cache_specs(cfg)
        # shapes and types only: a cache on the meta device holds no memory
        structs = lm.make_caches(cfg, n_slots, max_len, device="meta")
        self._paged: List[_PagedLeaf] = []
        self._residual: List[_ResidualLeaf] = []
        for path, axes in _walk(specs):
            st = _get(structs, path)
            if "batch" in axes and "kv_seq" in axes:
                bax, sax = axes.index("batch"), axes.index("kv_seq")
                # every family's KV leaves have the kv_seq axis right after
                # the batch axis; the page gathers below rely on it
                if not (sax == bax + 1 and len(axes) == sax + 3):
                    raise ValueError(
                        f"unsupported paged leaf layout {axes} at "
                        f"{'/'.join(path)}")
                shape = list(st.shape)
                shape[bax], shape[sax] = self.n_pages, self.page_size
                kw: Dict[str, Any] = {}
                if self.quantize:
                    kw["scale_path"] = path[:-1] + (path[-1] + "_scale",)
                    kw["scale_key"] = "/".join(kw["scale_path"])
                    kw["scale_shape"] = tuple(shape[:sax + 1])
                self._paged.append(_PagedLeaf(
                    path=path, key="/".join(path), axes=tuple(axes),
                    bax=bax, sax=sax, shape=tuple(shape),
                    dtype=torch.int8 if self.quantize else st.dtype,
                    view_dtype=st.dtype, **kw))
            else:
                if "batch" not in axes:
                    raise ValueError(
                        f"cache leaf {'/'.join(path)} has neither a "
                        f"batch nor kv_seq axis; cannot page or slot it")
                self._residual.append(_ResidualLeaf(
                    path=path, key="/".join(path), axes=tuple(axes),
                    bax=axes.index("batch"), shape=tuple(st.shape),
                    dtype=st.dtype))
        if not self._paged:
            raise ValueError(f"{cfg.family} cache has no pageable leaves")

        # chain-hash seed: two pools agree on page hashes iff they agree on
        # the model, the page geometry, and the page representation
        self._hash_seed = hashlib.sha256(
            f"{cfg.arch_id}|{self.page_size}|{int(self.quantize)}"
            .encode()).digest()

        self._lock = threading.Lock()
        self._free: List[int] = list(       # guarded-by: _lock
            range(self.n_pages))
        self._refs = np.zeros(              # guarded-by: _lock
            (self.n_pages,), np.int32)
        self._prefix_index: Dict[bytes, int] = {}   # guarded-by: _lock
        self._page_hash: Dict[int, bytes] = {}      # guarded-by: _lock
        self._evictable: "OrderedDict[int, None]" \
            = OrderedDict()                 # guarded-by: _lock
        self._tables = np.full(             # guarded-by: _lock
            (self.n_slots, self.pages_per_slot), -1, np.int32)
        self._counters: Dict[str, int] = {  # guarded-by: _lock
            "allocated": 0, "freed": 0, "cache_evicted": 0,
            "registered": 0, "pinned": 0}
        self._n_blocks = 1                  # guarded-by: _lock

    # -- geometry / tensor construction (no host state) --------------------

    def init_pool_arrays(self, device: Any = None) -> Dict[str, torch.Tensor]:
        """Zeroed pool tensors on ``device`` (``None`` means the card), one
        flat dict entry per paged leaf (plus its scale sibling when
        quantized)."""
        device = resolve_device(device)
        out: Dict[str, torch.Tensor] = {}
        for lf in self._paged:
            out[lf.key] = torch.zeros(lf.shape, dtype=lf.dtype, device=device)
            if lf.scale_key is not None:
                out[lf.scale_key] = torch.zeros(lf.scale_shape,
                                                dtype=torch.float32,
                                                device=device)
        return out

    def init_residual_arrays(self, device: Any = None
                             ) -> Dict[str, torch.Tensor]:
        """Zeroed dense slot-axis tensors for the non-paged leaves."""
        device = resolve_device(device)
        return {rl.key: torch.zeros(rl.shape, dtype=rl.dtype, device=device)
                for rl in self._residual}

    def pool_specs(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Logical-axis dict matching :meth:`init_pool_arrays`; the page
        axis keeps the name ``batch``."""
        out: Dict[str, Tuple[Optional[str], ...]] = {}
        for lf in self._paged:
            out[lf.key] = lf.axes
            if lf.scale_key is not None:
                out[lf.scale_key] = lf.axes[:lf.sax + 1]
        return out

    def residual_specs(self) -> Dict[str, Tuple[Optional[str], ...]]:
        return {rl.key: rl.axes for rl in self._residual}

    def _all_paged(self) -> List[Tuple[str, Tuple[str, ...], int, int]]:
        """(key, view path, bax, sax) for every pool leaf, scales included
        — the leaves the gathers and scatters iterate."""
        out = []
        for lf in self._paged:
            out.append((lf.key, lf.path, lf.bax, lf.sax))
            if lf.scale_key is not None:
                out.append((lf.scale_key, lf.scale_path, lf.bax, lf.sax))
        return out

    def page_payload_struct(self, n: int
                            ) -> Dict[str, Tuple[Tuple[int, ...],
                                                 torch.dtype]]:
        """``{key: (shape, dtype)}`` of an :meth:`export_pages` payload of
        ``n`` pages (page axis leading)."""
        out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        for lf in self._paged:
            rest = [s for i, s in enumerate(lf.shape) if i != lf.bax]
            out[lf.key] = ((n,) + tuple(rest), lf.dtype)
            if lf.scale_key is not None:
                srest = [s for i, s in enumerate(lf.scale_shape)
                         if i != lf.bax]
                out[lf.scale_key] = ((n,) + tuple(srest), torch.float32)
        return out

    # -- device ops ---------------------------------------------------------

    def _gather_pages(self, arr: torch.Tensor, tv: torch.Tensor, bax: int,
                      sax: int) -> torch.Tensor:
        """Gather table rows ``tv`` (B, P) of pool leaf ``arr`` into a dense,
        contiguous (B, P * page_size) sequence at the leaf's own axis
        positions (``sax == bax + 1``), as the kernels read it.  ``tv``
        must be clipped to valid page ids already."""
        g = torch.index_select(arr, bax, tv.reshape(-1))
        return g.reshape(tuple(arr.shape[:bax])
                         + (tv.shape[0], tv.shape[1] * self.page_size)
                         + tuple(arr.shape[sax + 1:]))

    def _clipped(self, tables: Any, device: torch.device) -> torch.Tensor:
        return _index(tables, device).clamp(0, self.n_pages - 1)

    def build_view(self, pool: Dict[str, torch.Tensor],
                   residual: Dict[str, torch.Tensor], tables: Any,
                   dequant: bool = False) -> Dict[str, Any]:
        """Assemble the dense ``(n_slots, max_len)`` cache-view tree
        ``lm.decode_step`` consumes (copies of the pages).  Unmapped table
        entries clip to page 0: their rows are garbage that the attention's
        ``kv_valid_len`` masks.  With ``dequant=True`` a quantized pool
        yields a view in the model's cache type without scale leaves; by
        default the int8 + scale leaves pass through for dequant-on-read
        in the attention."""
        tv = self._clipped(tables, next(iter(pool.values())).device)
        view: Dict[str, Any] = {}
        for lf in self._paged:
            g = self._gather_pages(pool[lf.key], tv, lf.bax, lf.sax)
            if lf.scale_key is not None:
                gs = self._gather_pages(pool[lf.scale_key], tv, lf.bax,
                                        lf.sax)
                if dequant:
                    g = attention.dequantize_kv(g, gs, lf.view_dtype)
                else:
                    _set(view, lf.scale_path, gs)
            _set(view, lf.path, g)
        for rl in self._residual:
            _set(view, rl.path, residual[rl.key])
        return view

    def pool_tree(self, pool: Dict[str, torch.Tensor],
                  residual: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        """The cache tree ``lm.decode_step`` consumes with the *pool*
        leaves passed through untouched (no gather).  With
        ``paged_tables``, the decode_attention kernel reads the pages
        through the per-slot tables and the fresh row is written straight
        into its page."""
        view: Dict[str, Any] = {}
        for lf in self._paged:
            _set(view, lf.path, pool[lf.key])
            if lf.scale_key is not None:
                _set(view, lf.scale_path, pool[lf.scale_key])
        for rl in self._residual:
            _set(view, rl.path, residual[rl.key])
        return view

    def pool_untree(self, tree: Dict[str, Any]
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
        """Inverse of :meth:`pool_tree`: split a cache tree back into the
        flat (pool, residual) dicts."""
        pool: Dict[str, torch.Tensor] = {}
        for lf in self._paged:
            pool[lf.key] = _get(tree, lf.path)
            if lf.scale_key is not None:
                pool[lf.scale_key] = _get(tree, lf.scale_path)
        residual = {rl.key: _get(tree, rl.path) for rl in self._residual}
        return pool, residual

    def scatter_decode_rows(self, pool: Dict[str, torch.Tensor],
                            new_view: Dict[str, Any], tables: Any,
                            pos: Any) -> Dict[str, torch.Tensor]:
        """Write each slot's decoded row (position ``pos[b]``) from the
        updated view back into its mapped page, in place.  Slots whose
        page is unmapped (table ``-1`` — idle slots) drop their write."""
        dev = next(iter(pool.values())).device
        tables = _index(tables, dev)
        pos = _index(pos, dev)
        b = tables.shape[0]
        pid, off, ok = attention.page_slot(tables, pos, self.page_size)
        at = (pid.clamp(0, self.n_pages - 1), off)
        rows_at = (torch.arange(b, device=dev),
                   pos.clamp(0, self.max_len - 1))
        for key, path, bax, sax in self._all_paged():
            vm = torch.movedim(_get(new_view, path), (bax, sax), (0, 1))
            pm = torch.movedim(pool[key], (bax, sax), (0, 1))
            attention.put_rows(pm, at, ok, vm[rows_at])
        return pool

    def write_prefill_pages(self, pool: Dict[str, torch.Tensor],
                            sub_caches: Dict[str, Any], page_map: Any,
                            off: int) -> Dict[str, torch.Tensor]:
        """Scatter freshly prefilled rows into the pool at page granularity,
        in place.  ``sub_caches`` is the cache tree a prefill step just
        wrote (kv_seq length >= ``off + npg * page_size``); ``page_map``
        (nb, npg) maps each batch row's page-aligned span starting at
        ``off`` to pool page ids, with the sentinel ``n_pages`` marking pad
        rows and unallocated tail pages (dropped; the map is read on the
        host).  Quantized pools quantize per row here — the one place
        prefilled state crosses into int8."""
        pmap = _host(page_map)
        nb, npg = pmap.shape
        ps = self.page_size
        flat = pmap.reshape(-1)
        keep = np.nonzero((flat >= 0) & (flat < self.n_pages))[0]
        dev = next(iter(pool.values())).device
        sel = torch.from_numpy(keep).to(dev)
        dst = torch.from_numpy(flat[keep]).to(dev)
        for lf in self._paged:
            sm = torch.movedim(_get(sub_caches, lf.path), (lf.bax, lf.sax),
                               (0, 1))
            span = sm[:, off:off + npg * ps]
            rows = span.reshape((nb * npg, ps) + tuple(sm.shape[2:]))[sel]
            pm = torch.movedim(pool[lf.key], (lf.bax, lf.sax), (0, 1))
            if lf.scale_key is not None:
                q, sc = attention.quantize_kv_rows(rows)
                pm[dst] = q
                sp = torch.movedim(pool[lf.scale_key], (lf.bax, lf.sax),
                                   (0, 1))
                sp[dst] = sc
            else:
                pm[dst] = rows.to(pm.dtype)
        return pool

    def make_continuation_caches(self, pool: Dict[str, torch.Tensor],
                                 prefix_tables: Any, nb: int,
                                 total_len: int) -> Dict[str, Any]:
        """A fresh ``lm.make_caches(cfg, nb, total_len)`` tree whose first
        ``prefix_tables.shape[1] * page_size`` rows hold the (dequantized)
        shared-prefix pages — the cache :func:`lm.continuation_prefill_step`
        continues from."""
        dev = next(iter(pool.values())).device
        tv = self._clipped(prefix_tables, dev)
        off = tv.shape[1] * self.page_size
        fresh = lm.make_caches(self.cfg, nb, total_len, device=dev)
        out: Dict[str, Any] = {}
        for lf in self._paged:
            g = self._gather_pages(pool[lf.key], tv, lf.bax, lf.sax)
            if lf.scale_key is not None:
                gs = self._gather_pages(pool[lf.scale_key], tv, lf.bax,
                                        lf.sax)
                g = attention.dequantize_kv(g, gs, lf.view_dtype)
            base = _get(fresh, lf.path)
            bm = torch.movedim(base, (lf.bax, lf.sax), (0, 1))
            bm[:, :off] = torch.movedim(g, (lf.bax, lf.sax),
                                        (0, 1)).to(base.dtype)
            _set(out, lf.path, base)
        for rl in self._residual:
            # serving prompts carry no image features: the residual (vlm
            # cross) cache is zeros
            _set(out, rl.path, _get(fresh, rl.path))
        return out

    def residual_rows_from(self, sub_caches: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
        """Flat residual-leaf dict extracted from a full cache tree."""
        return {rl.key: _get(sub_caches, rl.path) for rl in self._residual}

    def gather_residual_rows(self, residual: Dict[str, torch.Tensor],
                             slot_idx: Any) -> Dict[str, torch.Tensor]:
        return {rl.key: torch.index_select(
                    residual[rl.key], rl.bax,
                    _index(slot_idx, residual[rl.key].device))
                for rl in self._residual}

    def concat_residual_rows(self, rows_list: Sequence[Dict[str, Any]]
                             ) -> Dict[str, torch.Tensor]:
        """Concatenate per-slot residual-row dicts along the slot axis."""
        return {rl.key: torch.cat([torch.as_tensor(r[rl.key])
                                   for r in rows_list], dim=rl.bax)
                for rl in self._residual}

    def residual_rows_struct(self, n: int
                             ) -> Dict[str, Tuple[Tuple[int, ...],
                                                  torch.dtype]]:
        """``{key: (shape, dtype)}`` of the residual rows of ``n`` slots."""
        out = {}
        for rl in self._residual:
            shape = list(rl.shape)
            shape[rl.bax] = n
            out[rl.key] = (tuple(shape), rl.dtype)
        return out

    def scatter_residual_rows(self, residual: Dict[str, torch.Tensor],
                              rows: Dict[str, torch.Tensor],
                              slot_idx: Any) -> Dict[str, torch.Tensor]:
        """Write per-slot residual rows in place; out-of-range
        ``slot_idx`` (pad entries = ``n_slots``) drop (read on the
        host)."""
        idx = _host(slot_idx)
        keep = np.nonzero((idx >= 0) & (idx < self.n_slots))[0]
        for rl in self._residual:
            dev = residual[rl.key].device
            src = torch.index_select(rows[rl.key], rl.bax,
                                     torch.from_numpy(keep).to(dev))
            residual[rl.key].index_copy_(
                rl.bax, torch.from_numpy(idx[keep]).to(dev),
                src.to(residual[rl.key].dtype))
        return residual

    def export_pages(self, pool: Dict[str, torch.Tensor],
                     page_ids: Sequence[int]) -> Dict[str, torch.Tensor]:
        """Copy the given pages out (page axis leading per leaf) — the
        payload of a handoff or a preemption spill."""
        out = {}
        for key, _, bax, _ in self._all_paged():
            ids = _index(list(page_ids), pool[key].device)
            out[key] = torch.movedim(pool[key], bax, 0)[ids]
        return out

    def import_pages(self, pool: Dict[str, torch.Tensor],
                     payload: Dict[str, Any], page_ids: Sequence[int]
                     ) -> Dict[str, torch.Tensor]:
        """Write an :meth:`export_pages` payload into the given pages, in
        place."""
        for key, _, bax, _ in self._all_paged():
            pm = torch.movedim(pool[key], bax, 0)
            pm[_index(list(page_ids), pm.device)] = torch.as_tensor(
                payload[key]).to(device=pm.device, dtype=pm.dtype)
        return pool

    @staticmethod
    def take_payload(payload: Dict[str, Any], idx: Sequence[int]
                     ) -> Dict[str, torch.Tensor]:
        """Subset an :meth:`export_pages` payload by page position — how a
        handoff sheds pages its target already holds."""
        out = {}
        for k, v in payload.items():
            v = torch.as_tensor(v)
            out[k] = v[_index(list(idx), v.device)]
        return out

    # -- content-addressed prefix hashing (pure) ---------------------------

    def chain_hashes(self, prompt: Sequence[int]) -> List[bytes]:
        """Chained page hashes of the prompt's *full* pages, capped so at
        least one suffix token always remains to prefill (the request must
        still produce its own first-token logits)."""
        n = (len(prompt) - 1) // self.page_size
        out: List[bytes] = []
        h = self._hash_seed
        for j in range(n):
            m = hashlib.sha256(h)
            m.update(np.asarray(
                prompt[j * self.page_size:(j + 1) * self.page_size],
                np.int64).tobytes())
            h = m.digest()
            out.append(h)
        return out

    # -- host bookkeeping (guarded) ----------------------------------------

    @property
    def free_pages(self) -> int:
        """Pages allocatable right now (free + evictable cached)."""
        with self._lock:
            return len(self._free) + len(self._evictable)

    @property
    def total_pages(self) -> int:
        return self.n_pages

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def set_device_blocks(self, n: int) -> None:
        """Partition pages into ``n`` contiguous blocks matching a sharded
        page-axis layout; allocation then prefers a slot's own block."""
        with self._lock:
            self._n_blocks = max(1, int(n))

    def _block_of_locked(self, page: int) -> int:
        return page * self._n_blocks // self.n_pages

    def _slot_block_locked(self, slot: int) -> int:
        return slot * self._n_blocks // self.n_slots

    def _take_one_locked(self, block: int) -> int:
        if self._free:
            if self._n_blocks > 1:
                for i, p in enumerate(self._free):
                    if self._block_of_locked(p) == block:
                        return self._free.pop(i)
            return self._free.pop()
        if self._evictable:
            pick = None
            if self._n_blocks > 1:
                for p in self._evictable:
                    if self._block_of_locked(p) == block:
                        pick = p
                        break
            if pick is None:
                pick = next(iter(self._evictable))   # LRU head
            del self._evictable[pick]
            h = self._page_hash.pop(pick, None)
            if h is not None:
                self._prefix_index.pop(h, None)
            self._counters["cache_evicted"] += 1
            return pick
        raise PagePoolExhausted(
            f"page pool exhausted: {self.n_pages} pages all owned "
            f"(resident + preempted demand exceeds the pool; raise "
            f"n_pages or admit less)")

    def allocate(self, n: int, slot: int = 0) -> List[int]:
        """Take ``n`` pages (refcount 1 each), evicting cached pages LRU
        when the free list is dry.  Raises :class:`PagePoolExhausted`
        atomically — on failure nothing is taken."""
        with self._lock:
            block = self._slot_block_locked(slot % max(self.n_slots, 1))
            if n > len(self._free) + len(self._evictable):
                raise PagePoolExhausted(
                    f"page pool exhausted: need {n} pages, "
                    f"{len(self._free) + len(self._evictable)} available "
                    f"of {self.n_pages}")
            out = [self._take_one_locked(block) for _ in range(n)]
            for p in out:
                self._refs[p] = 1
            self._counters["allocated"] += n
            return out

    def retain(self, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                self._retain_one_locked(p)

    def _retain_one_locked(self, p: int) -> None:
        if self._refs[p] == 0:
            # cached -> owned again
            self._evictable.pop(p, None)
        self._refs[p] += 1

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page.  A page reaching refcount 0 stays
        *cached* (evictable, still a prefix-index hit) when it is
        registered, else returns to the free list."""
        with self._lock:
            for p in pages:
                if self._refs[p] <= 0:
                    raise ValueError(f"release of unowned page {p}")
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    if p in self._page_hash:
                        self._evictable[p] = None
                        self._evictable.move_to_end(p)
                    else:
                        self._free.append(p)
                    self._counters["freed"] += 1

    def register_hash(self, page: int, h: bytes) -> None:
        """Publish a full, never-again-written page into the prefix index.
        First writer wins; a duplicate hash keeps the existing entry (the
        new page simply stays private)."""
        with self._lock:
            if h in self._prefix_index or page in self._page_hash:
                return
            self._prefix_index[h] = page
            self._page_hash[page] = h
            self._counters["registered"] += 1

    def acquire_prefix(self, hashes: Sequence[bytes]) -> List[int]:
        """Pin the longest indexed chain prefix; returns the pinned page ids
        (one reference each, in page order)."""
        return self.extend_prefix(hashes, 0)

    def extend_prefix(self, hashes: Sequence[bytes], start: int
                      ) -> List[int]:
        """Continue :meth:`acquire_prefix` from chain position ``start`` —
        used when a same-tick sibling registered more pages since the first
        lookup."""
        with self._lock:
            out: List[int] = []
            for h in hashes[start:] if start else hashes:
                p = self._prefix_index.get(h)
                if p is None:
                    break
                self._retain_one_locked(p)
                self._counters["pinned"] += 1
                out.append(p)
            return out

    def pin_hashes(self, hashes: Sequence[Optional[bytes]]
                   ) -> Dict[int, int]:
        """Pin every individually indexed hash (no chain-prefix rule):
        ``{position: page}`` for the hits, each retained.  A caller that
        does not use them must :meth:`release` the returned pages."""
        with self._lock:
            out: Dict[int, int] = {}
            for i, h in enumerate(hashes):
                if h is None:
                    continue
                p = self._prefix_index.get(h)
                if p is None:
                    continue
                self._retain_one_locked(p)
                self._counters["pinned"] += 1
                out[i] = p
            return out

    # -- page tables (guarded) ---------------------------------------------

    def bind_slot(self, slot: int, pages: Sequence[int]) -> None:
        """Map a slot's table row to ``pages`` (slot-local order,
        contiguous from page index 0); the rest unmapped."""
        if len(pages) > self.pages_per_slot:
            raise ValueError(f"{len(pages)} pages exceed the "
                             f"{self.pages_per_slot}-page slot table")
        with self._lock:
            self._tables[slot, :] = -1
            self._tables[slot, :len(pages)] = np.asarray(pages, np.int32) \
                if pages else np.empty((0,), np.int32)

    def set_slot_page(self, slot: int, idx: int, page: int) -> None:
        with self._lock:
            self._tables[slot, idx] = page

    def page_at(self, slot: int, idx: int) -> int:
        with self._lock:
            return int(self._tables[slot, idx])

    def slot_pages(self, slot: int) -> List[int]:
        """The slot's mapped pages in slot-local order."""
        with self._lock:
            row = self._tables[slot]
            return [int(p) for p in row[row >= 0]]

    def slot_page_hashes(self, slot: int) -> List[Optional[bytes]]:
        """Per mapped page, its prefix-index hash (None for private
        pages)."""
        with self._lock:
            row = self._tables[slot]
            return [self._page_hash.get(int(p)) for p in row[row >= 0]]

    def unbind_slot(self, slot: int) -> List[int]:
        """Clear the slot's table row, returning its pages *without*
        releasing them (preemption keeps ownership; retirement follows
        with :meth:`release`)."""
        with self._lock:
            row = self._tables[slot]
            pages = [int(p) for p in row[row >= 0]]
            self._tables[slot, :] = -1
            return pages

    def tables_snapshot(self) -> np.ndarray:
        with self._lock:
            return self._tables.copy()
