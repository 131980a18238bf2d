"""Wrappers of the attention CUDA kernels and their plain PyTorch versions.

* :func:`flash_attention_cuda` (``csrc/flash_attention.cu``) replaces
  ``repro/kernels/attention/kernel.py`` ``flash_attention_pallas``: blocked
  GQA attention over q (B, S, H, D) and k, v (B, T, K, D), causal or not,
  with a static ``q_offset``, exact or Eq. 2 exp.  The tunable ``q_block``
  is the number of query positions a thread block holds (with all G heads
  of each, at most 64 rows).  It takes any number G of query heads per KV
  head: a group of more than 64 is dealt to the fewest equal chunks of at
  most 64 heads, a block each (:func:`flash_head_chunks`).
* :func:`flash_attention_dequant_cuda` (the same source, int8 K/V) replaces
  ``flash_attention_dequant_pallas``: the same attention over int8 K/V rows
  with one float32 scale per row.  No model path of either package calls
  it.

  ``flash_attention`` takes head dims :data:`HEAD_DIMS` (80 padded to 128
  in shared memory), the dequantizing one :data:`CACHE_HEAD_DIMS`.  Both
  take their body from q's type (:func:`flash_body`): bfloat16 q runs
  the ``tensor_core`` body (wgmma on bf16 operands with float32
  accumulation, the scale applied after the dot, p split into two bf16
  terms for PV; held at 1e-2 of the float32 oracle), float32 q the ``fma``
  body (float32 throughout; 2e-5).  ``<wrapper>.launches_by_body`` counts
  the launches per body.
* :func:`decode_attention_cuda` (``csrc/decode_attention.cu``) replaces
  ``decode_attention_pallas`` and its three siblings: one query token per
  slot against its cache rows below ``kv_valid_len``, over a dense cache
  (B, T, K, D) or the page pool's (n_pages, page, K, D) leaves read through
  per-slot ``tables`` (B, P), each in bfloat16 / float32 or int8 with
  per-row scales ``ks``, ``vs``.  The tunables are ``kv_splits``, the
  blocks of the cluster that serves one (slot, KV head), each owning a
  contiguous range of the slot's rows (:func:`decode_kv_splits` plans it),
  and ``threads``, the block size.  It takes any number G of query heads
  per KV head: a block holds at most 8 of them, and the heads of a larger
  group are dealt to chunks of at most 8, a block each
  (:func:`decode_group_chunks`).
  ``decode_attention_cuda.launches_by_body`` counts its launches per body:
  ``dense``, ``int8``, ``paged``, ``paged_int8``.

A wrapper runs its plain version (:func:`flash_attention_plain`,
:func:`flash_attention_dequant_plain`, :func:`decode_attention_plain`) only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Given meta tensors (a dry run, :mod:`repro_torch.launch.dryrun`) it checks
what the kernel would check, returns an empty output of the kernel's shape
and type on the meta device, and charges its kernel-table row's cost
(:mod:`repro_torch.launch.roofline`) to the active cost counter; it never
runs the plain version there (whose score matrix is not the kernel's
traffic).  A meta cache's valid lengths cannot be read, so decode on meta
counts every row of every slot as valid.
The plain versions compute the kernels' function in one pass instead of
tiles, in float32 as the FMA bodies do: q scaled in float32, the masked exp
of the chosen mode, ``acc / max(l, 1e-30)``.  In exact mode they agree with
the oracles of :mod:`repro_torch.kernels.attention.ref` to float32
rounding.
``<wrapper>.launches`` counts kernel launches.  The kernels have no
backward: each wrapper, given a tensor that needs a gradient with autograd
on, raises ``RuntimeError`` on every device (``build.refuse_grad``), as the
reference's Pallas kernels refuse ``jax.grad``; a model trains through
``attn_impl="chunked"`` or ``"reference"``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import approx_math
from repro_torch.kernels import build
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.kernels.limits import MAX_CLUSTER, MAX_DYNAMIC_SMEM

# flash_attention's head dims: 80 (hubert-xlarge, 1280 / 16) is padded to
# 128 columns in shared memory (csrc/flash_attention.cu says what it costs)
HEAD_DIMS = (16, 32, 64, 80, 128)
# the head dims of the kernels that read a cache (flash_attention_dequant,
# decode_attention): no model path gives them another
CACHE_HEAD_DIMS = (16, 32, 64, 128)
# The kernels' block geometry, which the registry needs to plan block sizes
# on hosts without the library: kFlashRows, kFlashKv, kFlashThreads,
# kTcThreads and the kDecode* constants of the sources (CPU tests hold them
# equal; the shared-memory and cluster limits are Hopper's, from
# repro_torch.kernels.limits).
FLASH_ROWS = 64                     # query rows (positions x heads) a block holds
FLASH_KV_TILE = 64                  # KV rows a flash block takes per step
FLASH_THREADS = {"fma": 256, "tensor_core": 128}   # a flash block, by body
DECODE_CHUNK_GROUP = 8              # query heads a decode block holds
DECODE_TILE = 32                    # cache rows per warp tile of the decode kernel
DECODE_STAGES = 2                   # tiles a decode warp keeps staged
DECODE_ROW_PAD = 16                 # bytes after each staged cache row
DECODE_MAX_SPLITS = MAX_CLUSTER     # blocks of a decode cluster
# cache rows a decode split is planned for at least: a staged tile for each
# stage of each of the default block's 8 warps
DECODE_SPLIT_ROWS = 8 * DECODE_STAGES * DECODE_TILE
DECODE_MAX_THREADS = 512
H100_SMS = 132                      # the SM count planned for off the card
_SOFTMAX_MODES = ("exact", "taylor")
_DTYPES = (torch.float32, torch.bfloat16)


def _exp(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "taylor":
        return approx_math.taylor_exp(x, range_reduce=True)
    return torch.exp(x)


def _check_mode(softmax_mode: str) -> None:
    if softmax_mode not in _SOFTMAX_MODES:
        raise ValueError(f"softmax_mode must be one of {_SOFTMAX_MODES}, got "
                         f"{softmax_mode!r}")


def _check_device(what: str, *tensors: torch.Tensor) -> str:
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {tensors[0].device}")
    for t in tensors[1:]:
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: tensors on {tensors[0].device} and "
                             f"{t.device}")
    return kind


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


FLASH_BODIES = ("tensor_core", "fma")


def flash_body(q_dtype: torch.dtype) -> str:
    """The flash kernels' body for a query of this type: ``tensor_core``
    for bfloat16, ``fma`` for float32 (``csrc/flash_attention.cu``)."""
    return "tensor_core" if q_dtype == torch.bfloat16 else "fma"


def _dtype_name(x: torch.Tensor) -> str:
    return "bfloat16" if x.dtype == torch.bfloat16 else "float32"


def _on_meta(name: str, out: torch.Tensor, case: dict) -> torch.Tensor:
    """A kernel call on the meta device: its row's cost to the active
    counter, ``out`` (empty) as its result; nothing is launched."""
    from repro_torch.launch import roofline

    roofline.add_kernel_cost(name, case)
    return out


def _check_aligned(what: str, *tensors: torch.Tensor) -> None:
    """The tensor-core body copies rows 16 bytes at a time (cp.async): its
    inputs must start on a 16-byte boundary (every allocation does; an odd
    storage offset does not)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the bfloat16 query's body needs q and "
                         f"the K/V rows 16-byte aligned")


def flash_head_chunks(group: int) -> int:
    """The blocks the ``group`` query heads of one KV head are dealt to, as
    ``flash_head_chunks`` in the source counts them: the fewest chunks that
    divide the group into at most ``FLASH_ROWS`` heads each (one up to
    64)."""
    g, c = max(1, int(group)), 1
    while g % c or g // c > FLASH_ROWS:
        c += 1
    return c


def flash_block_heads(group: int) -> int:
    """The query heads one flash block holds for a group of ``group``."""
    return max(1, int(group)) // flash_head_chunks(group)


def _check_q_block(q_block: int, g: int, what: str) -> int:
    q_block = int(q_block)
    gb = flash_block_heads(g)
    if q_block < 1 or q_block & (q_block - 1) or gb * q_block > FLASH_ROWS:
        raise ValueError(f"{what}: q_block {q_block} must be a power of two "
                         f"with G * q_block <= {FLASH_ROWS} (G = {gb} query "
                         f"heads a block)")
    return q_block


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0,
                          softmax_mode: str = "exact") -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, K, D) -> (B, S, H, D) in q's type."""
    b, s, h, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, nkv, h // nkv, d).float() * (1.0 / math.sqrt(d))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    mask = None
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None, None, None]
        scores = torch.where(mask, scores, NEG_INF)
    m = torch.clamp(scores.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = _exp(scores - m, softmax_mode)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    den = torch.clamp(p.sum(dim=-1), min=1e-30)              # (b, k, g, s)
    out = torch.einsum("bkgst,btkd->bkgsd", p, v.float()) / den[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, q_offset: int = 0,
                         softmax_mode: str = "exact",
                         q_block: int = 64) -> torch.Tensor:
    """GQA flash attention: q (B, S, H, D); k, v (B, T, K, D); H = K * G."""
    build.refuse_grad("flash_attention", q, k, v, hint=build.ATTENTION_HINT)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q must be (B, S, H, D) and k, v "
                         f"(B, T, K, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _check_mode(softmax_mode)
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    nkv = k.shape[2]
    if nkv < 1 or h % nkv:
        raise ValueError(f"flash_attention: {h} query heads over {nkv} KV "
                         f"heads")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    device = _check_device("flash_attention", q, k, v)
    if device == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     softmax_mode=softmax_mode)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if min(b, s, k.shape[1]) < 1:
        raise ValueError(f"flash_attention: empty dimension in "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    q_block = _check_q_block(q_block, h // nkv, "flash_attention")
    if device == "meta":
        return _on_meta("flash_attention", torch.empty_like(q), {
            "dims": (b, s, k.shape[1], h, nkv, d), "dtype": _dtype_name(q),
            "causal": bool(causal), "q_offset": q_offset,
            "softmax_mode": softmax_mode})
    body = flash_body(q.dtype)
    if body == "tensor_core":
        _check_aligned("flash_attention", q, k, v)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], h, nkv, d, q_block, int(bool(causal)), q_offset,
            int(softmax_mode == "taylor"), int(body == "tensor_core"),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, f"flash_attention ({body})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_body[body] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_body = dict.fromkeys(FLASH_BODIES, 0)


def flash_attention_dequant_plain(q: torch.Tensor, kq: torch.Tensor,
                                  ks: torch.Tensor, vq: torch.Tensor,
                                  vs: torch.Tensor, causal: bool = True,
                                  q_offset: int = 0,
                                  softmax_mode: str = "exact") -> torch.Tensor:
    """q (B, S, H, D); kq, vq (B, T, K, D) int8; ks, vs (B, T) float32 ->
    (B, S, H, D) in q's type: the rows dequantized, then
    :func:`flash_attention_plain`."""
    k = kq.float() * ks.float()[..., None, None]
    v = vq.float() * vs.float()[..., None, None]
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                 softmax_mode=softmax_mode)


def flash_attention_dequant_cuda(q: torch.Tensor, kq: torch.Tensor,
                                 ks: torch.Tensor, vq: torch.Tensor,
                                 vs: torch.Tensor, causal: bool = True,
                                 q_offset: int = 0,
                                 softmax_mode: str = "exact",
                                 q_block: int = 64,
                                 page_size: int = 64) -> torch.Tensor:
    """GQA flash attention over an int8 cache: q (B, S, H, D); kq, vq
    (B, T, K, D) int8; ks, vs (B, T) float32, one scale per row shared by
    the KV heads.  ``page_size`` is the page length the rows were written
    in; it must be positive, and the kernel, which reads a scale per row,
    needs no tile alignment to it."""
    build.refuse_grad("flash_attention_dequant", q, ks, vs,
                      hint=build.ATTENTION_HINT)
    if q.dim() != 4 or kq.dim() != 4 or kq.shape != vq.shape:
        raise ValueError(f"flash_attention_dequant: q must be (B, S, H, D) "
                         f"and kq, vq (B, T, K, D), got {tuple(q.shape)}, "
                         f"{tuple(kq.shape)}, {tuple(vq.shape)}")
    _check_mode(softmax_mode)
    b, s, h, d = q.shape
    t, nkv = kq.shape[1], kq.shape[2]
    if kq.shape[0] != b or kq.shape[3] != d or nkv < 1 or h % nkv:
        raise ValueError(f"flash_attention_dequant: cache {tuple(kq.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    if ks.shape != (b, t) or vs.shape != (b, t):
        raise ValueError(f"flash_attention_dequant: scales must be (B, T) = "
                         f"{(b, t)}, got {tuple(ks.shape)}, {tuple(vs.shape)}")
    if int(page_size) < 1:
        raise ValueError(f"flash_attention_dequant: page_size must be "
                         f"positive, got {page_size}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention_dequant: q_offset must be >= 0, "
                         f"got {q_offset}")
    device = _check_device("flash_attention_dequant", q, kq, ks, vq, vs)
    if device == "cpu":
        return flash_attention_dequant_plain(
            q, kq, ks, vq, vs, causal=causal, q_offset=q_offset,
            softmax_mode=softmax_mode)
    if (q.dtype not in _DTYPES or kq.dtype != torch.int8
            or vq.dtype != torch.int8 or ks.dtype != torch.float32
            or vs.dtype != torch.float32):
        raise TypeError(f"flash_attention_dequant takes a float32 or bfloat16 "
                        f"q, int8 kq, vq and float32 scales, got {q.dtype}, "
                        f"{kq.dtype}, {vq.dtype}, {ks.dtype}, {vs.dtype}")
    if d not in CACHE_HEAD_DIMS:
        raise ValueError(f"flash_attention_dequant: head dim {d} not in "
                         f"{CACHE_HEAD_DIMS}")
    if not all(x.is_contiguous() for x in (q, kq, ks, vq, vs)):
        raise ValueError("flash_attention_dequant: inputs must be contiguous")
    if min(b, s, t) < 1:
        raise ValueError(f"flash_attention_dequant: empty dimension in "
                         f"{tuple(q.shape)}, {tuple(kq.shape)}")
    q_block = _check_q_block(q_block, h // nkv, "flash_attention_dequant")
    if device == "meta":
        return _on_meta("flash_attention_dequant", torch.empty_like(q), {
            "dims": (b, s, t, h, nkv, d), "dtype": _dtype_name(q),
            "causal": bool(causal), "q_offset": q_offset,
            "softmax_mode": softmax_mode})
    body = flash_body(q.dtype)
    if body == "tensor_core":
        _check_aligned("flash_attention_dequant", q, kq, vq)
    lib = build.load_library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        code = lib.flash_attention_dequant_launch(
            q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), out.data_ptr(), b, s, t, h, nkv, d, q_block,
            int(bool(causal)), q_offset, int(softmax_mode == "taylor"),
            int(body == "tensor_core"),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, f"flash_attention_dequant ({body})")
    flash_attention_dequant_cuda.launches += 1
    flash_attention_dequant_cuda.launches_by_body[body] += 1
    return out


flash_attention_dequant_cuda.launches = 0
flash_attention_dequant_cuda.launches_by_body = dict.fromkeys(FLASH_BODIES, 0)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_BODIES = ("dense", "int8", "paged", "paged_int8")


def _paged_rows(x: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Pool leaf (n_pages, page, ...) read through ``tables`` (B, P), the
    entries clipped to the pool -> (B, P * page, ...)."""
    tv = torch.clamp(tables.to(device=x.device, dtype=torch.int64), 0,
                     x.shape[0] - 1)
    g = x[tv]
    return g.reshape((tv.shape[0], tv.shape[1] * x.shape[1]) + x.shape[2:])


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_valid_len: torch.Tensor,
                           tables: Optional[torch.Tensor] = None,
                           ks: Optional[torch.Tensor] = None,
                           vs: Optional[torch.Tensor] = None,
                           softmax_mode: str = "exact") -> torch.Tensor:
    """q (B, 1, H, D); a dense cache k, v (B, T, K, D) or, with ``tables``
    (B, P), pool leaves (n_pages, page, K, D); int8 k, v with float32
    per-row scales ``ks``, ``vs`` ((B, T) dense, (n_pages, page) paged);
    kv_valid_len (B,) -> (B, 1, H, D) in q's type.  The pages are gathered
    through the clipped tables and the rows dequantized, then the masked
    softmax; a slot with no valid row gives zeros."""
    if tables is not None:
        k, v = _paged_rows(k, tables), _paged_rows(v, tables)
        if ks is not None:
            ks, vs = _paged_rows(ks, tables), _paged_rows(vs, tables)
    if ks is not None:
        k = k.float() * ks.float()[..., None, None]
        v = v.float() * vs.float()[..., None, None]
    b, s, h, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, nkv, h // nkv, d).float() * (1.0 / math.sqrt(d))
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    valid = kv_valid_len.to(device=q.device, dtype=torch.int64)
    mask = (torch.arange(t, device=q.device)[None, :]
            < valid[:, None])[:, None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, _exp(scores - m, softmax_mode), 0.0)
    den = torch.clamp(p.sum(dim=-1), min=1e-30)              # (b, k, g, 1)
    out = torch.einsum("bkgst,btkd->bkgsd", p, v.float()) / den[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _check_decode_cache(q, k, v, kv_valid_len, tables, ks, vs):
    """Shapes of a decode call; returns (body, rows per slot T, pages per
    slot P, page length, pool pages)."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q must be (B, 1, H, D) and k, v "
                         f"(B, T, K, D) or (n_pages, page, K, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[3] != d or k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if kv_valid_len.shape != (b,) or kv_valid_len.dtype.is_floating_point:
        raise ValueError(f"decode_attention: kv_valid_len must be (B,) "
                         f"integers, got {tuple(kv_valid_len.shape)} "
                         f"{kv_valid_len.dtype}")
    if (ks is None) != (vs is None):
        raise ValueError("decode_attention: ks and vs come together")
    if tables is not None:
        if (tables.dim() != 2 or tables.shape[0] != b
                or tables.dtype.is_floating_point):
            raise ValueError(f"decode_attention: tables must be (B, P) "
                             f"integers, got {tuple(tables.shape)} "
                             f"{tables.dtype}")
        n_pages, page, p_per = k.shape[0], k.shape[1], tables.shape[1]
        t = p_per * page
        scale_shape = (n_pages, page)
    else:
        if k.shape[0] != b:
            raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                             f"not fit q {tuple(q.shape)}")
        n_pages = page = p_per = 0
        t = k.shape[1]
        scale_shape = (b, t)
    if ks is not None and (ks.shape != scale_shape
                           or vs.shape != scale_shape):
        raise ValueError(f"decode_attention: scales must be {scale_shape}, "
                         f"got {tuple(ks.shape)}, {tuple(vs.shape)}")
    body = ("paged" if tables is not None else "dense") if ks is None else (
        "paged_int8" if tables is not None else "int8")
    return body, t, p_per, page, n_pages


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid_len: torch.Tensor,
                          tables: Optional[torch.Tensor] = None,
                          ks: Optional[torch.Tensor] = None,
                          vs: Optional[torch.Tensor] = None,
                          softmax_mode: str = "exact",
                          threads: int = 256,
                          kv_splits: int = 1) -> torch.Tensor:
    """q_len = 1 decode: q (B, 1, H, D) against a dense cache k, v
    (B, T, K, D) or pool leaves (n_pages, page, K, D) read through
    ``tables`` (B, P) (negative entries are sentinels: clipped, and masked
    by the valid length); int8 caches carry per-row scales ``ks``, ``vs``;
    kv_valid_len (B,) integer -> (B, 1, H, D).  ``kv_splits`` blocks of
    ``threads`` threads serve one (slot, KV head)."""
    build.refuse_grad("decode_attention", q, k, v, ks, vs,
                      hint=build.ATTENTION_HINT)
    _check_mode(softmax_mode)
    body, t, p_per, page, n_pages = _check_decode_cache(
        q, k, v, kv_valid_len, tables, ks, vs)
    extra = [x for x in (tables, ks, vs) if x is not None]
    device = _check_device("decode_attention", q, k, v, kv_valid_len,
                           *extra)
    if device == "cpu":
        return decode_attention_plain(q, k, v, kv_valid_len, tables=tables,
                                      ks=ks, vs=vs,
                                      softmax_mode=softmax_mode)
    int8 = ks is not None
    if int8:
        ok = (k.dtype == v.dtype == torch.int8
              and ks.dtype == vs.dtype == torch.float32
              and q.dtype in _DTYPES)
    else:
        ok = (q.dtype in _DTYPES and k.dtype in _DTYPES and v.dtype == k.dtype
              and not (q.dtype == torch.bfloat16
                       and k.dtype != torch.bfloat16))
    if not ok:
        raise TypeError(f"decode_attention takes a float32 or bfloat16 cache "
                        f"and a query of the cache's type or float32, or an "
                        f"int8 cache with float32 scales and a float32 or "
                        f"bfloat16 query; got q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}"
                        + (f", ks {ks.dtype}, vs {vs.dtype}" if int8 else ""))
    b, _, h, d = q.shape
    nkv = k.shape[2]
    if d not in CACHE_HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in "
                         f"{CACHE_HEAD_DIMS}")
    scales = (ks, vs) if int8 else ()
    if not all(x.is_contiguous() for x in (q, k, v, *scales)):
        raise ValueError("decode_attention: q, k, v and the scales must be "
                         "contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: the kernel copies cache rows 16 "
                         "bytes at a time: k and v must be 16-byte aligned")
    threads, kv_splits = int(threads), int(kv_splits)
    if threads % 32 or not 32 <= threads <= DECODE_MAX_THREADS:
        raise ValueError(f"threads must be a multiple of 32 in "
                         f"[32, {DECODE_MAX_THREADS}], got {threads}")
    if not 1 <= kv_splits <= DECODE_MAX_SPLITS:
        raise ValueError(f"decode_attention: kv_splits must be in "
                         f"[1, {DECODE_MAX_SPLITS}], got {kv_splits}")
    smem = decode_smem_bytes(d, threads, k.element_size(), kv_splits)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"decode_attention: D={d} at {threads} threads and "
                         f"{kv_splits} splits needs {smem} bytes of shared "
                         f"memory per block, more than the "
                         f"{MAX_DYNAMIC_SMEM} a block can have")
    if device == "meta":
        case = {"dims": (b, t, h, nkv, d), "valid": (t,) * b,
                "dtype": _dtype_name(q), "quant": int8,
                "softmax_mode": softmax_mode}
        if tables is not None:
            case["paged"] = (n_pages, page, p_per)
        return _on_meta("decode_attention", torch.empty_like(q), case)
    valid = kv_valid_len
    if valid.dtype != torch.int32 or not valid.is_contiguous():
        valid = valid.to(torch.int32).contiguous()
    tab = tables
    if tab is not None and (tab.dtype != torch.int32
                            or not tab.is_contiguous()):
        tab = tab.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    index = q.get_device()
    code = _decode_launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        tab.data_ptr() if tab is not None else None,
        ks.data_ptr() if int8 else None, vs.data_ptr() if int8 else None,
        out.data_ptr(), b, t, h, nkv, d, p_per, page, n_pages,
        int(softmax_mode == "taylor"), int(q.dtype == torch.bfloat16),
        2 if int8 else int(k.dtype == torch.bfloat16), threads, kv_splits,
        index, build.raw_stream(index))
    build.check_launch(code, f"decode_attention ({body})")
    decode_attention_cuda.launches += 1
    decode_attention_cuda.launches_by_body[body] += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.launches_by_body = dict.fromkeys(DECODE_BODIES, 0)

_decode_launch = None               # the C entry point, bound at first use


def _decode_launch_fn():
    global _decode_launch
    if _decode_launch is None:
        _decode_launch = build.load_library().decode_attention_launch
    return _decode_launch


def decode_chunked(group: int) -> bool:
    """Whether a group of ``group`` query heads takes the source's chunked
    template instances (``kChunked``): above ``DECODE_CHUNK_GROUP``."""
    return int(group) > DECODE_CHUNK_GROUP


def decode_group_chunks(group: int) -> int:
    """The blocks the ``group`` query heads of one KV head are dealt to, as
    ``decode_group_chunks`` in the source counts them: chunks of at most
    ``DECODE_CHUNK_GROUP`` heads, as even as they come (one up to 8)."""
    return -(-max(1, int(group)) // DECODE_CHUNK_GROUP)


def decode_smem_bytes(d: int, threads: int, kv_bytes: int,
                      kv_splits: int) -> int:
    """Shared memory of one decode block, as ``decode_smem_bytes`` in the
    source sizes it: the scaled queries; per warp ``DECODE_STAGES`` stages
    of a K and a V tile (rows of ``kv_bytes``-byte elements padded by
    ``DECODE_ROW_PAD``) with their scales, and a p buffer; one
    (m, l, acc) state per split for rank 0 to join."""
    stage = 2 * DECODE_TILE * (d * kv_bytes + DECODE_ROW_PAD) \
        + 2 * DECODE_TILE * 4
    per_warp = DECODE_STAGES * stage + 4 * DECODE_CHUNK_GROUP * DECODE_TILE
    return (4 * DECODE_CHUNK_GROUP * d + (threads // 32) * per_warp
            + 4 * kv_splits * DECODE_CHUNK_GROUP * (d + 2))


def decode_kv_splits(nkv: int, t: int, asked: int,
                     n_sm: int = H100_SMS, group: int = 1) -> int:
    """Blocks per (slot, KV head, chunk of its ``group`` query heads): the
    largest power of two that gives each split at least
    ``DECODE_SPLIT_ROWS`` of the cache's ``t`` rows and puts one slot's
    blocks on no more than ``n_sm`` SMs (K * chunks * splits <= n_sm), at
    least 1 and no more than ``asked`` or ``DECODE_MAX_SPLITS``.  The split
    count sets a row's sums (the split ranges and their join), so it is
    planned from the cache and the model alone, never from the batch: a
    slot's output does not change with how many slots share the launch
    (the sampling contract's schedule invariance).  (A block of the
    default 8 warps stages two tiles a warp, 166 KB at D = 64 bf16: one
    fits an SM.)"""
    chunks = decode_group_chunks(group)
    want = 1
    while (want < DECODE_MAX_SPLITS and nkv * chunks * want * 2 <= n_sm
           and want * 2 * DECODE_SPLIT_ROWS <= t):
        want *= 2
    return max(1, min(int(asked), want))
