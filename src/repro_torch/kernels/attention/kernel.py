"""Wrappers of the attention CUDA kernels and their plain PyTorch versions.

* :func:`flash_attention_cuda` (``csrc/flash_attention.cu``) replaces
  ``repro/kernels/attention/kernel.py`` ``flash_attention_pallas``: blocked
  GQA attention over q (B, S, H, D) and k, v (B, T, K, D), causal or not,
  with a static ``q_offset``, exact or Eq. 2 exp, float32 inside.  The
  tunable ``q_block`` is the number of query positions a thread block holds
  (with all G heads of each, at most 64 rows).
* :func:`decode_attention_cuda` (``csrc/decode_attention.cu``) replaces
  ``decode_attention_pallas``, the dense-cache body: one query token per
  slot against its cache rows below ``kv_valid_len``.  The tunable
  ``threads`` is the block size; one block serves one (slot, KV head).
  The int8 and paged bodies are ported with the paged slice: ``tables``,
  ``ks`` and ``vs`` raise ``NotImplementedError`` on every device.

A wrapper runs its plain version (:func:`flash_attention_plain`,
:func:`decode_attention_plain`) only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.  The plain versions compute what
the kernels compute, in one pass instead of tiles: q scaled in float32, the
masked exp of the chosen mode, ``acc / max(l, 1e-30)``.  In exact mode they
agree with the oracles of :mod:`repro_torch.kernels.attention.ref` to
float32 rounding.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import approx_math
from repro_torch.kernels import build
from repro_torch.kernels.attention.ref import NEG_INF

MAX_DYNAMIC_SMEM = 232448           # bytes a Hopper block may ask for
HEAD_DIMS = (16, 32, 64, 128)
# The kernels' block geometry, which the registry needs to plan block sizes
# on hosts without the library: kFlashRows, kDecodeMaxG and kDecodeTile of
# the sources (tests/test_torch_attention.py holds them equal).
FLASH_ROWS = 64                     # query rows (positions x heads) a block holds
DECODE_MAX_GROUP = 8                # query heads per KV head of the decode kernel
DECODE_TILE = 32                    # cache rows per warp tile of the decode kernel
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
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {tensors[0].device}")
    for t in tensors[1:]:
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: tensors on {tensors[0].device} and "
                             f"{t.device}")
    return kind


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


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
    if _check_device("flash_attention", q, k, v) == "cpu":
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
    q_block = int(q_block)
    g = h // nkv
    if q_block < 1 or q_block & (q_block - 1) or g * q_block > FLASH_ROWS:
        raise ValueError(f"flash_attention: q_block {q_block} must be a "
                         f"power of two with G * q_block <= {FLASH_ROWS} "
                         f"(G = {g})")
    lib = build.load_library()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        code = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            k.shape[1], h, nkv, d, q_block, int(bool(causal)), q_offset,
            int(softmax_mode == "taylor"), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_valid_len: torch.Tensor,
                           softmax_mode: str = "exact") -> torch.Tensor:
    """q (B, 1, H, D); k, v (B, T, K, D); kv_valid_len (B,) -> (B, 1, H, D)
    in q's type; a slot with no valid row gives zeros."""
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


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          kv_valid_len: torch.Tensor,
                          tables: Optional[torch.Tensor] = None,
                          ks: Optional[torch.Tensor] = None,
                          vs: Optional[torch.Tensor] = None,
                          softmax_mode: str = "exact",
                          threads: int = 256) -> torch.Tensor:
    """q_len = 1 decode: q (B, 1, H, D); dense cache k, v (B, T, K, D);
    kv_valid_len (B,) integer -> (B, 1, H, D)."""
    if tables is not None or ks is not None or vs is not None:
        raise NotImplementedError(
            "decode_attention: paged (tables) and int8 (ks, vs) caches are "
            "ported with the paged slice; this kernel reads dense caches")
    _check_mode(softmax_mode)
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q must be (B, 1, H, D) and k, v "
                         f"(B, T, K, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] < 1 \
            or h % k.shape[2]:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if kv_valid_len.shape != (b,) or kv_valid_len.dtype.is_floating_point:
        raise ValueError(f"decode_attention: kv_valid_len must be (B,) "
                         f"integers, got {tuple(kv_valid_len.shape)} "
                         f"{kv_valid_len.dtype}")
    if _check_device("decode_attention", q, k, v, kv_valid_len) == "cpu":
        return decode_attention_plain(q, k, v, kv_valid_len,
                                      softmax_mode=softmax_mode)
    if (q.dtype not in _DTYPES or k.dtype not in _DTYPES
            or v.dtype != k.dtype
            or (q.dtype == torch.bfloat16 and k.dtype != torch.bfloat16)):
        raise TypeError(f"decode_attention takes a float32 or bfloat16 cache "
                        f"and a query of the cache's type or float32, got q "
                        f"{q.dtype}, k {k.dtype}, v {v.dtype}")
    nkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in {HEAD_DIMS}")
    if h // nkv > DECODE_MAX_GROUP:
        raise ValueError(f"decode_attention: {h // nkv} query heads per KV "
                         f"head, the kernel takes {DECODE_MAX_GROUP}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention: q, k, v must be contiguous")
    threads = int(threads)
    if threads % 32 or not 32 <= threads <= 512:
        raise ValueError(f"threads must be a multiple of 32 in [32, 512], "
                         f"got {threads}")
    smem = decode_smem_bytes(d, threads)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"decode_attention: D={d} at {threads} threads "
                         f"needs {smem} bytes of shared memory per block, "
                         f"more than the {MAX_DYNAMIC_SMEM} a block can have")
    lib = build.load_library()
    with torch.cuda.device(q.device):
        valid = kv_valid_len.to(torch.int32).contiguous()
        out = torch.empty_like(q)
        code = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), b, k.shape[1], h, nkv, d,
            int(softmax_mode == "taylor"), int(q.dtype == torch.bfloat16),
            int(k.dtype == torch.bfloat16), threads,
            torch.cuda.current_stream().cuda_stream)
    build.check_launch(code, "decode_attention")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_smem_bytes(d: int, threads: int) -> int:
    """Shared memory of one decode block, as ``decode_smem_floats`` in the
    source sizes it: per warp a K tile padded to D + 1, a V tile and a p
    buffer of ``DECODE_MAX_GROUP`` heads; the scaled queries once."""
    per_warp = (DECODE_TILE * (d + 1) + DECODE_TILE * d
                + DECODE_MAX_GROUP * DECODE_TILE)
    return 4 * (DECODE_MAX_GROUP * d + (threads // 32) * per_warp)
