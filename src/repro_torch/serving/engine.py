"""ServeEngine: LM decode serving over the shared EngineCore.

A fixed batch of ``n_slots`` KV-cache slots (continuous batching): requests
join free slots as they arrive, get a *ragged* batched prefill (per-slot
prompt lengths and position ids), and one ``decode_step`` advances every
slot per tick with per-slot cache indices.  Finished slots are recycled
without disturbing the others.

The engine serves every decoding family: dense, moe, vlm, ssm and hybrid
(audio is an encoder and is refused: it has no decode path).  Ragged
prefill is exact for the attention families: prompts are left-aligned with
a zero pad suffix, so causal attention keeps real tokens from attending
pads, and moe masks pad tokens out of expert routing and capacity; each
slot's last-token logits seed its generation, and the vector ``pos``
decode masks each slot's cache beyond its own length.  Serving prompts
carry no image features, so a vlm's cross-attention reads a zero cross
cache.  Recurrent families (ssm, hybrid) cannot mask a pad suffix out of
their state after the fact, so their admission is *length-bucketed*: each
tick's new prompts are grouped by exact length and each group prefills
with no pad suffix at all (exact; one prefill shape per distinct prompt
length).  ``generate()`` raises on a ragged recurrent batch instead of
approximating it.  Their decode advances every slot's state, idle ones
too; admission overwrites a slot's rows, so that is harmless.

On the card with ``decode_kernel=True``, a decode tick runs the
``decode_attention`` kernel in every layer and draws every slot's token
with one ``fused_sampling`` launch, so only the (n_slots,) token vector
crosses to the host; with ``cfg.attn_impl == "cuda"`` prefill attention
runs the ``flash_attention`` kernel.  Without the kernels the tick copies
the logits to the host and samples there (``sample_token_host``).

The dense family's kernel tick (dense caches or paged, bf16 or int8) is
*staged* and, on the card, a captured CUDA graph: the counterpart of the
reference's jitted ``_decode`` / ``_decode_paged``.  The host packs each
block's pending tokens, positions, the five sampling rows and (paged) the
table rows into one pinned int32 buffer, one copy stages it into the
block's static device buffer, and the block's graph replays
``lm.decode_step`` plus one ``fused_sampling`` launch on it
(:meth:`ServeEngine._tick_body`).  The batch is pinned at capacity, so a
block has one graph, captured at its first decode tick (whose seconds are
kept out of the tick wall: :meth:`ServeEngine.graph_stats`); the caches
and pool leaves are written in place, and a leaf that moved is
re-captured (:mod:`repro_torch.graphs`).  On the CPU the same staged body
runs eagerly.  The same engine stages its admission, the counterparts of
the reference's jitted ``_prefill``, ``_prefill_paged``, ``_gather`` and
``_inject`` (:meth:`ServeEngine._run_staged`): the ragged prefill per
``(nb, plen)`` bucket, the paged prefill per ``(nb, plen, off)``,
preemption's and the handoff's row gather and inject per row count, each
a graph per block and key on the card.  ``generate()``, the recurrent
families' length-bucketed prefill and the other families' ticks and
admission stay eager.

The engine casts the parameters to the compute type once, when it is
built (:func:`repro_torch.models.lm.compute_params`), and updates its
caches in place.  It shares ``submit() / poll() / run_until_idle() /
stats()`` with :class:`repro_torch.serving.CapsuleEngine` and takes the
same schedulers (priority preemption is lossless: the slot's cache rows
are gathered and re-injected on resume).

Paged mode (``page_size=...``): the dense slot caches are replaced by a
:class:`repro_torch.serving.pages.PagePool` — a global page pool with
per-slot page tables, a content-addressed prefix cache (shared prompt
prefixes prefill once; later requests pin the shared read-only pages and
prefill only their suffix via ``lm.continuation_prefill_step``), optional
int8 pages (``quantize_pages``), preemption by reference (the table row is
saved, no device traffic) and a host spill when the pool runs dry.  With
``decode_kernel=True`` a dense or moe paged decode tick hands the pool's
leaves and the tables to the model (``paged_tables``), so the
``decode_attention`` kernel reads each slot's pages in place; otherwise (and
for vlm, as in the reference) the tick gathers a dense view through the
tables, decodes it (with ``decode_kernel=True`` through the dense
``decode_attention`` kernel) and scatters the new rows back.

Data-parallel mode (a :class:`repro_torch.serving.ShardedScheduler`): the
slots split into one contiguous block per device of the mesh's ``batch``
axes (slot ``s`` lives on block ``s * n_dev // n_slots``, the reference's
layout of a sharded slot axis), and every block's device holds that block's
caches (or its block of the page pool) and nothing else; each distinct
device holds one compute copy of the parameters.  One host thread drives
every device: a tick launches ``lm.decode_step`` (and ``fused_sampling``)
once per block, back to back, then copies each block's tokens back;
admission prefills each group on the device that owns its slots;
preemption gathers a slot's rows from its device and resume injects them
onto the device of the slot it lands in.  In paged mode the page
allocator stays within the slot's block (it spills or raises as when the
pool runs dry, where the reference's would take a page of another block),
prefix hits are looked up within the block, and the decode kernel reads
each block's table rows in the block's local page ids.  No collective is
needed: the parameters are replicated and each device owns its slots.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import (LMConfig, tree_leaves,
                                       tree_unflatten)
from repro_torch.serving.core import EngineCore, SlotTask
from repro_torch.serving.pages import PagePool, PagePoolExhausted
from repro_torch.serving.schedulers import (Scheduler, ShardedScheduler,
                                            pow2_bucket)


@dataclasses.dataclass
class _Shard:
    """One block of slots ``[lo, hi)`` and the device that holds it: the
    compute-type parameters of that device (shared by every block on it)
    and the block's dense caches, or its block of the page pool (pages
    ``[page_lo, page_lo + n)`` of the pool, local ids ``0..n-1``) and
    residual rows.  An engine that does not shard has one."""

    index: int
    device: torch.device
    params: Any
    lo: int
    hi: int
    page_lo: int = 0
    caches: Any = None
    pool: Optional[Dict[str, torch.Tensor]] = None
    residual: Optional[Dict[str, torch.Tensor]] = None
    # the staged decode tick: its call (graphs.CapturedCall) and the host
    # buffer staged into it, made at the block's first tick
    tick: Any = None
    tick_host: Optional[torch.Tensor] = None
    # the staged admission calls (prefill, paged prefill, gather, inject),
    # one per (kind, shape key, tuning policy), made at first use
    calls: Dict[Any, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0      # 0 -> greedy
    rid: Optional[int] = None     # None -> engine-assigned
    stream: bool = False          # emit per-token StreamEvents
    priority: int = 0             # 0 = most urgent (PriorityScheduler)
    seed: Optional[int] = None    # None -> engine-derived at admission
    top_k: int = 0                # 0 -> no top-k restriction
    top_p: float = 1.0            # 1.0 -> no nucleus restriction


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]             # prompt + generated
    latency_s: float = 0.0        # submit -> completion wall-clock


class ServeEngine(EngineCore):
    """Slot-based continuous-batching LM engine (one request per slot).

    ``submit`` may be called from any thread while ticks are in flight;
    ``tick`` / ``run_until_idle`` assume a single ticker thread.  Prompts
    are 1-D int token lists with ``0 < len < max_len``; completions carry
    ``prompt + generated`` tokens; stats count generated tokens as items.
    ``device=None`` means the card (and raises when there is none); under
    a :class:`ShardedScheduler` the blocks' devices are the mesh's.
    """

    def __init__(self, cfg: LMConfig, params: Any, n_slots: int = 4,
                 max_len: int = 512, seed: int = 0,
                 scheduler: Optional[Scheduler] = None,
                 clock=time.perf_counter,
                 kernel_tune: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 quantize_pages: bool = False,
                 prefix_cache: bool = True,
                 decode_kernel: bool = False,
                 device: Any = None):
        if cfg.family == "audio":
            raise ValueError("encoder models have no decode path")
        self._decode_kernel = bool(decode_kernel)
        if self._decode_kernel:
            cfg = dataclasses.replace(cfg, decode_impl="cuda")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        # recurrent state (ssm / hybrid) cannot mask a pad suffix the way
        # attention masks cache rows: admission is length-bucketed instead
        self._recurrent = cfg.family in lm.RECURRENT_FAMILIES
        self._seed0 = int(seed)       # base of engine-derived request seeds
        self._prefix_cache = bool(prefix_cache)
        self._pages: Optional[PagePool] = None
        if page_size is not None:
            self._pages = PagePool(cfg, n_slots, max_len, page_size,
                                   n_pages=n_pages, quantize=quantize_pages)
        # paged kernel decode threads the per-slot tables into the model;
        # vlm decodes a gathered view (its per-site kv slicing, as in the
        # reference)
        self._paged_kernel = (self._decode_kernel and self._pages is not None
                              and cfg.family in ("dense", "moe"))
        # binds the scheduler: a ShardedScheduler checks that the slots
        # divide over its devices before anything is allocated
        super().__init__(capacity=n_slots, scheduler=scheduler, clock=clock,
                         kernel_tune=kernel_tune)
        self._shards = self._make_shards(params, device)
        self.device = self._shards[0].device
        self.params = self._shards[0].params
        self._tok = np.zeros((n_slots,), np.int32)   # pending token per slot
        self._pos = np.zeros((n_slots,), np.int32)   # its cache index
        # the row tree a staged inject of k rows takes (_inject_tree)
        self._inject_trees: Dict[int, tuple] = {}

    def _make_shards(self, params: Any, device: Any) -> List[_Shard]:
        """One block of slots per device of a ShardedScheduler's mesh (one
        block on ``device`` otherwise), with its caches or pool block; the
        parameters are cast once per distinct device."""
        if isinstance(self.scheduler, ShardedScheduler):
            devices = [resolve_device(d) for d in self.scheduler.devices]
            if device is not None and \
                    torch.device(device).type != devices[0].type:
                raise ValueError(
                    f"engine device {device} differs from the mesh's "
                    f"{devices[0]}")
        else:
            devices = [resolve_device(device)]
        n = len(devices)
        per = self.n_slots // n
        ppb = 0
        if self._pages is not None:
            if self._pages.n_pages % n:
                raise ValueError(
                    f"{self._pages.n_pages} pages not divisible by the {n} "
                    f"batch-axis devices of the mesh")
            ppb = self._pages.n_pages // n
            if n > 1:
                self._pages.set_device_blocks(n, strict=True)
        replicas: Dict[torch.device, Any] = {}
        shards = []
        for k, dev in enumerate(devices):
            if dev not in replicas:
                replicas[dev] = lm.compute_params(self.cfg,
                                                  _to_device(params, dev))
            sh = _Shard(index=k, device=dev, params=replicas[dev],
                        lo=k * per, hi=(k + 1) * per, page_lo=k * ppb)
            if self._pages is not None:
                # no dense slot caches: resident capacity is bounded by
                # pages, not slots x max_len (generate() makes its own)
                sh.pool = self._pages.init_pool_arrays(dev, n_pages=ppb)
                sh.residual = self._pages.init_residual_arrays(dev,
                                                               n_slots=per)
            else:
                sh.caches = lm.make_caches(self.cfg, per, self.max_len, dev)
            shards.append(sh)
        return shards

    # the first block's state (with one block, the engine's)
    _caches = property(lambda self: self._shards[0].caches)
    _pool = property(lambda self: self._shards[0].pool)
    _residual = property(lambda self: self._shards[0].residual)

    def _shard_of(self, slot: int) -> _Shard:
        return self._shards[slot * len(self._shards) // self.n_slots]

    def _shard_of_page(self, page: int) -> _Shard:
        return self._shards[page * len(self._shards) // self._pages.n_pages]

    def _by_shard(self, pairs: List[Tuple[int, Any]]
                  ) -> List[Tuple[_Shard, List[Tuple[int, Any]]]]:
        """``(slot, x)`` pairs grouped by the block that owns the slot, in
        block order (order kept within a block); empty blocks left out."""
        groups: Dict[int, List[Tuple[int, Any]]] = {}
        for pair in pairs:
            groups.setdefault(self._shard_of(pair[0]).index, []).append(pair)
        return [(self._shards[k], groups[k]) for k in sorted(groups)]

    def _local_pages(self, sh: _Shard, pages: List[int]) -> List[int]:
        return [p - sh.page_lo for p in pages]

    # -- device steps --------------------------------------------------------

    def _to_dev(self, x: Any, device: Any = None) -> torch.Tensor:
        """A host array on ``device`` (the engine's by default); a tensor
        (a staged call's slice of its device buffer) passes through."""
        if torch.is_tensor(x):
            return x
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device if device is None else device)

    def _blocks(self, arr: np.ndarray) -> List[torch.Tensor]:
        """A tick array (slot axis leading) as one tensor per block, each
        on its block's device: the ShardedScheduler's ``place()``, or the
        whole array on the engine's device."""
        if isinstance(self.scheduler, ShardedScheduler):
            return self.scheduler.place(arr)
        return [self._to_dev(self.scheduler.place(arr))]

    def _prefill_scatter(self, sh: _Shard, tokens: Any, lengths: Any,
                         slot_idx: Any, caches: Any):
        """Prefill a (bucketed) sub-batch on fresh caches on block ``sh``'s
        device, then scatter its rows into ``caches`` at the block-local
        ``slot_idx`` (pad rows carry an index past the block and are
        dropped on the device); returns (logits on the device, caches).
        Admission cost scales with the admitted slots, not the capacity.
        The arguments are host arrays, or the staged call's device slices
        (:meth:`_prefill_body`)."""
        sub = lm.make_caches(self.cfg, tokens.shape[0], self.max_len,
                             sh.device)
        logits, sub = lm.ragged_prefill_step(
            sh.params, self.cfg,
            {"tokens": self._to_dev(tokens, sh.device),
             "lengths": self._to_dev(lengths, sh.device)}, sub)
        return logits, lm.scatter_cache_rows(self.cfg, slot_idx, sub, caches)

    def _decode(self, sh: _Shard, tok: torch.Tensor, pos: torch.Tensor,
                caches: Any):
        return lm.decode_step(sh.params, self.cfg,
                              {"tokens": tok, "pos": pos}, caches)

    def _decode_paged_impl(self, sh: _Shard, tok: torch.Tensor,
                           pos: torch.Tensor, tables: np.ndarray):
        """One paged decode tick of block ``sh`` (``tables``: its slots'
        rows in local page ids); returns (logits on the device, pool).

        Kernel path (``decode_kernel=True``): the pool leaves pass straight
        through (:meth:`PagePool.pool_tree`, no gather) and every layer's
        ``decode_attention`` kernel reads each slot's resident pages
        through its table row, after the fresh row was written into its
        page: a slot touches only its own pages.

        Otherwise: gather the dense view through the page tables, run the
        ordinary ``lm.decode_step`` on it, and scatter each slot's new row
        back into its mapped page.  Residual (non-paged) leaves are
        read-only during decode."""
        pages = self._pages
        batch = {"tokens": tok, "pos": pos}
        tables_t = self._to_dev(tables, sh.device)
        if self._paged_kernel:
            tree = pages.pool_tree(sh.pool, sh.residual)
            logits, tree = lm.decode_step(sh.params, self.cfg, batch, tree,
                                          paged_tables=tables_t)
            return logits, pages.pool_untree(tree)[0]
        view = pages.build_view(sh.pool, sh.residual, tables_t)
        logits, view = lm.decode_step(sh.params, self.cfg, batch, view)
        return logits, pages.scatter_decode_rows(sh.pool, view, tables_t,
                                                 batch["pos"])

    def _prefill_paged_impl(self, sh: _Shard, off: int, tokens: Any,
                            lengths: Any, page_map: Any, prefix_rows: Any,
                            slot_idx: Any):
        """Paged (possibly continuation) prefill on block ``sh``: a fresh
        sub cache just long enough for the written page span, prefilled
        from position ``off`` (0 = ordinary ragged prefill; > 0 continues
        from the dequantized shared-prefix pages ``prefix_rows``), then
        scattered into the block's pool at page granularity (``page_map``
        and ``prefix_rows`` in local page ids, ``slot_idx`` block-local;
        the sentinel and out-of-range slots drop their rows on the
        device).  The arguments are host arrays, or the staged call's
        device slices (:meth:`_prefill_paged_body`).  Returns (logits,
        pool, residual)."""
        pages = self._pages
        nb = tokens.shape[0]
        total = off + page_map.shape[1] * pages.page_size
        batch = {"tokens": self._to_dev(tokens, sh.device),
                 "lengths": self._to_dev(lengths, sh.device)}
        if off == 0:
            sub = lm.make_caches(self.cfg, nb, total, sh.device)
            logits, sub = lm.ragged_prefill_step(sh.params, self.cfg,
                                                 batch, sub)
        else:
            sub = pages.make_continuation_caches(sh.pool, prefix_rows, nb,
                                                 total)
            logits, sub = lm.continuation_prefill_step(
                sh.params, self.cfg, batch, sub, off)
        pool = pages.write_prefill_pages(sh.pool, sub, page_map, off)
        residual = pages.scatter_residual_rows(
            sh.residual, pages.residual_rows_from(sub), slot_idx)
        return logits, pool, residual

    # -- sampling ----------------------------------------------------------
    #
    # Counter-based (see repro_torch.kernels.sampling): every draw is a pure
    # function of (request seed, sequence position of the drawn token), so
    # temperature > 0 decode is reproducible and independent of batch
    # composition, slot assignment and preemption.  Greedy is an exact
    # argmax of the raw logits on every path.

    def _bind_seed(self, task: SlotTask) -> int:
        """The request's sampling seed, fixed at admission: a request
        without one gets a seed derived from the engine seed and its rid,
        written back onto the request so that it survives preemption."""
        req = task.payload
        seed = getattr(req, "seed", None)
        if seed is None:
            seed = (self._seed0 ^ ((task.rid + 1) * 0x9E3779B1)) & 0x7FFFFFFF
            req.seed = seed             # guarded-by: single ticker thread
        return int(seed)

    def _sample_row(self, logits_row: np.ndarray, temperature: float,
                    seed: int, pos: int, top_k: int = 0,
                    top_p: float = 1.0) -> int:
        from repro_torch.kernels.sampling import sample_token_host

        return sample_token_host(logits_row, temperature, seed, pos,
                                 top_k=top_k, top_p=top_p)

    def _sample_task_row(self, logits_row: np.ndarray, task: SlotTask,
                         pos: int) -> int:
        req = task.payload
        return self._sample_row(
            logits_row, float(getattr(req, "temperature", 0.0)),
            self._bind_seed(task), pos,
            top_k=int(getattr(req, "top_k", 0) or 0),
            top_p=float(getattr(req, "top_p", 1.0)))

    def _sampling_rows(self, n: int, active, pos_of, lo: int = 0
                       ) -> np.ndarray:
        """The (5, n) int32 rows one fused_sampling launch reads for a
        block's ``n`` slots (row ``i`` is slot ``lo + i``; the bit patterns
        of ``kernels.pack_sampling_rows``).  Free slots sample greedily."""
        from repro_torch import kernels

        temp = np.zeros((n,), np.float32)
        seeds = np.zeros((n,), np.uint32)
        poss = np.zeros((n,), np.int32)
        tks = np.zeros((n,), np.int32)
        tps = np.ones((n,), np.float32)
        for s, task in active:
            req = task.payload
            i = s - lo
            temp[i] = float(getattr(req, "temperature", 0.0))
            seeds[i] = self._bind_seed(task)
            poss[i] = pos_of(s)
            tks[i] = int(getattr(req, "top_k", 0) or 0)
            tps[i] = float(getattr(req, "top_p", 1.0))
        return kernels.pack_sampling_rows(n, temp, seeds, poss, tks, tps)

    def _sample_batch_device(self, logits: torch.Tensor, active, pos_of,
                             lo: int = 0) -> torch.Tensor:
        """Kernel-path sampling: one fused_sampling launch draws the token
        of every slot of a block (``logits`` row ``i`` is slot ``lo + i``)
        where the logits are; returns the (n,) int32 tokens on the device
        (the caller's copy to the host is the tick's synchronisation).
        Free slots sample greedily and are ignored."""
        from repro_torch import kernels

        rows = self._sampling_rows(logits.shape[0], active, pos_of, lo)
        return kernels.fused_sampling_rows(
            logits, torch.from_numpy(rows).to(logits.device), tune=False)

    def _observe_logits(self, logits: torch.Tensor, active, pos_of,
                        lo: int = 0) -> None:
        """Called with a block's decode logits on the device (row ``i`` is
        slot ``lo + i``; ``pos_of(s)`` the position slot ``s``'s token will
        take) each kernel tick, before the block's tokens are drawn
        (unstaged) or right after its graph's replay (staged: the logits
        stay valid until the next replay).  A no-op: the hook of
        measurements."""

    # -- single-batch convenience ------------------------------------------

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0) -> List[List[int]]:
        """Batched prefill + greedy/temperature decode on fresh caches of
        its own (on the first block's device), sampled on the host.
        Ragged-correct for the attention families: each prompt keeps its own length and positions, so the
        result matches per-request generation; a recurrent family's batch
        must have one prompt length (``ValueError`` otherwise).  Row ``i``
        samples with seed ``(base ^ ((i + 1) * 0x9E3779B1)) & 0x7FFFFFFF``
        (base = ``seed`` or the engine seed) and counter = the token's
        sequence position."""
        b = len(prompts)
        for p in prompts:
            self._check_prompt(p)
        if max_new_tokens <= 0:
            return [list(p) for p in prompts]
        plens = sorted({len(p) for p in prompts})
        if self._recurrent and len(plens) > 1:
            raise ValueError(
                f"ragged prompts (lengths {plens}) in one generate() batch "
                f"would fold pad tokens into the recurrent "
                f"({self.cfg.family}) state; pass uniform-length prompts, "
                f"or submit() them: the engine admits recurrent prompts in "
                f"exact-length buckets")
        caches = lm.make_caches(self.cfg, b, self.max_len, self.device)
        # recurrent: no pad suffix at all (the exact length); attention
        # families mask the pad, so pow2 bucketing is free
        plen = (plens[-1] if self._recurrent
                else pow2_bucket(plens[-1], self.max_len))
        tokens = np.zeros((b, plen), np.int32)
        lengths = np.ones((b,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p                   # left-aligned, pad right
            lengths[i] = len(p)
        sh = self._shards[0]
        logits, caches = self._prefill_scatter(sh, tokens, lengths,
                                               np.arange(b), caches)
        logits = logits.cpu().numpy()
        out = [list(p) for p in prompts]
        base = self._seed0 if seed is None else int(seed)
        row_seed = [(base ^ ((i + 1) * 0x9E3779B1)) & 0x7FFFFFFF
                    for i in range(b)]
        pos = lengths.copy()
        alive = np.ones((b,), bool)           # slots still within max_len
        for k in range(max_new_tokens):
            for i in range(b):
                if alive[i]:
                    out[i].append(self._sample_row(
                        logits[i], temperature, row_seed[i], int(pos[i]),
                        top_k=top_k, top_p=top_p))
            if k == max_new_tokens - 1:
                break
            alive &= pos < self.max_len       # per-slot stop (cache full)
            if not alive.any():
                break
            nxt = np.array([out[i][-1] if alive[i] else 0
                            for i in range(b)], np.int32)
            logits, caches = self._decode(
                sh, self._to_dev(nxt[:, None]),
                self._to_dev(np.minimum(pos, self.max_len - 1)), caches)
            logits = logits.cpu().numpy()
            pos += 1
        return out

    # -- workload hooks ----------------------------------------------------

    def _check_prompt(self, prompt) -> None:
        if not len(prompt):
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} leaves no room to generate "
                f"(max_len={self.max_len})")

    def _expand(self, request: Request
                ) -> Tuple[List[SlotTask], Dict[str, Any]]:
        prompt = [int(t) for t in request.prompt]
        request.prompt = prompt
        self._check_prompt(prompt)
        if request.max_new_tokens <= 0:
            return [], {}                 # prefill-free identity completion
        return [SlotTask(payload=request)], {}

    def _admit(self, new: List[Tuple[int, SlotTask]]
               ) -> Tuple[List[int], int]:
        """Ragged batched prefill of the newly admitted slots only: one
        pow2-bucketed sub-batch whose cache rows are scattered into the
        slot caches.  Recurrent families take one sub-batch per distinct
        prompt length instead, shortest first, each with no pad suffix.
        Tasks preempted earlier (``_evict`` saved their cache rows) take
        the *resume* path instead: one batched scatter re-injects their
        rows at the new slots and decode continues from the saved token and
        position, exactly as if never preempted."""
        if self._pages is not None:
            return self._admit_paged(new)
        resume = [(s, t) for s, t in new if "resume_rows" in t.state]
        new = [(s, t) for s, t in new if "resume_rows" not in t.state]
        pre_finished: List[int] = []
        for sh, members in self._by_shard(resume):
            # the rows come from the device the task was evicted on
            self._inject_rows(
                sh, [s - sh.lo for s, _ in members],
                [_to_device(t.state.pop("resume_rows"), sh.device)
                 for _, t in members])
        for s, task in resume:
            self._tok[s] = task.state.pop("resume_tok")
            self._pos[s] = task.state.pop("resume_pos")
            if task.state["left"] <= 0 or self._pos[s] >= self.max_len:
                pre_finished.append(s)
        if not new:
            return pre_finished, 0
        if self._recurrent:
            groups: Dict[int, List[Tuple[int, SlotTask]]] = {}
            for s, task in new:
                groups.setdefault(len(task.payload.prompt),
                                  []).append((s, task))
            finished = list(pre_finished)
            for plen in sorted(groups):
                finished += self._prefill_group(groups[plen], plen)
            return finished, len(new)
        plen = pow2_bucket(
            max(len(t.payload.prompt) for _, t in new), self.max_len)
        return pre_finished + self._prefill_group(new, plen), len(new)

    def _prefill_group(self, new: List[Tuple[int, SlotTask]], plen: int
                       ) -> List[int]:
        """Prefill one sub-batch whose prompts all fit in ``plen``: one
        prefill on each block's device for the slots it owns, all launched
        before the first copy of logits to the host."""
        runs = []
        for sh, members in self._by_shard(new):
            nb = pow2_bucket(len(members), sh.hi - sh.lo)
            self._maybe_tune_prefill(nb, plen)
            tokens = np.zeros((nb, plen), np.int32)
            lengths = np.ones((nb,), np.int32)
            # pad rows carry an index past the block: dropped
            slot_idx = np.full((nb,), self.capacity, np.int64)
            for i, (s, task) in enumerate(members):
                p = task.payload.prompt
                tokens[i, :len(p)] = p
                lengths[i] = len(p)
                slot_idx[i] = s - sh.lo
            if self._staged:
                logits = self._run_staged(
                    sh, "prefill", (nb, plen),
                    lambda rows, sh=sh, nb=nb, plen=plen:
                        self._prefill_body(sh, nb, plen, rows),
                    tokens, lengths, slot_idx)
            else:
                logits, sh.caches = self._prefill_scatter(
                    sh, tokens, lengths, slot_idx, sh.caches)
            runs.append((members, logits, lengths))
        finished = []
        for members, logits, lengths in runs:
            logits = logits.cpu().numpy()
            for i, (s, task) in enumerate(members):
                req = task.payload
                tok = self._sample_task_row(logits[i], task, int(lengths[i]))
                task.state = {"out": list(req.prompt) + [tok],
                              "left": req.max_new_tokens - 1}
                self._emit(task.rid, tok)
                self._tok[s] = tok
                self._pos[s] = lengths[i]
                if task.state["left"] <= 0 or self._pos[s] >= self.max_len:
                    finished.append(s)
        return finished

    # -- paged-cache admission / lifecycle ---------------------------------

    def _admit_paged(self, new: List[Tuple[int, SlotTask]]
                     ) -> Tuple[List[int], int]:
        """Paged admission.  Resumed tasks splice their saved table row
        back (or re-import a host spill); fresh tasks look their prompt up
        in the prefix index and prefill only past the longest hit.

        Fresh tasks are processed in waves of equal prefix-hit length,
        shortest first, and a wave defers any task whose *next* page hash
        duplicates a groupmate's — that page registers when the
        representative's group prefills, so the deferred task re-checks and
        picks the hit up.  Two identical system prompts submitted in the
        same tick therefore still prefill the shared span exactly once."""
        pages = self._pages
        ps = pages.page_size
        resume = [(s, t) for s, t in new
                  if "resume_pages" in t.state or "resume_spill" in t.state]
        resumed = {id(t) for _, t in resume}
        fresh = [(s, t) for s, t in new if id(t) not in resumed]
        pre_finished: List[int] = []
        for s, task in resume:
            sh = self._shard_of(s)
            if "resume_spill" in task.state:
                payload, n = task.state.pop("resume_spill")
                pgs = self._alloc_pages(n, s)
                sh.pool = pages.import_pages(sh.pool, payload,
                                             self._local_pages(sh, pgs))
            else:
                pgs = self._move_pages(task.state.pop("resume_pages"), s)
            pages.bind_slot(s, pgs)
            self._tok[s] = task.state.pop("resume_tok")
            self._pos[s] = task.state.pop("resume_pos")
            if task.state["left"] <= 0 or self._pos[s] >= self.max_len:
                pre_finished.append(s)
        if not fresh:
            return pre_finished, 0
        infos: List[List[Any]] = []
        for s, task in fresh:
            hashes = (pages.chain_hashes(task.payload.prompt)
                      if self._prefix_cache else [])
            hits = pages.acquire_prefix(hashes, slot=s) if hashes else []
            infos.append([s, task, hashes, hits])
        finished = list(pre_finished)
        while infos:
            min_hit = min(len(info[3]) for info in infos)
            group, defer, seen_next = [], [], set()
            for info in infos:
                if len(info[3]) != min_hit:
                    defer.append(info)
                    continue
                nxt = info[2][min_hit] if min_hit < len(info[2]) else None
                if nxt is not None and nxt in seen_next:
                    defer.append(info)
                    continue
                if nxt is not None:
                    seen_next.add(nxt)
                group.append(info)
            finished += self._prefill_paged_group(group, min_hit * ps)
            for info in defer:   # hits can only grow as groups register
                info[3] += pages.extend_prefix(info[2], len(info[3]),
                                               slot=info[0])
            infos = defer
        return finished, len(fresh)

    def _prefill_paged_group(self, group: List[List[Any]], off: int
                             ) -> List[int]:
        """Prefill one wave of tasks sharing prefix-hit length ``off`` (0 =
        full prefill), one prefill on each block's device for the slots it
        owns.  Suffixes pad to the dense engine's pow2 bucket (so full
        prefills compute what the dense path computes), pages past each
        task's own span map to the drop sentinel, and full suffix pages
        register into the prefix index."""
        pages = self._pages
        ps = pages.page_size
        smax = max(len(info[1].payload.prompt) - off for info in group)
        splen = pow2_bucket(smax, self.max_len - off)
        npg = -(-splen // ps)
        hit_reqs = hit_pages = 0
        runs = []
        for sh, members in self._by_shard(group):
            nb = pow2_bucket(len(members), sh.hi - sh.lo)
            if off == 0:
                self._maybe_tune_prefill(nb, splen)
            tokens = np.zeros((nb, splen), np.int32)
            lengths = np.ones((nb,), np.int32)
            slot_idx = np.full((nb,), self.capacity, np.int64)  # pads: OOB
            # the sentinel n_pages lies past every block: dropped
            page_rows = np.full((nb, npg), pages.n_pages, np.int64)
            prefix_rows = np.zeros((nb, off // ps), np.int64)
            for i, (s, task, hashes, hits) in enumerate(members):
                p = task.payload.prompt
                suffix = p[off:]
                tokens[i, :len(suffix)] = suffix
                lengths[i] = len(suffix)
                slot_idx[i] = s - sh.lo
                # pages covering positions [0, len(p)]: the prompt plus the
                # first decode write; later pages are allocated in _step
                own = self._alloc_pages(len(p) // ps + 1 - len(hits), s)
                allp = list(hits) + own
                pages.bind_slot(s, allp)
                for j in range(len(hits), len(hashes)):
                    pages.register_hash(allp[j], hashes[j])
                base = off // ps
                local = self._local_pages(sh, allp)
                for j in range(min(npg, len(allp) - base)):
                    page_rows[i, j] = local[base + j]
                prefix_rows[i, :] = local[:base]
                if hits:
                    hit_reqs += 1
                    hit_pages += len(hits)
            if self._staged:
                logits = self._run_staged(
                    sh, "paged prefill", (nb, splen, off),
                    lambda rows, sh=sh, nb=nb, splen=splen, npg=npg, off=off:
                        self._prefill_paged_body(sh, off, nb, splen, npg,
                                                 rows),
                    tokens, lengths, slot_idx, page_rows, prefix_rows)
            else:
                logits, sh.pool, sh.residual = self._prefill_paged_impl(
                    sh, off, tokens, lengths, page_rows, prefix_rows,
                    slot_idx)
            runs.append((members, logits))
        finished = []
        for members, logits in runs:
            logits = logits.cpu().numpy()
            for i, (s, task, hashes, hits) in enumerate(members):
                req = task.payload
                tok = self._sample_task_row(logits[i], task, len(req.prompt))
                task.state = {"out": list(req.prompt) + [tok],
                              "left": req.max_new_tokens - 1}
                self._emit(task.rid, tok)
                self._tok[s] = tok
                self._pos[s] = len(req.prompt)
                if task.state["left"] <= 0 or self._pos[s] >= self.max_len:
                    finished.append(s)
        self._count_pages(
            prefill_ticks=1, prefix_hits=hit_reqs,
            prefix_pages_hit=hit_pages,
            prefill_tokens=sum(len(info[1].payload.prompt) - off
                               for info in group))
        return finished

    def _alloc_pages(self, n: int, slot: int) -> List[int]:
        """Allocate with spill fallback: when the pool is dry, preempted
        (queued) requests' pages move to host memory and free up, so
        admission pressure never fails a losslessly preempted task."""
        if n <= 0:
            return []
        try:
            return self._pages.allocate(n, slot)
        except PagePoolExhausted:
            if not self._spill_preempted():
                raise
            return self._pages.allocate(n, slot)

    def _move_pages(self, pgs: List[int], slot: int) -> List[int]:
        """A preempted task's pages, on the block of the slot it resumes
        in: as they are when that is the block they lie in, else copied
        into fresh pages of the slot's block and released."""
        if not pgs or self._shard_of_page(pgs[0]) is self._shard_of(slot):
            return pgs
        src, dst = self._shard_of_page(pgs[0]), self._shard_of(slot)
        payload = self._pages.export_pages(src.pool,
                                           self._local_pages(src, pgs))
        fresh = self._alloc_pages(len(pgs), slot)
        dst.pool = self._pages.import_pages(dst.pool, payload,
                                            self._local_pages(dst, fresh))
        self._pages.release(pgs)
        self._count_pages(block_moved_pages=len(pgs))
        return fresh

    def _spill_preempted(self) -> bool:
        """Copy every queued preempted task's pages to host memory and
        release them; resume re-imports them into fresh pages.  Returns
        whether anything was spilled."""
        with self._lock:
            targets = [t for t in self._queue if "resume_pages" in t.state]
        spilled = 0
        for task in targets:
            pgs = task.state.pop("resume_pages")
            if pgs:
                sh = self._shard_of_page(pgs[0])
                payload = {k: v.cpu() for k, v in self._pages.export_pages(
                    sh.pool, self._local_pages(sh, pgs)).items()}
            else:
                payload = {}
            task.state["resume_spill"] = (payload, len(pgs))
            self._pages.release(pgs)
            spilled += len(pgs)
        if spilled:
            self._count_pages(spilled_pages=spilled)
        return spilled > 0

    def _ensure_decode_pages(self, active: List[Tuple[int, SlotTask]]
                             ) -> None:
        """Allocate the page under each active slot's write head when the
        decode position crosses a page boundary."""
        pages = self._pages
        for s, _ in active:
            idx = int(self._pos[s]) // pages.page_size
            if pages.page_at(s, idx) < 0:
                pages.set_slot_page(s, idx, self._alloc_pages(1, s)[0])

    def _release_slot(self, slot: int, task: SlotTask) -> None:
        if getattr(self, "_pages", None) is not None:
            pgs = self._pages.unbind_slot(slot)
            if pgs:
                self._pages.release(pgs)

    def _count_pages(self, **counts: int) -> None:
        with self._lock:
            d = self._stats.pages
            for k, v in counts.items():
                d[k] = d.get(k, 0) + int(v)

    def pin_page_hashes(self, hashes: List[Optional[bytes]]
                        ) -> Dict[int, int]:
        """Pin prefix-index hits on this engine's pool (empty when not
        paged, and when the pool is split over several devices: the slot a
        handoff will land in, and so the block its pages must lie in, is
        not known yet)."""
        if self._pages is None or len(self._shards) > 1:
            return {}
        return self._pages.pin_hashes(hashes)

    def release_page_pins(self, pages: List[int]) -> None:
        """Drop references taken by :meth:`pin_page_hashes`."""
        if self._pages is not None and pages:
            self._pages.release(pages)

    @property
    def paged(self) -> bool:
        return self._pages is not None

    @property
    def free_pages(self) -> Optional[int]:
        """Allocatable pages right now (None when not paged) — the
        admission-control backpressure gauge."""
        return self._pages.free_pages if self._pages is not None else None

    @property
    def total_pages(self) -> Optional[int]:
        return self._pages.total_pages if self._pages is not None else None

    def _batch_for(self, n_active: int) -> int:
        return self.capacity            # decode shape pinned by the caches

    def _evict(self, slot: int, task: SlotTask) -> None:
        """Lossless preemption: copy the slot's cache rows (the slot-axis
        gather) plus the pending token and position into ``task.state``;
        the generated tokens already live there.  ``_admit`` re-injects the
        rows wherever the task lands and decoding continues where it
        stopped.

        Paged mode preempts by *reference*: the task keeps its pages and
        only the table row is saved (no device traffic); resume splices the
        row into the new slot.  If the pool later runs dry,
        ``_spill_preempted`` demotes the references to a host copy."""
        if self._pages is not None:
            task.state["resume_pages"] = self._pages.unbind_slot(slot)
            task.state["resume_tok"] = int(self._tok[slot])
            task.state["resume_pos"] = int(self._pos[slot])
            return
        sh = self._shard_of(slot)
        task.state["resume_rows"] = self._gather_rows(sh, [slot - sh.lo])
        task.state["resume_tok"] = int(self._tok[slot])
        task.state["resume_pos"] = int(self._pos[slot])

    def _maybe_tune_prefill(self, nb: int, plen: int) -> None:
        """Measured flash-attention tuning for one exact prefill bucket
        (``kernel_tune=True`` engines on the card only).  The first
        admission at a new ``(nb, plen)`` bucket measures the kernel's
        candidates on random inputs of the model's compute type; later
        admissions hit the cache.  The measurement is kept out of the tick
        wall the SLO scheduler and the stats observe."""
        if (not self.kernel_tune or self.cfg.attn_impl != "cuda"
                or self.device.type != "cuda"):
            return
        from repro_torch.kernels import tuning as ktuning
        from repro_torch.kernels.registry import registry as kernel_registry

        kspec = kernel_registry.get("flash_attention")
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)

        def rnd(heads):
            return torch.randn((nb, plen, heads, cfg.head_dim),
                               generator=gen, device=self.device
                               ).to(cfg.cdtype())

        q, k, v = rnd(cfg.n_heads), rnd(cfg.n_kv_heads), rnd(cfg.n_kv_heads)
        cache = ktuning.default_cache()
        if cache.get(ktuning.cache_key_for(kspec, (q, k, v))) is None:
            t0 = time.perf_counter()
            ktuning.autotune(
                kspec, (q, k, v),
                {"causal": True, "softmax_mode": cfg.softmax_mode},
                cache=cache)
            self._exclude_tick_time(time.perf_counter() - t0)

    def _step(self, active: List[Tuple[int, SlotTask]], n_batch: int
              ) -> Tuple[List[int], int]:
        """One decode tick: ``lm.decode_step`` (and, with the kernels, one
        ``fused_sampling`` launch) on each block, back to back, then
        each block's tokens (or logits) copied to the host.  The dense
        family's kernel tick is staged (:meth:`_tick_shard`)."""
        tables = None
        if self._pages is not None:
            self._ensure_decode_pages(active)
            tables = self._pages.tables_snapshot()
        # each token's sampling counter is the position it will occupy
        pos_of = lambda s: int(self._pos[s]) + 1          # noqa: E731
        outs = []
        if self._staged:
            for sh in self._shards:
                mine = [(s, t) for s, t in active if sh.lo <= s < sh.hi]
                outs.append(self._tick_shard(sh, mine, tables, pos_of))
            return self._finish_tick(
                active, np.concatenate([o.cpu().numpy() for o in outs]))
        toks = self._blocks(self._tok[:, None])
        poss = self._blocks(self._pos)
        for sh, tok, pos in zip(self._shards, toks, poss):
            if tables is not None:
                logits, sh.pool = self._decode_paged_impl(
                    sh, tok, pos, self._local_tables(sh, tables))
            else:
                logits, sh.caches = self._decode(sh, tok, pos, sh.caches)
            if self._decode_kernel:
                # fused sampling where the logits are
                mine = [(s, t) for s, t in active if sh.lo <= s < sh.hi]
                self._observe_logits(logits, mine, pos_of, sh.lo)
                logits = self._sample_batch_device(logits, mine, pos_of,
                                                   sh.lo)
            outs.append(logits)
        return self._finish_tick(
            active, np.concatenate([o.cpu().numpy() for o in outs]))

    @staticmethod
    def _local_tables(sh: _Shard, tables: np.ndarray) -> np.ndarray:
        """Block ``sh``'s rows of the page tables in its local page ids
        (-1 stays unmapped)."""
        rows = tables[sh.lo:sh.hi]
        return np.where(rows >= 0, rows - sh.page_lo, -1)

    # -- the staged decode tick ----------------------------------------------

    @property
    def _staged(self) -> bool:
        """Whether decode ticks are staged and, on the card, replayed from
        a CUDA graph: the dense family with the decode kernels, over dense
        caches or pages."""
        return self._decode_kernel and self.cfg.family == "dense"

    def _tick_width(self, sh: _Shard) -> int:
        """int32 words of a block's staged tick: tokens, positions, the
        five sampling rows, then (paged) the table rows."""
        n = sh.hi - sh.lo
        pages = (n * self._pages.pages_per_slot if self._pages is not None
                 else 0)
        return 7 * n + pages

    def _stage_rows(self, sh: _Shard, active, tables, pos_of) -> np.ndarray:
        """Block ``sh``'s staged tick on the host, as the unstaged tick
        passes it: pending tokens, positions, the sampling rows of
        ``active`` and (paged) the table rows in local page ids."""
        n = sh.hi - sh.lo
        out = np.empty((self._tick_width(sh),), np.int32)
        out[:n] = self._tok[sh.lo:sh.hi]
        out[n:2 * n] = self._pos[sh.lo:sh.hi]
        out[2 * n:7 * n] = self._sampling_rows(n, active, pos_of,
                                               sh.lo).reshape(-1)
        if tables is not None:
            out[7 * n:] = self._local_tables(sh, tables).reshape(-1)
        return out

    def _tick_body(self, sh: _Shard, rows: torch.Tensor):
        """What block ``sh``'s graph captures: one decode step over its
        caches (or pool) and one fused_sampling launch, reading only the
        staged ``rows`` (int32, :meth:`_stage_rows`' layout) on the
        device.  Returns (tokens (n,) int32, logits (n, V))."""
        from repro_torch import kernels

        n = sh.hi - sh.lo
        batch = {"tokens": rows[:n].view(n, 1), "pos": rows[n:2 * n]}
        sampling = rows[2 * n:7 * n].view(5, n)
        if self._pages is not None:
            tree = self._pages.pool_tree(sh.pool, sh.residual)
            logits, _ = lm.decode_step(sh.params, self.cfg, batch, tree,
                                       paged_tables=rows[7 * n:].view(n, -1))
        else:
            logits, _ = lm.decode_step(sh.params, self.cfg, batch, sh.caches)
        return kernels.fused_sampling_rows(logits, sampling,
                                           tune=False), logits

    def _tick_call(self, sh: _Shard):
        """Block ``sh``'s staged call and pinned host buffer, made at its
        first tick (and again if the tuning policy changed since:
        :func:`repro_torch.graphs.config_key`)."""
        from repro_torch import graphs

        key = graphs.config_key()
        if sh.tick is None or sh.tick.key != key:
            width = self._tick_width(sh)
            sh.tick_host = torch.zeros((width,), dtype=torch.int32,
                                       pin_memory=sh.device.type == "cuda")
            sh.tick = graphs.CapturedCall(
                lambda rows, sh=sh: self._tick_body(sh, rows),
                {"rows": torch.zeros((width,), dtype=torch.int32,
                                     device=sh.device)},
                name=f"ServeEngine decode tick (block {sh.index})",
                keep=(1,))
            sh.tick.key = key
        return sh.tick

    def _tick_reads(self, sh: _Shard) -> List[torch.Tensor]:
        """What a block's graph reads and writes in place: its parameters
        and its caches, or its pool and residual leaves."""
        state = (sh.caches if self._pages is None
                 else [sh.pool, sh.residual or {}])
        return tree_leaves(sh.params) + tree_leaves(state)

    def _tick_shard(self, sh: _Shard, active, tables, pos_of
                    ) -> torch.Tensor:
        """Block ``sh``'s staged decode tick: its rows packed on the host
        and staged in one copy, then its call (the graph replayed, or
        captured at the first tick, whose capture seconds are kept out of
        the tick wall; eagerly on the CPU); returns its tokens on its
        device."""
        call = self._tick_call(sh)
        sh.tick_host.numpy()[:] = self._stage_rows(sh, active, tables,
                                                   pos_of)
        call.stage(rows=sh.tick_host)
        tokens, logits = call(reads=self._tick_reads(sh))
        self._exclude_tick_time(call.last_capture_s)
        self._observe_logits(logits, active, pos_of, sh.lo)
        return tokens

    # -- the staged admission calls ----------------------------------------
    #
    # The reference's jitted _prefill, _prefill_paged, _gather and _inject
    # (src/repro/serving/engine.py:144-167), dense family: each staged from
    # one int32 buffer (a fresh pinned host copy, one copy to the device)
    # and, on the card, replayed from a graph captured per block and shape
    # key, as the reference's jit retraces per shape; on the CPU the same
    # body runs eagerly.

    def _run_staged(self, sh: _Shard, kind: str, key: tuple, body,
                    *parts: np.ndarray, inputs=None, stage=None) -> Any:
        """``body(rows, **other inputs)`` as block ``sh``'s staged call of
        ``kind`` at ``key`` (and the tuning policy,
        :func:`repro_torch.graphs.config_key`), made at first use:
        ``parts`` packed as int32 into ``rows`` and staged in one copy;
        ``inputs()`` makes the call's other static inputs and
        ``stage(inputs)`` fills them before each run.  Capture seconds are
        kept out of the tick wall."""
        from repro_torch import graphs

        words = np.concatenate([np.asarray(p).reshape(-1) for p in parts]
                               ).astype(np.int32)
        full = (kind, key, graphs.config_key())
        call = sh.calls.get(full)
        if call is None:
            call = sh.calls[full] = graphs.CapturedCall(
                body, {"rows": torch.zeros(words.shape, dtype=torch.int32,
                                           device=sh.device),
                       **(inputs() if inputs is not None else {})},
                name=f"ServeEngine {kind} {key} (block {sh.index})")
        host = torch.from_numpy(words)
        if sh.device.type == "cuda":
            # a fresh pinned copy: the caching host allocator keeps it
            # until the asynchronous copy has read it
            host = host.pin_memory()
        call.stage(rows=host)
        if stage is not None:
            stage(call.inputs)
        out = call(reads=self._tick_reads(sh))
        self._exclude_tick_time(call.last_capture_s)
        return out

    def _prefill_body(self, sh: _Shard, nb: int, plen: int,
                      rows: torch.Tensor) -> torch.Tensor:
        """What block ``sh``'s prefill graph captures (the reference's
        ``_prefill``): :meth:`_prefill_scatter` on its caches, reading the
        staged tokens (nb, plen), lengths and slot indices; returns the
        first-token logits."""
        tokens = rows[:nb * plen].view(nb, plen)
        lengths = rows[nb * plen:nb * plen + nb]
        slot_idx = rows[nb * plen + nb:nb * plen + 2 * nb]
        return self._prefill_scatter(sh, tokens, lengths, slot_idx,
                                     sh.caches)[0]

    def _prefill_paged_body(self, sh: _Shard, off: int, nb: int, splen: int,
                            npg: int, rows: torch.Tensor) -> torch.Tensor:
        """What block ``sh``'s paged prefill graph captures (the
        reference's ``_prefill_paged``, ragged at ``off`` 0, a continuation
        past it): :meth:`_prefill_paged_impl` on its pool, reading the
        staged tokens (nb, splen), lengths, slot indices, page map (nb,
        npg) and prefix rows (nb, off // page_size); returns the
        first-token logits."""
        cuts = np.cumsum([0, nb * splen, nb, nb, nb * npg,
                          nb * (off // self._pages.page_size)])
        tokens, lengths, slot_idx, page_map, prefix = (
            rows[a:b] for a, b in zip(cuts[:-1], cuts[1:]))
        return self._prefill_paged_impl(
            sh, off, tokens.view(nb, splen), lengths, slot_idx=slot_idx,
            page_map=page_map.view(nb, npg),
            prefix_rows=prefix.view(nb, off // self._pages.page_size))[0]

    def _gather_rows(self, sh: _Shard, local: List[int]) -> Any:
        """Copies of block ``sh``'s cache rows at the block-local slots
        ``local`` (preemption; the reference's ``_gather``): staged and,
        on the card, a graph per block and row count for the dense
        kernel path; ``lm.gather_cache_rows`` as it is otherwise."""
        if not self._staged:
            return lm.gather_cache_rows(self.cfg, local, sh.caches)
        return self._run_staged(
            sh, "gather", (len(local),),
            lambda rows, sh=sh: lm.gather_cache_rows(self.cfg, rows,
                                                     sh.caches),
            np.asarray(local))

    def _inject_rows(self, sh: _Shard, local: List[int],
                     rows_list: List[Any]) -> None:
        """Write gathered row trees (one slot each, on ``sh``'s device)
        into block ``sh``'s caches at the block-local slots ``local`` (a
        resume; the reference's ``_inject``): staged and, on the card, a
        graph per block and row count for the dense kernel path, the rows
        copied into the call's static row tree; otherwise concatenated and
        scattered as they are."""
        if not self._staged:
            sh.caches = lm.scatter_cache_rows(
                self.cfg, np.asarray(local, np.int64),
                lm.concat_cache_rows(self.cfg, rows_list), sh.caches)
            return
        k = len(local)
        like, names, axes = self._inject_tree(k)

        def body(rows, **leaves):
            lm.scatter_cache_rows(
                self.cfg, rows,
                tree_unflatten(like, [leaves[n] for n in names]), sh.caches)

        def inputs():
            return {n: torch.zeros(leaf.shape, dtype=leaf.dtype,
                                   device=sh.device)
                    for n, leaf in zip(names, tree_leaves(like))}

        def stage(static):
            for j, rows in enumerate(rows_list):
                for n, ax, src in zip(names, axes, tree_leaves(rows)):
                    static[n].narrow(ax, j, 1).copy_(src)

        self._run_staged(sh, "inject", (k,), body, np.asarray(local),
                         inputs=inputs, stage=stage)

    def _inject_tree(self, k: int) -> tuple:
        """A staged inject of ``k`` rows: its row tree (a cache tree of
        ``k`` slots on the meta device), the names of its leaves as the
        call's static inputs and each leaf's slot axis, made once per
        ``k``."""
        got = self._inject_trees.get(k)
        if got is None:
            like = lm.make_caches(self.cfg, k, self.max_len, device="meta")
            got = self._inject_trees[k] = (
                like, [f"leaf{i}" for i in range(len(tree_leaves(like)))],
                tree_leaves(lm.cache_batch_axes(self.cfg)))
        return got

    def graph_stats(self, kind: str = "tick") -> Dict[str, float]:
        """The graphs of the staged decode tick (``kind`` "tick"), of one
        kind of staged admission call ("prefill", "paged prefill",
        "gather", "inject") or of all of them ("all"), over every block:
        captured, re-captured and replayed, eager runs, and capture
        seconds (kept out of the tick wall)."""
        from repro_torch import graphs

        calls = ([sh.tick for sh in self._shards]
                 if kind in ("tick", "all") else [])
        calls += [c for sh in self._shards for key, c in sh.calls.items()
                  if kind in (key[0], "all")]
        return graphs.graph_stats(calls)

    def _finish_tick(self, active: List[Tuple[int, SlotTask]],
                     host: np.ndarray) -> Tuple[List[int], int]:
        """The tick's tokens (kernel path) or logits rows, by slot, onto
        the tasks."""
        finished = []
        for s, task in active:
            if self._decode_kernel:
                nxt = int(host[s])
            else:
                nxt = self._sample_task_row(host[s], task,
                                            int(self._pos[s]) + 1)
            task.state["out"].append(nxt)
            task.state["left"] -= 1
            self._emit(task.rid, nxt)
            self._pos[s] += 1
            self._tok[s] = nxt
            if task.state["left"] <= 0 or self._pos[s] >= self.max_len:
                finished.append(s)
        return finished, len(active)

    def _request_class(self, request: Request) -> str:
        """Latency histogram key: prompts bucketed to powers of two, so
        p50/p95 are reported per prefill-cost class (``"lm/p8"`` = prompt
        length in (4, 8])."""
        return f"lm/p{pow2_bucket(len(request.prompt), self.max_len)}"

    def _finalize(self, entry, latency_s: float) -> Completion:
        tokens = (entry.tasks[0].state["out"] if entry.tasks
                  else list(entry.request.prompt))   # max_new_tokens <= 0
        return Completion(rid=entry.request.rid, tokens=tokens,
                          latency_s=latency_s)

    def stats(self):
        """Engine stats; paged engines also merge the pool's allocation,
        eviction and pin counters into ``stats().pages`` beside the
        engine's prefill and prefix-hit counters."""
        st = super().stats()
        if self._pages is not None:
            merged = self._pages.counters()
            merged.update(st.pages)
            st.pages = merged
        return st


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
