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
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import LMConfig
from repro_torch.serving.core import EngineCore, SlotTask
from repro_torch.serving.pages import PagePool, PagePoolExhausted
from repro_torch.serving.schedulers import Scheduler, pow2_bucket


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
    ``device=None`` means the card (and raises when there is none).
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
        self.device = resolve_device(device)
        self.params = lm.compute_params(cfg, _to_device(params, self.device))
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
        super().__init__(capacity=n_slots, scheduler=scheduler, clock=clock,
                         kernel_tune=kernel_tune)
        if self._pages is not None:
            # no dense slot caches: resident capacity is bounded by pages,
            # not slots x max_len (generate() makes caches of its own)
            self._caches = None
            self._pool = self._pages.init_pool_arrays(self.device)
            self._residual = self._pages.init_residual_arrays(self.device)
        else:
            self._caches = lm.make_caches(cfg, n_slots, max_len, self.device)
        self._tok = np.zeros((n_slots,), np.int32)   # pending token per slot
        self._pos = np.zeros((n_slots,), np.int32)   # its cache index

    # -- device steps --------------------------------------------------------

    def _to_dev(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _prefill_scatter(self, tokens: np.ndarray, lengths: np.ndarray,
                         slot_idx: np.ndarray, caches: Any):
        """Prefill a (bucketed) sub-batch on fresh caches, then scatter its
        rows into ``caches`` at ``slot_idx`` (pad rows carry an index past
        the slots and are dropped); returns (logits on the device, caches).
        Admission cost scales with the admitted slots, not the capacity."""
        sub = lm.make_caches(self.cfg, tokens.shape[0], self.max_len,
                             self.device)
        logits, sub = lm.ragged_prefill_step(
            self.params, self.cfg,
            {"tokens": self._to_dev(tokens), "lengths": self._to_dev(lengths)},
            sub)
        return logits, lm.scatter_cache_rows(self.cfg, slot_idx, sub, caches)

    def _decode(self, tok: np.ndarray, pos: np.ndarray, caches: Any):
        return lm.decode_step(
            self.params, self.cfg,
            {"tokens": self._to_dev(tok), "pos": self._to_dev(pos)}, caches)

    def _decode_paged_impl(self, tok: np.ndarray, pos: np.ndarray,
                           tables: np.ndarray, pool: Dict[str, Any],
                           residual: Dict[str, Any]):
        """One paged decode tick; returns (logits on the device, pool).

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
        batch = {"tokens": self._to_dev(tok), "pos": self._to_dev(pos)}
        tables_t = self._to_dev(tables)
        if self._paged_kernel:
            tree = pages.pool_tree(pool, residual)
            logits, tree = lm.decode_step(self.params, self.cfg, batch, tree,
                                          paged_tables=tables_t)
            return logits, pages.pool_untree(tree)[0]
        view = pages.build_view(pool, residual, tables_t)
        logits, view = lm.decode_step(self.params, self.cfg, batch, view)
        return logits, pages.scatter_decode_rows(pool, view, tables_t,
                                                 batch["pos"])

    def _prefill_paged_impl(self, off: int, tokens: np.ndarray,
                            lengths: np.ndarray, page_map: np.ndarray,
                            prefix_rows: np.ndarray, slot_idx: np.ndarray,
                            pool: Dict[str, Any], residual: Dict[str, Any]):
        """Paged (possibly continuation) prefill: a fresh sub cache just
        long enough for the written page span, prefilled from position
        ``off`` (0 = ordinary ragged prefill; > 0 continues from the
        dequantized shared-prefix pages ``prefix_rows``), then scattered
        into the pool at page granularity.  Returns (logits, pool,
        residual)."""
        pages = self._pages
        nb = tokens.shape[0]
        total = off + page_map.shape[1] * pages.page_size
        batch = {"tokens": self._to_dev(tokens),
                 "lengths": self._to_dev(lengths)}
        if off == 0:
            sub = lm.make_caches(self.cfg, nb, total, self.device)
            logits, sub = lm.ragged_prefill_step(self.params, self.cfg,
                                                 batch, sub)
        else:
            sub = pages.make_continuation_caches(pool, prefix_rows, nb,
                                                 total)
            logits, sub = lm.continuation_prefill_step(
                self.params, self.cfg, batch, sub, off)
        pool = pages.write_prefill_pages(pool, sub, page_map, off)
        residual = pages.scatter_residual_rows(
            residual, pages.residual_rows_from(sub), slot_idx)
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

    def _sample_batch_device(self, logits: torch.Tensor, active, pos_of
                             ) -> np.ndarray:
        """Kernel-path sampling: one fused_sampling launch draws every
        slot's token where the logits are; only the (n_slots,) int32 token
        vector is copied to the host (which is also the tick's
        synchronisation).  Free slots sample greedily and are ignored."""
        from repro_torch import kernels

        n = self._tok.shape[0]
        temp = np.zeros((n,), np.float32)
        seeds = np.zeros((n,), np.uint32)
        poss = np.zeros((n,), np.int32)
        tks = np.zeros((n,), np.int32)
        tps = np.ones((n,), np.float32)
        for s, task in active:
            req = task.payload
            temp[s] = float(getattr(req, "temperature", 0.0))
            seeds[s] = self._bind_seed(task)
            poss[s] = pos_of(s)
            tks[s] = int(getattr(req, "top_k", 0) or 0)
            tps[s] = float(getattr(req, "top_p", 1.0))
        toks = kernels.fused_sampling(logits, temp, seeds, poss, top_k=tks,
                                      top_p=tps, tune=False)
        return toks.cpu().numpy()

    # -- single-batch convenience ------------------------------------------

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0) -> List[List[int]]:
        """Batched prefill + greedy/temperature decode on fresh caches of
        its own, sampled on the host.  Ragged-correct for the attention
        families: each prompt keeps its own length and positions, so the
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
        logits, caches = self._prefill_scatter(tokens, lengths,
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
                nxt[:, None], np.minimum(pos, self.max_len - 1), caches)
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
        if resume:
            rows = lm.concat_cache_rows(
                self.cfg, [t.state.pop("resume_rows") for _, t in resume])
            self._caches = lm.scatter_cache_rows(
                self.cfg, np.asarray([s for s, _ in resume], np.int64), rows,
                self._caches)
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
        """Prefill one sub-batch whose prompts all fit in ``plen``."""
        nb = pow2_bucket(len(new), self.capacity)
        self._maybe_tune_prefill(nb, plen)
        tokens = np.zeros((nb, plen), np.int32)
        lengths = np.ones((nb,), np.int32)
        slot_idx = np.full((nb,), self.capacity, np.int64)  # pad rows: OOB
        for i, (s, task) in enumerate(new):
            p = task.payload.prompt
            tokens[i, :len(p)] = p
            lengths[i] = len(p)
            slot_idx[i] = s
        logits, self._caches = self._prefill_scatter(
            self.scheduler.place(tokens), lengths, slot_idx, self._caches)
        logits = logits.cpu().numpy()
        finished = []
        for i, (s, task) in enumerate(new):
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
            if "resume_spill" in task.state:
                payload, n = task.state.pop("resume_spill")
                pgs = self._alloc_pages(n, s)
                self._pool = pages.import_pages(self._pool, payload, pgs)
            else:
                pgs = task.state.pop("resume_pages")
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
            hits = pages.acquire_prefix(hashes) if hashes else []
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
                info[3] += pages.extend_prefix(info[2], len(info[3]))
            infos = defer
        return finished, len(fresh)

    def _prefill_paged_group(self, group: List[List[Any]], off: int
                             ) -> List[int]:
        """Prefill one wave of tasks sharing prefix-hit length ``off`` (0 =
        full prefill).  Suffixes pad to the dense engine's pow2 bucket (so
        full prefills compute what the dense path computes), pages past
        each task's own span map to the drop sentinel, and full suffix
        pages register into the prefix index."""
        pages = self._pages
        ps = pages.page_size
        nb = pow2_bucket(len(group), self.capacity)
        smax = max(len(info[1].payload.prompt) - off for info in group)
        splen = pow2_bucket(smax, self.max_len - off)
        npg = -(-splen // ps)
        if off == 0:
            self._maybe_tune_prefill(nb, splen)
        tokens = np.zeros((nb, splen), np.int32)
        lengths = np.ones((nb,), np.int32)
        slot_idx = np.full((nb,), self.capacity, np.int64)  # pad rows: OOB
        page_rows = np.full((nb, npg), pages.n_pages, np.int64)
        prefix_rows = np.zeros((nb, off // ps), np.int64)
        hit_reqs = hit_pages = 0
        for i, (s, task, hashes, hits) in enumerate(group):
            p = task.payload.prompt
            suffix = p[off:]
            tokens[i, :len(suffix)] = suffix
            lengths[i] = len(suffix)
            slot_idx[i] = s
            # pages covering positions [0, len(p)]: the prompt plus the
            # first decode write; later pages are allocated in _step
            own = self._alloc_pages(len(p) // ps + 1 - len(hits), s)
            allp = list(hits) + own
            pages.bind_slot(s, allp)
            for j in range(len(hits), len(hashes)):
                pages.register_hash(allp[j], hashes[j])
            base = off // ps
            for j in range(min(npg, len(allp) - base)):
                page_rows[i, j] = allp[base + j]
            prefix_rows[i, :] = allp[:base]
            if hits:
                hit_reqs += 1
                hit_pages += len(hits)
        logits, self._pool, self._residual = self._prefill_paged_impl(
            off, self.scheduler.place(tokens), lengths, page_rows,
            prefix_rows, slot_idx, self._pool, self._residual)
        logits = logits.cpu().numpy()
        finished = []
        for i, (s, task, hashes, hits) in enumerate(group):
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

    def _spill_preempted(self) -> bool:
        """Copy every queued preempted task's pages to host memory and
        release them; resume re-imports them into fresh pages.  Returns
        whether anything was spilled."""
        with self._lock:
            targets = [t for t in self._queue if "resume_pages" in t.state]
        spilled = 0
        for task in targets:
            pgs = task.state.pop("resume_pages")
            payload = {k: v.cpu() for k, v in
                       self._pages.export_pages(self._pool, pgs).items()}
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
        paged)."""
        if self._pages is None:
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
        task.state["resume_rows"] = lm.gather_cache_rows(
            self.cfg, [slot], self._caches)
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
        if self._pages is not None:
            self._ensure_decode_pages(active)
            logits, self._pool = self._decode_paged_impl(
                self.scheduler.place(self._tok[:, None]), self._pos,
                self._pages.tables_snapshot(), self._pool, self._residual)
        else:
            logits, self._caches = self._decode(
                self.scheduler.place(self._tok[:, None]), self._pos,
                self._caches)
        if self._decode_kernel:
            # fused sampling where the logits are; each token's counter is
            # the position it will occupy (pos + 1)
            toks = self._sample_batch_device(
                logits, active, lambda s: int(self._pos[s]) + 1)
        else:
            logits = logits.cpu().numpy()
        finished = []
        for s, task in active:
            if self._decode_kernel:
                nxt = int(toks[s])
            else:
                nxt = self._sample_task_row(logits[s], task,
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
