"""ServeEngine: LM decode serving over the shared EngineCore, dense caches.

A fixed batch of ``n_slots`` KV-cache slots (continuous batching): requests
join free slots as they arrive, get a *ragged* batched prefill (per-slot
prompt lengths and position ids), and one ``decode_step`` advances every
slot per tick with per-slot cache indices.  Finished slots are recycled
without disturbing the others.

Ragged prefill is exact for the dense family: prompts are left-aligned with
a zero pad suffix, so causal attention keeps real tokens from attending
pads; each slot's last-token logits seed its generation, and the vector
``pos`` decode masks each slot's cache beyond its own length.

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
are gathered and re-injected on resume).  Paged caches (``page_size``)
come with the paged slice and raise here.
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
                 decode_kernel: bool = False,
                 device: Any = None):
        if page_size is not None:
            raise NotImplementedError(
                "paged KV caches (page_size) are served by the paged slice "
                "of the port, not yet by this one")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"ServeEngine serves the dense family so far, not "
                f"{cfg.family!r}")
        self._decode_kernel = bool(decode_kernel)
        if self._decode_kernel:
            cfg = dataclasses.replace(cfg, decode_impl="cuda")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = lm.compute_params(cfg, _to_device(params, self.device))
        self.n_slots = n_slots
        self.max_len = max_len
        self._seed0 = int(seed)       # base of engine-derived request seeds
        super().__init__(capacity=n_slots, scheduler=scheduler, clock=clock,
                         kernel_tune=kernel_tune)
        self._caches = lm.make_caches(cfg, n_slots, max_len, self.device)
        self._tok = np.zeros((n_slots,), np.int32)   # pending token per slot
        self._pos = np.zeros((n_slots,), np.int32)   # its cache index
        # fused_sampling's work space, allocated at the first device-sampled
        # tick and kept (guarded-by: single ticker thread)
        self._sample_scratch: Optional[torch.Tensor] = None

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
        if logits.is_cuda and (
                self._sample_scratch is None
                or self._sample_scratch.shape[-1] != logits.shape[-1]):
            self._sample_scratch = torch.empty(
                (n, 2, logits.shape[-1]), dtype=torch.float32,
                device=logits.device)
        toks = kernels.fused_sampling(logits, temp, seeds, poss, top_k=tks,
                                      top_p=tps, tune=False,
                                      scratch=self._sample_scratch)
        return toks.cpu().numpy()

    # -- single-batch convenience ------------------------------------------

    def generate(self, prompts: List[List[int]], max_new_tokens: int = 16,
                 temperature: float = 0.0, seed: Optional[int] = None,
                 top_k: int = 0, top_p: float = 1.0) -> List[List[int]]:
        """Batched prefill + greedy/temperature decode on fresh caches of
        its own, sampled on the host.  Ragged-correct: each prompt keeps its
        own length and positions, so the result matches per-request
        generation.  Row ``i`` samples with seed ``(base ^ ((i + 1) *
        0x9E3779B1)) & 0x7FFFFFFF`` (base = ``seed`` or the engine seed)
        and counter = the token's sequence position."""
        b = len(prompts)
        for p in prompts:
            self._check_prompt(p)
        if max_new_tokens <= 0:
            return [list(p) for p in prompts]
        caches = lm.make_caches(self.cfg, b, self.max_len, self.device)
        plen = pow2_bucket(max(len(p) for p in prompts), self.max_len)
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
        slot caches.  Tasks preempted earlier (``_evict`` saved their cache
        rows) take the *resume* path instead: one batched scatter
        re-injects their rows at the new slots and decode continues from
        the saved token and position, exactly as if never preempted."""
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

    def _batch_for(self, n_active: int) -> int:
        return self.capacity            # decode shape pinned by the caches

    def _evict(self, slot: int, task: SlotTask) -> None:
        """Lossless preemption: copy the slot's cache rows (the slot-axis
        gather) plus the pending token and position into ``task.state``;
        the generated tokens already live there.  ``_admit`` re-injects the
        rows wherever the task lands and decoding continues where it
        stopped."""
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
        logits, self._caches = self._decode(
            self.scheduler.place(self._tok[:, None]), self._pos, self._caches)
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


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
