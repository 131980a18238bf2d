#!/usr/bin/env python
"""Where two schedules of the same seeded requests part, on the card.

``chip_smoke.py`` holds the sampling contract across schedules: a seeded
request's token drawn from a bit-identical logits row must be the same in
every schedule, and it reports, per sampled request, the first step whose
logits row differs.  This tool runs the same schedules of the same
requests (full-width llama3.2-1b, random weights from seed 0: serve_lm's
16 requests together in 8 slots against each alone, at 3 slots, under
memory pressure and disaggregated over each transport; serve_paged's
pressured runs against their unpressured ones, bf16 and int8 pages) and,
for every sampled request whose logits differ, re-runs both schedules
with the engine's prefill and decode calls traced op by op: each op's
output cut to that request's rows is kept, and the first op whose output
differs bit for bit is named with where in the port it was called and,
for a kernel of the port, the launch config it resolved.

It needs one CUDA device and builds the kernels as ``chip_smoke.py``
does.  Every run is eager (``repro_torch.graphs.eager``): a captured
decode tick calls nothing back in Python to trace.  From the repo root, on
the card::

    python3 tools/trace_seeded.py

It prints one JSON object a line: the card (``nvidia-smi``'s name and
power limit), then per comparison the readings and the first differing op
of each request whose logits part.  Run it when ``chip_smoke.py``'s
seeded readings change; ROADMAP §C records what it found.  An op it
names is a lead, to be confirmed by launching that op alone at both batch
shapes (as ``chip_smoke.py``'s ``gemm_probe`` does for the prefill GEMM)
before it is recorded as the cause: ops are paired between the two runs
by name and shape, and a difference the pairing misses moves the blame to
a later op.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from repro_torch.kernels.registry import registry  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

DEVICE = cs.DEVICE


# ops that compute nothing (views and allocations): not recorded
NOT_COMPUTED = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "view", "_unsafe_view", "_reshape_alias", "reshape", "t", "transpose",
    "permute", "expand", "slice", "select", "unsqueeze", "squeeze",
    "as_strided", "detach", "alias", "split", "split_with_sizes", "unbind",
    "lift_fresh", "resize_", "set_", "_local_scalar_dense"))
GEMM_OPS = frozenset(("mm", "addmm", "bmm", "baddbmm", "matmul", "linear"))
TRACED_KERNELS = ("flash_attention", "decode_attention", "fused_sampling",
                  "fused_sampling_rows")


def port_caller() -> str:
    """``file:line function`` of the innermost frame in the port."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if "repro_torch" in path:
            return (f"{path.split('repro_torch', 1)[1].lstrip(os.sep)}:"
                    f"{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return "?"


def row_picker(nb: int, i: int, slot: int, n: int, n_slots: int,
               max_len: int, plen=None):
    """The rows of one request in an op's output: a prefill batch (nb,
    plen, ...) or its (nb * plen, ...) flattening -> row ``i``'s first
    ``n`` positions; a slot cache (n_slots, max_len, ...) -> slot
    ``slot``'s first ``n`` rows; anything else batched (nb, ...) -> row
    ``i`` (in decode, ``i`` is the slot and nb the slots)."""
    def pick(t):
        if t.dim() == 0:
            return None
        if (plen is not None and t.dim() >= 2 and t.shape[0] == nb
                and t.shape[1] == plen):
            return t[i, :n]
        if t.dim() >= 2 and t.shape[0] == n_slots and t.shape[1] == max_len:
            return t[slot, :n]
        if plen is not None and t.shape[0] == nb * plen:
            return t.reshape(nb, plen, *t.shape[1:])[i, :n]
        if t.shape[0] == nb:
            return t[i]
        return None
    return pick


class OpTrace(TorchDispatchMode):
    """Every op run under it, in order, with its output cut to the rows of
    each traced request (``picks``: key -> row_picker) and copied, and
    where in the port it was called from; the kernel wrappers' outputs are
    recorded by ``armed`` as ``kernel.<name>`` with their resolved
    config."""

    def __init__(self, picks: dict):
        super().__init__()
        self.picks = picks
        self.ops = {key: [] for key in picks}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in NOT_COMPUTED:
            self.record(f"aten.{name}", out)
        return out

    def record(self, name: str, out, config=None) -> None:
        """Keep ``out`` cut to each request's rows.  An aten op's integer
        outputs are skipped: they hold indices and positions, which are the
        schedule's own."""
        floats_only = not name.startswith("kernel.")
        where = port_caller()
        with _disable_current_modes():
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (not isinstance(t, torch.Tensor)
                        or t.device.type != torch.device(DEVICE).type
                        or (floats_only and not t.is_floating_point())):
                    continue
                for key, pick in self.picks.items():
                    got = pick(t)
                    if got is not None:
                        self.ops[key].append({
                            "op": name, "where": where,
                            "out": torch.empty(
                                got.shape, dtype=got.dtype,
                                device=got.device).copy_(got),
                            "config": config})


def resolved_config(name: str, args, kw) -> dict:
    """The config a kernel wrapper's call resolves to (no tuning)."""
    if name == "fused_sampling_rows":       # the logits decide it
        name, args = "fused_sampling", args[:1]
    kwargs = {k: v for k, v in kw.items()
              if k not in ("tune", "config") and v is not None}
    try:
        return registry.default_config(name, *args, **kwargs)
    except (TypeError, ValueError) as err:
        return {"unresolved": str(err)}


class AllTraced(Exception):
    """Raised by ``armed`` once every target is traced: the rest of the run
    is not needed."""


@contextlib.contextmanager
def armed(targets: set, traces: dict):
    """While open, each ServeEngine prefill group or decode tick that
    computes the logits a target (rid, position) draws from runs under an
    OpTrace cut to that request's rows; ``traces[(rid, position)]`` gets
    its ops (the first such call only).  Once every target has its trace
    the run is cut short by AllTraced, which the block swallows."""
    from repro_torch import kernels as kernels_pkg
    from repro_torch.serving.schedulers import pow2_bucket

    saved = {m: ServeEngine.__dict__[m] for m in
             ("_prefill_group", "_prefill_paged_group", "_step")}
    wrappers = {k: getattr(kernels_pkg, k) for k in TRACED_KERNELS}
    active = []

    def traced(fn, picks):
        if not picks:
            return fn()
        trace = OpTrace(picks)
        active.append(trace)
        try:
            with trace:
                out = fn()
        finally:
            active.pop()
            for key, ops in trace.ops.items():
                traces.setdefault(key, ops)
        if targets <= traces.keys():
            raise AllTraced
        return out

    def wanted(rid, pos):
        return (rid, pos) in targets and (rid, pos) not in traces

    def prefill_group(self, new, plen):
        nb = pow2_bucket(len(new), self.capacity)
        picks = {(t.rid, len(t.payload.prompt)): row_picker(
                     nb, i, s, len(t.payload.prompt), self.capacity,
                     self.max_len, plen)
                 for i, (s, t) in enumerate(new)
                 if wanted(t.rid, len(t.payload.prompt))}
        return traced(lambda: saved["_prefill_group"](self, new, plen), picks)

    def prefill_paged_group(self, group, off):
        nb = pow2_bucket(len(group), self.capacity)
        splen = pow2_bucket(max(len(g[1].payload.prompt) - off
                                for g in group), self.max_len - off)
        picks = {(g[1].rid, len(g[1].payload.prompt)): row_picker(
                     nb, i, g[0], len(g[1].payload.prompt) - off,
                     self.capacity, self.max_len, splen)
                 for i, g in enumerate(group)
                 if wanted(g[1].rid, len(g[1].payload.prompt))}
        return traced(
            lambda: saved["_prefill_paged_group"](self, group, off), picks)

    def step(self, active_slots, n_batch):
        picks = {(t.rid, int(self._pos[s]) + 1): row_picker(
                     self.capacity, s, s, int(self._pos[s]) + 1,
                     self.capacity, self.max_len)
                 for s, t in active_slots
                 if wanted(t.rid, int(self._pos[s]) + 1)}
        return traced(lambda: saved["_step"](self, active_slots, n_batch),
                      picks)

    def kernel_call(name):
        inner = wrappers[name]

        def call(*args, **kw):
            out = inner(*args, **kw)
            if active:
                active[-1].record(f"kernel.{name}", out,
                                  resolved_config(name, args, kw))
            return out
        return call

    ServeEngine._prefill_group = prefill_group
    ServeEngine._prefill_paged_group = prefill_paged_group
    ServeEngine._step = step
    for name in TRACED_KERNELS:
        setattr(kernels_pkg, name, kernel_call(name))
    try:
        yield
    except AllTraced:
        pass
    finally:
        for m, fn in saved.items():
            setattr(ServeEngine, m, fn)
        for name, fn in wrappers.items():
            setattr(kernels_pkg, name, fn)


def op_kind(op: str) -> str:
    if op.startswith("kernel."):
        return "the port's kernel"
    if op.split(".", 1)[1] in GEMM_OPS:
        return "cuBLAS GEMM (library)"
    return "PyTorch op (library)"


def first_differing_op(ops_a: list, ops_b: list) -> dict:
    """The first op of ``ops_a`` (in the order it ran) whose output for the
    request differs bit for bit from its counterpart in ``ops_b``: the
    next op of ``ops_b`` of the same name and output shape and type,
    within 64 ops (a schedule may run ops the other does not, such as a
    paged engine's page writes)."""
    j = compared = 0
    for k, a in enumerate(ops_a):
        m = next((m for m in range(j, min(j + 64, len(ops_b)))
                  if ops_b[m]["op"] == a["op"]
                  and ops_b[m]["out"].shape == a["out"].shape
                  and ops_b[m]["out"].dtype == a["out"].dtype), None)
        if m is None:
            continue
        b, j = ops_b[m], m + 1
        compared += 1
        x, y = a["out"].reshape(-1), b["out"].reshape(-1)
        if torch.equal(x.view(torch.uint8), y.view(torch.uint8)):
            continue
        differ = (x != y).reshape(a["out"].shape)
        rows = (differ.reshape(differ.shape[0], -1).any(-1)
                if differ.dim() else differ.reshape(1))
        return {"op": a["op"], "kind": op_kind(a["op"]),
                "where": a["where"], "where_other": b["where"],
                "index": k, "ops_compared": compared,
                "shape": list(a["out"].shape), "dtype": str(a["out"].dtype),
                "max_abs_diff": (float((x.float() - y.float()).abs().max())
                                 if x.is_floating_point() else None),
                "first_differing_row": int(rows.nonzero()[0, 0]),
                "config": a["config"], "config_other": b["config"]}
    return {"op": None, "ops_compared": compared, "ops": len(ops_a),
            "ops_other": len(ops_b)}


def keys_of(found) -> set:
    """The (rid, position) calls to trace for requests ``found`` (rid,
    first differing position, prompt length): the prefill and the step
    whose logits first differ."""
    return {(rid, p) for rid, pos, n in found for p in (n, pos)}


def diagnose(base_run, run, found) -> dict:
    """For each request of ``found`` (rid, first position whose logits
    differ, prompt length), one at a time, the first differing op of its
    prefill and of the step at that position: the base schedule
    (``base_run(None)``) and the other (``run(None, {rid})``) are each
    re-run under ``armed``, which stops a run once its calls are traced."""
    out = {}
    for rid, pos, n in found:
        base, other = {}, {}
        with armed(keys_of([(rid, pos, n)]), base):
            base_run(None)
        with armed(keys_of([(rid, pos, n)]), other):
            run(None, {rid})
        out[rid] = {f"step {p - n}": first_differing_op(
                        base.get((rid, p), []), other.get((rid, p), []))
                    for p in sorted({n, pos})}
        del base, other
        torch.cuda.empty_cache()
    return out


def disagg_run(cfg, params, reqs, transport: str):
    """serve_disagg's dense disaggregated engine over ``transport`` on
    ``reqs``, its seeded logits rows kept in ``logits`` when given."""
    def run(logits=None, rids=None):
        eng = cs.disagg_engine(cfg, params, transport)
        if logits is not None:
            for member in eng._members():
                cs.record_seeded_logits(member, logits)
        return {c.rid: c.tokens for c in eng.serve(cs.fresh(reqs))}
    return run


def comparisons(cfg, params) -> dict:
    """name -> (requests, base schedule, {label: other schedule}): the
    schedules chip_smoke.py holds to the sampling contract."""
    reqs, preqs = cs.lm_requests(cfg.vocab), cs.paged_requests(cfg.vocab)
    others = dict(cs.seeded_runs(cfg, params, reqs))
    for transport in cs.DISAGG_TRANSPORTS:
        others[f"disaggregated, {transport}"] = disagg_run(cfg, params, reqs,
                                                           transport)
    out = {"serve_lm": (reqs, lambda logits=None: cs.serve_seeded(
        cs.kernel_engine(cfg, params), reqs, logits), others)}
    for quantize in (False, True):
        mode = "paged_int8" if quantize else "paged"
        out[f"serve_paged ({mode})"] = (
            preqs,
            lambda logits=None, q=quantize: cs.serve_seeded(
                cs.kernel_engine(cfg, params, page_size=cs.PAGE,
                                 quantize_pages=q), preqs, logits),
            {"pressured": lambda logits=None, rids=None, q=quantize:
                cs.pressured_serve(cfg, params, q, preqs, logits)[0]})
    return out


def main() -> None:
    cs.phase_device()
    cs.phase_build()
    print(json.dumps({"device": cs.nvidia_smi_line()}), flush=True)
    cfg, params, _, _ = cs.init_lm()
    with cs.graphs.eager():
        compare_all(cfg, params)


def compare_all(cfg, params) -> None:
    for name, (reqs, base_run, others) in comparisons(cfg, params).items():
        rows = {}
        base = (base_run(rows), cs.rows_on_host(rows))
        for label, run in others.items():
            t0 = time.perf_counter()
            rows = {}
            tok = run(rows)
            numbers, found = cs.compare_seeded(f"{name} ({label})", reqs,
                                               base, (tok, rows))
            del rows
            print(json.dumps({
                "comparison": name, "schedule": label, **numbers,
                "first_differing_op": diagnose(base_run, run, found),
                "seconds": time.perf_counter() - t0}, default=str),
                flush=True)


if __name__ == "__main__":
    main()
