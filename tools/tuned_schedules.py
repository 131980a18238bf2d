#!/usr/bin/env python
"""ROADMAP §C Open 2 on the card, with the tuned decode config keyed with
and without the batch.

``chip_smoke.py``'s ``serve_tuned`` holds serve_tuned's requests, every one
sampled, through ``kernel_tune=True`` engines of 8 and of 3 slots
(``chip_smoke.tuned_schedules``): the sampling contract between the two
schedules and the decode configs each engine resolved.  It runs the
port as it is, whose decode spec keys its tuned config without the batch
(``KernelSpec.batch_free_key``).  This tool runs the same comparison
twice, each on a fresh tune cache: once with the batch put back into the
key (as the reference keys its ``kv_block``,
``src/repro/kernels/tuning.py:364``), once as the port keys it, and prints
each reading; with the batch in the key the two engines may tune other
split counts, whose sums part a slot's logits rows.

It needs one CUDA device and builds the kernels as ``chip_smoke.py``
does.  From the repo root, on the card::

    python3 tools/tuned_schedules.py

One JSON object a line: the card (``nvidia-smi``'s name and power
limit), then each keying's reading.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (exits without a CUDA device)
from repro_torch.kernels import tuning  # noqa: E402


def reading(cfg, params, reqs, batch_free: bool) -> dict:
    """``chip_smoke.tuned_schedules`` on a fresh tune cache, the decode
    spec keyed with (``batch_free`` False) or without the batch; where
    the two engines resolved other configs the reading says so instead of
    failing."""
    spec = cs.registry.get("decode_attention")
    cs.registry.register(dataclasses.replace(spec,
                                             batch_free_key=batch_free))
    root = tempfile.mkdtemp(prefix="tuned_schedules_")
    failures = []
    fail = cs.fail
    cs.fail = failures.append
    try:
        cs.use_cache_dir(root)
        out = cs.tuned_schedules(cfg, params, reqs)
    finally:
        cs.fail = fail
        cs.registry.register(spec)
        tuning.default_cache().clear_memory()
        shutil.rmtree(root, ignore_errors=True)
    return {"batch_free_key": batch_free, **out, "would_fail": failures}


def main() -> None:
    cs.phase_device()
    cs.phase_build()
    print(json.dumps({"device": cs.nvidia_smi_line()}), flush=True)
    before = os.environ.get(tuning.CACHE_ENV)
    cfg, params, _, _ = cs.init_lm()
    reqs = cs.lm_requests(cfg.vocab, cs.SERVE_TUNED_LM_REQUESTS)
    try:
        for batch_free in (False, True):
            print(json.dumps(reading(cfg, params, reqs, batch_free)),
                  flush=True)
    finally:
        if before is None:
            os.environ.pop(tuning.CACHE_ENV, None)
        else:
            os.environ[tuning.CACHE_ENV] = before


if __name__ == "__main__":
    main()
