"""Roofline analysis for the H100: three terms per (arch x shape x mesh) from
the dry-run records (:mod:`repro_torch.launch.dryrun`), and the bound of
each hand-written kernel.

    compute term    = flops_per_dev / PEAK_FLOPS                [s]
    memory term     = bytes_per_dev / HBM_BW                    [s]
    collective term = collective_bytes_per_dev / LINK_BW        [s]

Hardware constants, NVIDIA H100 SXM (80 GB HBM3), from its data sheet:
989e12 dense bf16 FLOP/s on the tensor cores, 67e12 float32 FLOP/s outside
them, 3.35e12 B/s HBM, 450e9 B/s NVLink each way, 80e9 bytes of HBM.  The
compute term takes the bf16 peak for every flop, as the reference takes its
one peak: for float32 work it is a bound the card cannot reach, never one
it beats.

``flops_per_dev`` and ``bytes_per_dev`` are op-by-op counts of the eager
step (:mod:`repro_torch.launch.op_cost`).  MODEL_FLOPS = 6 N D for training
and 2 N D for inference (N the active parameters, D the tokens of the
step); MODEL_FLOPS / counted flops shows how much of the counted compute is
"useful" (it exposes remat recompute and other redundancy).

Each kernel of the port has a *work* function (bytes it must move, each
input read once and each output written once, and the operations it does
on this run's data, at the peak of their type) and a *bound* function (the
two as times); ``chip_smoke.py``'s ``bound_ms`` and a kernel wrapper's
cost on the meta device both read them.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Any, Dict, List, Mapping, NamedTuple, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
FP32_FLOP_PER_S = 67e12          # H100 SXM, float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM, bf16 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9       # H100 SXM, NVLink 4, each way
HBM_CAPACITY_BYTES = 80e9        # H100 SXM 80 GB

PEAK_FLOPS = BF16_FLOP_PER_S     # flop/s / card
HBM_BW = HBM_BYTES_PER_S         # bytes/s / card
LINK_BW = NVLINK_BYTES_PER_S     # bytes/s / card, each way


# ---------------------------------------------------------------------------
# Kernel bounds
# ---------------------------------------------------------------------------


class Work(NamedTuple):
    """A kernel call's least work: ``nbytes`` it must move, ``ops`` it must
    do at ``peak`` FLOP/s; ``dot_ops`` of them are products (QK / PV, the
    routing's FC and agreement) and ``transcendentals`` exps and logs."""

    nbytes: float
    ops: float
    peak: float
    dot_ops: float = 0.0
    transcendentals: float = 0.0

    def times(self) -> Tuple[float, float]:
        """(seconds to move the bytes, seconds to do the operations)."""
        return self.nbytes / HBM_BYTES_PER_S, self.ops / self.peak


def elem_bytes(case) -> int:
    """Bytes an element of the case's type."""
    return 2 if case.get("dtype", "float32") == "bfloat16" else 4


def flash_work(case, int8: bool = False) -> Work:
    """Causal attention: 4 * B * H * D operations per unmasked (i, t) pair
    (QK and PV, a multiply and an add each; query i at position q_offset + i
    sees min(T, q_offset + i + 1) keys) at the peak of the case's type (the
    bf16 tensor cores, or float32 outside them); q, k, v read and the
    output written once (2 or 4 bytes an element; int8 K/V at one byte per
    element plus a float32 scale per row of each)."""
    b, s, t, h, k, d = case["dims"]
    width = 2 if case.get("dtype", "float32") == "bfloat16" else 4
    off = case.get("q_offset", 0)
    pairs = (sum(min(t, off + i + 1) for i in range(s))
             if case.get("causal", True) else s * t)
    kv_bytes = (2 * b * t * k * d + 2 * 4 * b * t) if int8 \
        else 2 * width * b * t * k * d
    nbytes = 2 * width * b * s * h * d + kv_bytes
    peak = BF16_FLOP_PER_S if width == 2 else FP32_FLOP_PER_S
    ops = 4 * b * h * d * pairs
    exps = 0 if case.get("softmax_mode") == "taylor" else b * h * pairs
    return Work(nbytes, ops, peak, ops, exps)


def decode_work(case) -> Work:
    """The valid cache rows of K and V read once (2 B per element for bf16;
    1 B per element plus a 4 B scale per row of each for int8), the used
    table entries of a paged cache (4 B each), q and the lengths read and
    the output written once; 4 * H * D operations per valid row."""
    b, t, h, k, d = case["dims"]
    paged = case.get("paged")
    page = paged[1] if paged else t
    lens = [min(max(v, 0), t) for v in case["valid"]]
    rows = sum(lens)
    qbytes = 2 if case.get("dtype") == "bfloat16" else 4
    if case.get("quant"):
        kv_bytes = 2 * rows * (k * d + 4)
    else:
        kv_bytes = 2 * rows * k * d * (2 if case.get("dtype", "float32")
                                       == "bfloat16" else 4)
    table_bytes = 4 * sum(-(-n // page) for n in lens) if paged else 0
    nbytes = kv_bytes + table_bytes + 2 * b * h * d * qbytes + 4 * b
    ops = 4 * rows * h * d
    exps = 0 if case.get("softmax_mode") == "taylor" else rows * h
    return Work(nbytes, ops, BF16_FLOP_PER_S, ops, exps)


def sampling_work(case) -> Work:
    """One read of the logits.  Operations per element, as this case's rows
    need them: the argmax (1); for a row with temperature > 0 also the
    division and the range (3), the hash, the two logarithms and the keep
    test of the draw (about 25), a compare and an add per top-k bisection
    step (60) when 0 < top_k < V, and the exponential, division and sum
    (3) plus a compare and an add per top-p step (60) when top_p < 1."""
    b, v = case["dims"]
    temperature = case.get("temperature", (1.0,) * b)
    top_k = case.get("top_k", (0,) * b)
    top_p = case.get("top_p", (1.0,) * b)
    ops = logs = 0
    for i in range(b):
        ops += 1
        if temperature[i] > 0:
            ops += 3 + 25
            logs += 2
            if 0 < top_k[i] < v:
                ops += 60
            if top_p[i] < 1.0:
                ops += 63
                logs += 1
    return Work(4 * b * v, ops * v, FP32_FLOP_PER_S, 0.0, logs * v)


def routing_work(shape, elem: int = 4, n_iters: int = 3,
                 softmax_mode: str = "taylor") -> Work:
    """u_hat read and v written once in the case's type, c written once in
    float32; the routing's float32 operations at the float32 peak (the FC
    and the agreement are its products; the exact softmax takes an exp a
    logit and the squash a square root a capsule each iteration)."""
    b, i, j, d = shape
    nbytes = elem * (b * i * j * d + b * j * d) + 4 * b * i * j
    dots = (n_iters * 2 * b * i * j * d            # FC
            + (n_iters - 1) * 2 * b * i * j * d)   # agreement
    flops = (dots
             + n_iters * 6 * b * i * j             # softmax
             + n_iters * 6 * b * j * d)            # squash
    exps = n_iters * b * i * j if softmax_mode != "taylor" else 0
    return Work(nbytes, flops, FP32_FLOP_PER_S, dots,
                exps + n_iters * b * j)


def softmax_work(shape, elem: int = 4) -> Work:
    """x read once and the result written once; per element: subtract,
    clamp (2), scale, Horner (10), e^a, 5 squarings, the sum, the division,
    and the maximum (23; the Eq. 2 exp is a polynomial, no
    transcendental)."""
    n = math.prod(shape)
    return Work(2 * elem * n, 23 * n, FP32_FLOP_PER_S)


def softmax_bwd_work(shape, elem: int = 4) -> Work:
    """x and g read once, dx written once; per element the forward's 23
    operations, the derivative's Horner (8), p^31 (4), the clip factor and
    scale (3), the dot's multiply and add, and (g - dot) * e' / S (3)."""
    n = math.prod(shape)
    return Work(3 * elem * n, 43 * n, FP32_FLOP_PER_S)


def gemm_work(case) -> Work:
    """y = x @ w, x (M, K), w (K, N): 2 * M * N * K operations at the peak
    of the case's type (the bf16 tensor cores, or float32 outside them);
    x and w read and y written once."""
    m, n, k = case["dims"]
    width = elem_bytes({"dtype": case.get("dtype", "bfloat16")})
    ops = 2.0 * m * n * k
    peak = BF16_FLOP_PER_S if width == 2 else FP32_FLOP_PER_S
    return Work(width * (m * k + k * n + m * n), ops, peak, ops)


def flash_bound(case, int8: bool = False):
    return flash_work(case, int8).times()


def decode_bound(case):
    return decode_work(case).times()


def sampling_bound(case):
    return sampling_work(case).times()


def routing_bound(shape, elem: int = 4, n_iters: int = 3):
    return routing_work(shape, elem, n_iters).times()


def softmax_bound(shape, elem: int = 4):
    return softmax_work(shape, elem).times()


def softmax_bwd_bound(shape, elem: int = 4):
    return softmax_bwd_work(shape, elem).times()


# registry kernel name -> its work at a case (the registry's example-case
# dicts; routing and the softmaxes take ``shape``)
KERNEL_WORK = {
    "fused_routing": lambda c: routing_work(
        c["shape"], elem_bytes(c), c.get("n_iters", 3),
        c.get("softmax_mode", "exact")),
    "taylor_softmax": lambda c: softmax_work(c["shape"], elem_bytes(c)),
    "taylor_softmax_bwd": lambda c: softmax_bwd_work(c["shape"],
                                                     elem_bytes(c)),
    "flash_attention": flash_work,
    "flash_attention_dequant": lambda c: flash_work(c, int8=True),
    "decode_attention": decode_work,
    "fused_sampling": sampling_work,
    "fixed_order_matmul": gemm_work,
}

# registry kernel name -> (seconds for the bytes, seconds for the operations)
KERNEL_BOUNDS = {name: (lambda c, w=work: w(c).times())
                 for name, work in KERNEL_WORK.items()}


def add_kernel_cost(name: str, case: Mapping[str, Any]) -> None:
    """Charge kernel ``name``'s work at ``case`` to the active cost counters
    (a kernel wrapper given meta tensors; :mod:`op_cost`)."""
    from repro_torch.launch import op_cost

    w = KERNEL_WORK[name](case)
    op_cost.add_kernel(name, w.nbytes, w.ops, w.dot_ops, w.transcendentals)


# ---------------------------------------------------------------------------
# Parameter counts and model flops
# ---------------------------------------------------------------------------


def _lm_param_count(cfg) -> Dict[str, float]:
    """Analytic N (total) and N_active (MoE: shared + top_k experts), the
    reference's formulas."""
    d, dff, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    hd = cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
    embed = V * d * (1 if cfg.tie_embeddings else 2)

    if cfg.family == "moe":
        m = cfg.moe
        expert = 3 * d * m.d_expert
        router = d * m.n_experts
        shared = 3 * d * (m.n_shared * m.d_expert) if m.n_shared else 0
        layer_total = attn + router + shared + m.n_experts * expert
        layer_active = attn + router + shared + m.top_k * expert
        return {"total": embed + L * layer_total,
                "active": embed + L * layer_active}
    if cfg.family == "hybrid":
        s = cfg.ssm
        di = s.d_inner(d)
        nh_m = s.n_heads(d)
        mamba = (d * (2 * di + 2 * s.n_groups * s.d_state + nh_m)
                 + s.d_conv * (di + 2 * s.n_groups * s.d_state)
                 + di * d + 2 * di + 3 * nh_m)
        shared_blk = attn + 3 * d * dff
        n = embed + L * mamba + shared_blk
        return {"total": n, "active": n}
    if cfg.family == "ssm":
        x = cfg.xlstm
        di = int(x.mlstm_proj_factor * d)
        # q, k, v projections are (di, di); gates (di, 2 * nh)
        mlstm = (d * 2 * di + x.d_conv * di + 3 * di * di
                 + di * 2 * cfg.n_heads + 2 * di + di * d)
        dffs = ((int(x.slstm_ff_factor * d) + 63) // 64) * 64
        slstm = (d * 4 * d + cfg.n_heads * (d // cfg.n_heads) ** 2 * 4
                 + d * 2 * dffs + dffs * d)
        k = x.slstm_every
        n_groups = L // k
        n = embed + n_groups * ((k - 1) * mlstm + slstm)
        return {"total": n, "active": n}
    if cfg.family == "vlm":
        k = cfg.cross_attn_every
        n_units = L // (k + 1)
        blk = attn + 3 * d * dff
        cross = attn + 3 * d * dff + 1
        n = embed + d * d + n_units * (k * blk + cross)
        return {"total": n, "active": n}
    # dense / audio
    mlp = (3 if cfg.glu else 2) * d * dff
    n = embed + L * (attn + mlp) + d
    return {"total": n, "active": n}


def params_for(arch: str) -> Dict[str, float]:
    """N (total, active) of an arch: the analytic formula for an LM, the
    leaves of ``capsnet.specs`` for a CapsNet."""
    from repro_torch import configs as cfg_lib

    cfg = cfg_lib.get_config(arch)
    if arch.startswith("capsnet"):
        from repro_torch.core import capsnet as cn
        from repro_torch.models.common import tree_leaves

        n = sum(math.prod(leaf.shape) for leaf in tree_leaves(cn.specs(cfg)))
        return {"total": float(n), "active": float(n)}
    return {k: float(v) for k, v in _lm_param_count(cfg).items()}


CAPSNET_BATCH = {"train_1k": 1024, "infer_1k": 1024}


def model_flops(arch: str, shape) -> float:
    """MODEL_FLOPS = 6 * N_active * D for train, 2 * N_active * D for
    inference (forward only), with D the tokens (images) the step
    processes.  ``shape`` is a name of ``configs.SHAPES`` (or a CapsNet
    cell's) or a ``{"seq", "batch", "kind"}`` mapping."""
    from repro_torch import configs as cfg_lib

    p = params_for(arch)["active"]
    if isinstance(shape, str) and shape in CAPSNET_BATCH:
        mult = 6.0 if shape == "train_1k" else 2.0
        return mult * p * CAPSNET_BATCH[shape]
    info = cfg_lib.shape_info(shape)
    kind = info["kind"]
    if kind == "train":
        return 6.0 * p * info["batch"] * info["seq"]
    if kind == "prefill":
        return 2.0 * p * info["batch"] * info["seq"]
    return 2.0 * p * info["batch"]                         # decode: 1 tok/row


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------


def fits(rec: Dict[str, Any]) -> bool:
    """Whether a dry-run record's argument plus temporary bytes per device
    fit the card's memory."""
    need = rec["arg_bytes_per_dev"] + rec["temp_bytes_per_dev"]
    return need <= HBM_CAPACITY_BYTES


def analyze(rec: Dict[str, Any]) -> Dict[str, Any]:
    t_comp = rec["flops_per_dev"] / PEAK_FLOPS
    t_mem = rec["bytes_per_dev"] / HBM_BW
    t_coll = rec["collective_bytes_per_dev"] / LINK_BW
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(rec["arch"], rec["shape"])
    counted_total = rec["flops_per_dev"] * rec["n_chips"]
    useful = mf / counted_total if counted_total else 0.0
    # roofline fraction: useful-compute time / modelled step time
    t_useful = (mf / rec["n_chips"]) / PEAK_FLOPS
    frac = t_useful / bound if bound > 0 else 0.0
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "n_chips")},
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "bound_s": bound,
        "dominant": dominant,
        "model_flops": mf,
        "counted_flops_total": counted_total,
        "useful_ratio": useful,
        "roofline_frac": frac,
    }


def load_records(directory: str) -> List[Dict[str, Any]]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def to_markdown(rows: Sequence[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/counted | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.3f} | {r['roofline_frac']:.3f} |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=None, help="filter: 16x16 / 2x16x16")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()
    rows = [analyze(r) for r in load_records(args.dir)
            if args.mesh is None or r["mesh"] == args.mesh]
    rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))
    if args.markdown:
        print(to_markdown(rows))
        return
    for r in rows:
        print(f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:8s} "
              f"comp={r['t_compute_s']:.3e} mem={r['t_memory_s']:.3e} "
              f"coll={r['t_collective_s']:.3e} dom={r['dominant']:10s} "
              f"useful={r['useful_ratio']:.3f} "
              f"roofline={r['roofline_frac']:.3f}")


if __name__ == "__main__":
    main()
