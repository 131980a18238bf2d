"""The port's roofline module (``repro_torch.launch.roofline``): parameter
counts and model flops held equal to the reference's, the kernels' bound
functions held to the numbers they gave before they moved out of
``chip_smoke.py`` (and to ``PERF.md``'s ``bound ms`` column), and each
kernel wrapper's cost on the meta device held to its bound formula.
"""

import math

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import roofline as ref_roofline
from repro_torch import configs as port_configs
from repro_torch.kernels.registry import registry
from repro_torch.launch import op_cost, roofline
from repro_torch.models import lm as port_lm
from repro_torch.models.common import tree_leaves

torch.set_num_threads(1)

ALL_ARCHS = port_configs.list_archs()
LM_ARCHS = port_configs.list_archs(include_paper=False)


# ---------------------------------------------------------------------------
# Parameter counts and model flops against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_count_equals_reference(arch):
    assert roofline._lm_param_count(port_configs.get_config(arch)) == \
        ref_roofline._lm_param_count(ref_configs.get_config(arch))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_for_equals_reference(arch):
    assert roofline.params_for(arch) == ref_roofline.params_for(arch)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_formula_close_to_the_ports_leaves(arch):
    """The analytic N against the leaves of the port's own ``lm.specs``:
    within 0.2 % (the formulas leave out norms and biases; hubert-xlarge's
    layer norms and biases are 0.16 %)."""
    cfg = port_configs.get_config(arch)
    leaves = sum(math.prod(s.shape) for s in tree_leaves(port_lm.specs(cfg)))
    n = roofline._lm_param_count(cfg)["total"]
    assert abs(n - leaves) / leaves < 2e-3


MODEL_CELLS = ([(a, s) for a in LM_ARCHS for s in port_configs.SHAPES]
               + [(a, s) for a in port_configs.PAPER_ARCHS
                  for s in ("train_1k", "infer_1k")])


@pytest.mark.parametrize("arch,shape", MODEL_CELLS)
def test_model_flops_equal_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == \
        ref_roofline.model_flops(arch, shape)


def test_model_flops_takes_a_shape_mapping():
    info = {"batch": 8, "seq": 512, "kind": "train"}
    n = roofline.params_for("llama3.2-1b")["active"]
    assert roofline.model_flops("llama3.2-1b", info) == 6.0 * n * 8 * 512


def test_peaks_are_the_h100_data_sheets():
    assert roofline.PEAK_FLOPS == roofline.BF16_FLOP_PER_S == 989e12
    assert roofline.FP32_FLOP_PER_S == 67e12
    assert roofline.HBM_BW == roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.LINK_BW == 450e9
    assert roofline.HBM_CAPACITY_BYTES == 80e9


def test_analyze_and_markdown():
    rec = {"arch": "llama3.2-1b", "shape": "decode_32k", "mesh": "16x16",
           "n_chips": 256, "flops_per_dev": 1e9, "bytes_per_dev": 2e9,
           "collective_bytes_per_dev": 0.0}
    a = roofline.analyze(rec)
    assert a["dominant"] == "memory"
    assert a["t_memory_s"] == 2e9 / 3.35e12 == a["bound_s"]
    assert a["t_collective_s"] == 0.0
    mf = roofline.model_flops("llama3.2-1b", "decode_32k")
    assert a["useful_ratio"] == mf / (1e9 * 256)
    md = roofline.to_markdown([a])
    assert "| llama3.2-1b | decode_32k | 16x16 |" in md
    assert "**memory**" in md


# ---------------------------------------------------------------------------
# The bound functions, as chip_smoke.py had them before the move
# ---------------------------------------------------------------------------

HBM, FP32, BF16 = 3.35e12, 67e12, 989e12


def old_flash_bound(case, int8=False):
    b, s, t, h, k, d = case["dims"]
    width = 2 if case.get("dtype", "float32") == "bfloat16" else 4
    off = case.get("q_offset", 0)
    pairs = (sum(min(t, off + i + 1) for i in range(s))
             if case.get("causal", True) else s * t)
    kv_bytes = (2 * b * t * k * d + 2 * 4 * b * t) if int8 \
        else 2 * width * b * t * k * d
    nbytes = 2 * width * b * s * h * d + kv_bytes
    peak = BF16 if width == 2 else FP32
    return nbytes / HBM, 4 * b * h * d * pairs / peak


def old_decode_bound(case):
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
    return nbytes / HBM, 4 * rows * h * d / BF16


def old_sampling_bound(case):
    b, v = case["dims"]
    ops = 0
    for i in range(b):
        ops += 1
        if case.get("temperature", (1.0,) * b)[i] > 0:
            ops += 3 + 25
            if 0 < case.get("top_k", (0,) * b)[i] < v:
                ops += 60
            if case.get("top_p", (1.0,) * b)[i] < 1.0:
                ops += 63
    return 4 * b * v / HBM, ops * v / FP32


def old_elem_bytes(case):
    return 2 if case.get("dtype", "float32") == "bfloat16" else 4


def old_routing_bound(shape, elem=4, n_iters=3):
    b, i, j, d = shape
    nbytes = elem * (b * i * j * d + b * j * d) + 4 * b * i * j
    flops = (n_iters * 2 * b * i * j * d
             + (n_iters - 1) * 2 * b * i * j * d
             + n_iters * 6 * b * i * j
             + n_iters * 6 * b * j * d)
    return nbytes / HBM, flops / FP32


def old_softmax_bound(shape, elem=4):
    n = int(np.prod(shape))
    return 2 * elem * n / HBM, 23 * n / FP32


def old_softmax_bwd_bound(shape, elem=4):
    n = int(np.prod(shape))
    return 3 * elem * n / HBM, 43 * n / FP32


OLD_BOUNDS = {
    "fused_routing": lambda c: old_routing_bound(c["shape"],
                                                 old_elem_bytes(c)),
    "taylor_softmax": lambda c: old_softmax_bound(c["shape"],
                                                  old_elem_bytes(c)),
    "taylor_softmax_bwd": lambda c: old_softmax_bwd_bound(
        c["shape"], old_elem_bytes(c)),
    "flash_attention": old_flash_bound,
    "flash_attention_dequant": lambda c: old_flash_bound(c, int8=True),
    "decode_attention": old_decode_bound,
    "fused_sampling": old_sampling_bound,
}

SLOTS, MAX_LEN = 8, 1024
VALID = (716, 81, 403, 1024, 17, 260, 555, 1)
MIXED = {"temperature": (0.8,) * SLOTS, "top_k": (50,) * SLOTS,
         "top_p": (0.9,) * SLOTS}
# chip_smoke.py's main cases and slice lines (decode at a fixed set of
# valid lengths)
TABLE_CASES = [
    ("fused_routing", {"shape": (32, 252, 10, 16), "softmax_mode": "taylor"}),
    ("fused_routing", {"shape": (32, 1152, 10, 16), "softmax_mode": "taylor"}),
    ("taylor_softmax", {"shape": (32, 252, 10), "scale": 1.0}),
    ("taylor_softmax_bwd", {"shape": (32, 1152, 10), "scale": 1.0}),
    ("taylor_softmax_bwd", {"shape": (32, 252, 10), "scale": 1.0}),
    ("flash_attention", {"dims": (SLOTS, MAX_LEN, MAX_LEN, 32, 8, 64),
                         "dtype": "bfloat16", "causal": True}),
    ("flash_attention", {"dims": (SLOTS, MAX_LEN, MAX_LEN, 32, 8, 64),
                         "dtype": "float32", "causal": True}),
    ("flash_attention", {"dims": (8, 1000, 1000, 16, 16, 80),
                         "dtype": "bfloat16", "causal": False}),
    ("flash_attention", {"dims": (1, 700, 700, 32, 32, 64),
                         "dtype": "bfloat16", "causal": True}),
    ("flash_attention", {"dims": (SLOTS, MAX_LEN, 1024, 64, 8, 128),
                         "dtype": "bfloat16", "causal": False}),
    ("flash_attention_dequant", {"dims": (SLOTS, 256, MAX_LEN, 32, 8, 64),
                                 "dtype": "bfloat16", "causal": True,
                                 "q_offset": 768}),
    ("decode_attention", {"dims": (SLOTS, MAX_LEN, 32, 8, 64),
                          "dtype": "bfloat16", "valid": VALID}),
    ("decode_attention", {"dims": (SLOTS, MAX_LEN, 32, 8, 64),
                          "dtype": "bfloat16", "quant": True,
                          "valid": VALID}),
    ("decode_attention", {"dims": (SLOTS, MAX_LEN, 32, 8, 64),
                          "paged": (512, 16, 64), "dtype": "bfloat16",
                          "valid": VALID}),
    ("decode_attention", {"dims": (SLOTS, MAX_LEN, 32, 8, 64),
                          "paged": (512, 16, 64), "dtype": "bfloat16",
                          "quant": True, "valid": VALID}),
    ("decode_attention", {"dims": (SLOTS, MAX_LEN, 32, 32, 64),
                          "dtype": "bfloat16", "valid": VALID}),
    ("fused_sampling", {"dims": (SLOTS, 128256),
                        "temperature": (0.0,) * SLOTS}),
    ("fused_sampling", {"dims": (SLOTS, 128256), **MIXED}),
    ("fused_sampling", {"dims": (SLOTS, 102400), **MIXED}),
    ("fused_sampling", {"dims": (SLOTS, 32000),
                        "temperature": (0.0, 0.8, 1.0, 0.0, 1.3, 0.7, 0.0,
                                        0.9)}),
]
REGISTRY_CASES = [(name, dict(case)) for name in registry.names()
                  for case in registry.get(name).example_cases
                  if name in OLD_BOUNDS and name != "decode_attention"] + [
    ("decode_attention", dict(case))
    for case in registry.get("decode_attention").example_cases]


@pytest.mark.parametrize("name,case", TABLE_CASES + REGISTRY_CASES)
def test_bounds_unchanged_by_the_move(name, case):
    assert roofline.KERNEL_BOUNDS[name](case) == OLD_BOUNDS[name](case)


def test_named_bound_functions_unchanged():
    case = TABLE_CASES[5][1]
    assert roofline.flash_bound(case) == old_flash_bound(case)
    assert roofline.flash_bound(case, int8=True) == \
        old_flash_bound(case, int8=True)
    assert roofline.decode_bound(TABLE_CASES[11][1]) == \
        old_decode_bound(TABLE_CASES[11][1])
    assert roofline.sampling_bound(TABLE_CASES[17][1]) == \
        old_sampling_bound(TABLE_CASES[17][1])
    assert roofline.routing_bound((32, 252, 10, 16), 2) == \
        old_routing_bound((32, 252, 10, 16), 2)
    assert roofline.softmax_bound((5, 7), 2) == old_softmax_bound((5, 7), 2)
    assert roofline.softmax_bwd_bound((5, 7)) == old_softmax_bwd_bound((5, 7))


# PERF.md section 6's bound ms column, rows whose bound does not depend on
# served data: (kernel, case, the printed value, bytes or operations)
PERF_ROWS = [
    ("fused_routing", TABLE_CASES[0][1], 0.00164, "bytes"),
    ("taylor_softmax", TABLE_CASES[2][1], 0.00019, "bytes"),
    ("taylor_softmax_bwd", TABLE_CASES[3][1], 0.00132, "bytes"),
    ("taylor_softmax_bwd", TABLE_CASES[4][1], 0.00029, "bytes"),
    ("flash_attention", TABLE_CASES[5][1], 0.0348, "operations"),
    ("flash_attention", TABLE_CASES[7][1], 0.0414, "operations"),
    ("flash_attention", TABLE_CASES[8][1], 0.00342, "bytes"),
    ("flash_attention_dequant", TABLE_CASES[10][1], 0.0152, "operations"),
    ("fused_sampling", TABLE_CASES[16][1], 0.00123, "bytes"),
    ("fused_sampling", {"dims": (SLOTS, 32000),
                        "temperature": (0.0,) * SLOTS}, 0.00031, "bytes"),
]


@pytest.mark.parametrize("name,case,printed,by", PERF_ROWS)
def test_perf_md_bound_column(name, case, printed, by):
    t_bytes, t_ops = roofline.KERNEL_BOUNDS[name](case)
    digits = len(f"{printed:g}".split(".")[1].lstrip("0"))
    assert float(f"{max(t_bytes, t_ops) * 1e3:.{digits}g}") == printed
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Kernel wrappers on the meta device
# ---------------------------------------------------------------------------


def _dtype(x):
    return "bfloat16" if x.dtype == torch.bfloat16 else "float32"


def expected_case(name, args, kwargs):
    """The case the bound formula takes for this call, from the shapes
    alone (decode counts every cache row as valid, sampling every row as a
    draw at temperature 1)."""
    if name == "fused_routing":
        return {"shape": tuple(args[0].shape), "dtype": _dtype(args[0]),
                "softmax_mode": kwargs["softmax_mode"]}
    if name in ("taylor_softmax", "taylor_softmax_bwd"):
        return {"shape": tuple(args[0].shape), "dtype": _dtype(args[0])}
    if name in ("flash_attention", "flash_attention_dequant"):
        q, k = args[0], args[1]
        b, s, h, d = q.shape
        return {"dims": (b, s, k.shape[1], h, k.shape[2], d),
                "dtype": _dtype(q), "causal": kwargs["causal"],
                "q_offset": kwargs["q_offset"],
                "softmax_mode": kwargs["softmax_mode"]}
    if name == "decode_attention":
        q, k = args[0], args[1]
        b, _, h, d = q.shape
        tables = kwargs.get("tables")
        case = {"dims": (b, None, h, k.shape[2], d), "dtype": _dtype(q),
                "quant": kwargs.get("ks") is not None,
                "softmax_mode": kwargs["softmax_mode"]}
        if tables is not None:
            t = tables.shape[1] * k.shape[1]
            case["paged"] = (k.shape[0], k.shape[1], tables.shape[1])
        else:
            t = k.shape[1]
        case["dims"] = (b, t, h, k.shape[2], d)
        case["valid"] = (t,) * b
        return case
    return {"dims": tuple(args[0].shape)}


def _to_meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("name,case", REGISTRY_CASES)
def test_wrapper_on_meta_adds_its_bound(name, case):
    spec = registry.get(name)
    args, kwargs = spec.make_example(case, device="cpu")
    plain = spec.ref_call(*args, **kwargs)
    margs = tuple(_to_meta(a) for a in args)
    mkw = {k: _to_meta(v) for k, v in kwargs.items()}
    config = registry.default_config(name, *margs, **mkw)
    launches = spec.build().launches
    with op_cost.CostMode() as mode:
        out = spec.build()(*margs, **mkw, **config)
    assert spec.build().launches == launches          # nothing launched
    outs = out if isinstance(out, tuple) else (out,)
    plains = plain if isinstance(plain, tuple) else (plain,)
    for o, p in zip(outs, plains):
        assert o.device.type == "meta"
        assert o.shape == p.shape
    w = roofline.KERNEL_WORK[name](expected_case(name, args, kwargs))
    c = mode.cost
    assert c.op_counts[f"kernel.{name}"] == 1
    assert (c.flops, c.bytes, c.dot_flops, c.transcendentals) == \
        (w.ops, w.nbytes, w.dot_ops, w.transcendentals)


def test_meta_wrapper_refuses_what_the_card_refuses():
    from repro_torch.kernels.attention.kernel import decode_attention_cuda

    q = torch.empty((2, 1, 24, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    valid = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="threads must be"):
        decode_attention_cuda(q, k, k, valid, threads=544)
    assert decode_attention_cuda(q, k, k, valid).shape == q.shape   # G 12


def test_meta_softmax_trains_through_its_backward():
    """``TaylorSoftmax`` on meta: the forward and backward wrappers each
    charge their row."""
    from repro_torch.kernels.softmax.kernel import taylor_softmax_cuda

    x = torch.empty((4, 8, 10), device="meta", requires_grad=True)
    with op_cost.CostMode() as mode:
        y = taylor_softmax_cuda(x)
        (g,) = torch.autograd.grad(y.sum(), x)
    assert g.shape == x.shape
    assert mode.cost.op_counts["kernel.taylor_softmax"] == 1
    assert mode.cost.op_counts["kernel.taylor_softmax_bwd"] == 1
