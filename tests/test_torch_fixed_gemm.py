"""The fixed-order GEMM (``repro_torch.kernels.gemm``, ``csrc/gemm.cu``) on
the CPU.

The kernel exists to repair ROADMAP §C Open 1: a cuBLAS product gave one
request's rows other bits depending on how many rows shared the call.
Held here, where no card is:

* its plan (body, tile, instruction, K order, split, stages, layout) is one
  object for every M from 1 to 8192, for both types and both layouts of w;
  the launch grid's y axis is the only thing M moves;
* the Python mirror of the source's geometry equals the source's
  ``constexpr``s, the pipeline fits a block's shared memory, the BN rule
  is the source's, and every served projection of every full-width
  config gets a legal plan;
* the legalizer refuses what the wrapper refuses (a misfit everywhere; type,
  layout, alignment and the grid's axis y on the card and on meta);
* the wrapper refuses a gradient, and on the CPU is ``torch.matmul`` bit
  for bit, reading w as stored (no copy of a transposed table);
* on the meta device it charges ``2 M N K`` at the bf16 peak;
* the serving projections route through it when ``attn_impl == "cuda"``
  and no gradient is asked for (7 products a dense layer and the
  unembedding), the dense LM's forward then agrees with the JAX package,
  and training keeps torch's product.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro_torch import configs as port_configs
from repro_torch import convert, kernels
from repro_torch.kernels import build
from repro_torch.kernels.gemm import kernel as gk
from repro_torch.kernels.limits import (MAX_DYNAMIC_SMEM, MAX_GRID_X,
                                        MAX_GRID_YZ, MAX_THREADS)
from repro_torch.kernels.registry import registry
from repro_torch.launch import op_cost, roofline
from repro_torch.models import lm as port_lm

torch.set_num_threads(1)

SOURCE = (build.CSRC_DIR / "gemm.cu").read_text()


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def weight(k, n, layout, dtype=torch.bfloat16, device="meta"):
    if layout == "nk":
        return torch.empty((n, k), dtype=dtype, device=device).T
    return torch.empty((k, n), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# The plan does not read M
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_plan_is_the_same_for_every_m(dtype, layout):
    w = weight(2048, 512, layout, dtype)
    plans = {repr(gk.gemm_plan(meta((m, 2048), dtype), w))
             for m in range(1, 8193)}
    assert len(plans) == 1
    plan = gk.gemm_plan(meta((1, 2048), dtype), w)
    assert plan["split_k"] == 1 and plan["k_order"] == "ascending"
    assert plan["layout"] == layout and (plan["n"], plan["k"]) == (512, 2048)
    # the launch plan differs across M only in the grid's row tiles
    spec = registry.get("fixed_order_matmul")
    plans = [spec.launch_plan({}, meta((m, 2048), dtype), w)
             for m in (1, 127, 128, 129, 8192)]
    for p in plans:
        assert {k: v for k, v in p.items() if k != "grid"} == {
            k: v for k, v in plans[0].items() if k != "grid"}
        assert p["grid"][0] == plans[0]["grid"][0] and p["grid"][2] == 1
    tile = plan["tile"][0]
    assert [p["grid"][1] for p in plans] == [
        -(-m // tile) for m in (1, 127, 128, 129, 8192)]


def test_no_tunables():
    """A tunable tile or split would set a row's sums: the spec has none,
    so the tuner has nothing to time and dispatch never looks it up."""
    spec = registry.get("fixed_order_matmul")
    assert spec.space == {} and spec.tuned == () and spec.base_config == {}
    x, w = meta((75, 64)), weight(64, 96, "kn")
    assert registry.resolve_config("fixed_order_matmul", x, w,
                                   tune=True) == {}


def test_source_geometry_is_the_mirrors():
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               SOURCE).group(1))
           for name in ("kGemmBM", "kGemmBK", "kGemmConsumers",
                        "kGemmThreads", "kGemmStagesN64", "kGemmStagesN128",
                        "kGemmStagesN256", "kGemmF32Tile", "kGemmF32K")}
    assert got == {"kGemmBM": gk.GEMM_BM, "kGemmBK": gk.GEMM_BK,
                   "kGemmConsumers": gk.GEMM_CONSUMERS,
                   "kGemmThreads": gk.GEMM_THREADS,
                   "kGemmStagesN64": gk.GEMM_STAGES[64],
                   "kGemmStagesN128": gk.GEMM_STAGES[128],
                   "kGemmStagesN256": gk.GEMM_STAGES[256],
                   "kGemmF32Tile": gk.GEMM_F32_TILE,
                   "kGemmF32K": gk.GEMM_F32_K}
    # two 64-row consumer warpgroups and a producer's; one wgmma shape a BN
    assert gk.GEMM_CONSUMERS * 64 == gk.GEMM_BM
    assert gk.GEMM_THREADS == 128 * (gk.GEMM_CONSUMERS + 1)
    code = re.sub(r"//.*", "", SOURCE)
    for bn in gk.GEMM_STAGES:
        assert f"wgmma.mma_async.sync.aligned.m64n{bn}k16.f32.bf16.bf16" \
            in code
        assert gk.gemm_smem(bn) <= MAX_DYNAMIC_SMEM
        # the stages fill the block: one more would not fit
        assert gk.gemm_smem(bn) + 2 * gk.GEMM_BK * (gk.GEMM_BM + bn) + 16 \
            > MAX_DYNAMIC_SMEM or gk.GEMM_STAGES[bn] == 8
    # TMA copies into an mbarrier ring, registers moved to the consumers;
    # the mma.sync body and its cp.async copies are gone
    for needle in ("cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                   "setmaxnreg.dec", "setmaxnreg.inc", "__grid_constant__",
                   "cuTensorMapEncodeTiled", "CU_TENSOR_MAP_SWIZZLE_128B"):
        assert needle in code, needle
    for gone in ("mma.sync", "ldmatrix", "cp.async.cg", "kGemmSmallM"):
        assert gone not in code, gone
    assert "split" not in code.lower()
    assert "gemm.cu" in build.SOURCES


def source_bn_rule():
    """The source's ``gemm_block_n`` as a Python function of n: each
    ``if (n >= a * b) return v;`` line in order, then the last
    ``return v;``."""
    body = re.search(r"inline int gemm_block_n\(int n\) \{\n(.*?)\n\}",
                     SOURCE, re.S).group(1)
    rules = []
    for line in body.splitlines():
        line = line.strip()
        m = re.fullmatch(r"if \(n >= (\d+) \* (\d+)\) return (\d+);", line)
        if m:
            rules.append((int(m.group(1)) * int(m.group(2)), int(m.group(3))))
            continue
        m = re.fullmatch(r"return (\d+);", line)
        assert m, f"gemm_block_n: a line the mirror does not read: {line}"
        rules.append((0, int(m.group(1))))

    def rule(n):
        return next(value for least, value in rules if n >= least)
    return rule


def test_bn_rule_is_the_sources():
    """The Python BN rule equals the C one at every N of a grid of widths
    (multiples of 8 from 8 to past the largest vocabulary) and at every
    served projection's, and gives only BNs the source has an instance
    of."""
    rule = source_bn_rule()
    widths = {8, 16, 56, 64, 72, 128, 136, 256, 264, 512, 1024, 1536, 2040,
              2048, 2056, 4088, 4096, 4104, 6144, 8192, 10752, 12288, 16384,
              28672, 32768, 49152, 100352, 128256, 151936, 152064}
    widths |= {n for arch in SERVED
               for _, _, n in served_projections(port_configs.get_config(arch))}
    for n in sorted(widths):
        assert gk.gemm_block_n(n) == rule(n), n
        assert rule(n) in gk.GEMM_STAGES


# every config chip_smoke.py serves at full width through the dense kernel
# path, with its served projections: (label, K, N) of q, k / v, o, the
# dense FFN's wi / wg and wo (dbrx's experts are the moe layer's, not this
# kernel's) and the unembedding (a tied table's transpose)
SERVED = ("llama3.2-1b", "qwen3-1.7b", "qwen1.5-110b", "mistral-large-123b",
          "dbrx-132b")


def served_projections(cfg):
    d, hd = cfg.d_model, cfg.head_dim
    out = [("q", d, cfg.n_heads * hd), ("k, v", d, cfg.n_kv_heads * hd),
           ("o", cfg.n_heads * hd, d)]
    if cfg.family != "moe":
        out += [("wi, wg", d, cfg.d_ff), ("wo", cfg.d_ff, d)]
    out.append(("unembed", d, cfg.vocab))
    return out


@pytest.mark.parametrize("arch", SERVED)
def test_every_served_projection_has_a_legal_plan(arch):
    """Shared memory within a block's, an instruction N wgmma has (a
    multiple of 8 up to 256), the grid within the card's axes at the
    prefill's rows and at a decode tick's, in both layouts of w; and the
    plan is the same at both M."""
    cfg = port_configs.get_config(arch)
    spec = registry.get("fixed_order_matmul")
    for label, k, n in served_projections(cfg):
        for layout in ("kn", "nk"):
            w = weight(k, n, layout)
            plans = []
            for m in (8, 8 * 1024):
                x = meta((m, k))
                assert spec.legalize({}, x, w) == {}
                launch = spec.launch_plan({}, x, w)
                plan = gk.gemm_plan(x, w)
                bn = plan["tile"][1]
                assert plan["instruction"] == f"wgmma m64n{bn}k16"
                assert bn % 8 == 0 and 8 <= bn <= 256, (arch, label, bn)
                assert launch["smem_bytes"] == gk.gemm_smem(bn)
                assert launch["smem_bytes"] <= MAX_DYNAMIC_SMEM
                assert launch["threads"] == gk.GEMM_THREADS <= MAX_THREADS
                gx, gy, gz = launch["grid"]
                assert gx == -(-n // bn) <= MAX_GRID_X
                assert gy == -(-m // gk.GEMM_BM) <= MAX_GRID_YZ and gz == 1
                plans.append(plan)
            assert plans[0] == plans[1], (arch, label, layout)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _refused(x, w, err=ValueError):
    spec = registry.get("fixed_order_matmul")
    with pytest.raises(err):
        spec.legalize({}, x, w)
    with pytest.raises(err):
        gk.fixed_order_matmul_cuda(x, w)


@pytest.mark.parametrize("case", [
    "k_misfit", "n_not_8", "k_not_8", "float16", "mixed", "strided_w",
    "strided_x", "rows_past_grid", "three_d"])
def test_legalizer_refuses_what_the_kernel_refuses(case):
    if case == "k_misfit":
        _refused(meta((4, 64)), weight(72, 64, "kn"))
        # a misfit is refused on the CPU too
        _refused(torch.ones(4, 64), torch.ones(72, 64))
    elif case == "n_not_8":
        _refused(meta((4, 64)), weight(64, 60, "kn"))
    elif case == "k_not_8":
        _refused(meta((4, 60)), weight(60, 64, "nk"))
    elif case == "float16":
        _refused(meta((4, 64), torch.float16),
                 weight(64, 64, "kn", torch.float16), TypeError)
    elif case == "mixed":
        _refused(meta((4, 64)), weight(64, 64, "kn", torch.float32),
                 TypeError)
    elif case == "strided_w":
        _refused(meta((4, 64)), meta((64, 128))[:, ::2])
    elif case == "strided_x":
        _refused(meta((4, 128))[:, ::2], weight(64, 64, "kn"))
    elif case == "rows_past_grid":
        _refused(meta((MAX_GRID_YZ * gk.GEMM_BM + 1, 64)),
                 weight(64, 64, "kn"))
    else:
        _refused(meta((2, 4, 64)), weight(64, 64, "kn"))


def test_cpu_takes_what_only_the_kernel_refuses():
    """The plain version takes any width and type: the kernel-only limits
    are not the CPU's."""
    x = torch.ones(3, 60, dtype=torch.float64)
    w = torch.ones(60, 6, dtype=torch.float64)
    spec = registry.get("fixed_order_matmul")
    assert spec.legalize({}, x, w) == {}
    assert torch.equal(kernels.fixed_order_matmul(x, w), x @ w)


def test_wrapper_refuses_a_gradient():
    x = torch.ones(4, 8, requires_grad=True)
    w = torch.ones(8, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.fixed_order_matmul(x, w)
    with torch.no_grad():
        assert torch.equal(kernels.fixed_order_matmul(x, w), x @ w)


# ---------------------------------------------------------------------------
# The plain version and the meta cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["kn", "nk"])
def test_cpu_equals_matmul(dtype, layout):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.standard_normal((37, 48))
                         .astype(np.float32)).to(dtype)
    table = torch.from_numpy(rng.standard_normal((24, 48) if layout == "nk"
                                                 else (48, 24))
                             .astype(np.float32)).to(dtype)
    w = table.T if layout == "nk" else table
    assert gk.w_layout(w) == layout
    got = kernels.fixed_order_matmul(x, w)
    assert got.dtype == dtype and torch.equal(got, torch.matmul(x, w))
    # the rows of a part of x are the rows of the whole (the plain version
    # on this host; the kernel's own invariance is chip_smoke's gemm_probe)
    assert torch.equal(kernels.fixed_order_matmul(x[:5].contiguous(), w),
                       got[:5])


def test_meta_charges_its_roofline_row():
    x, w = meta((8192, 8192)), weight(8192, 2048, "kn")
    with op_cost.CostMode() as mode:
        y = kernels.fixed_order_matmul(x, w)
    assert y.shape == (8192, 2048) and y.device.type == "meta"
    work = roofline.gemm_work({"dims": (8192, 2048, 8192),
                               "dtype": "bfloat16"})
    assert work.ops == 2 * 8192 * 2048 * 8192
    assert work.nbytes == 2 * (8192 * 8192 + 8192 * 2048 + 8192 * 2048)
    assert mode.cost.op_counts["kernel.fixed_order_matmul"] == 1
    assert mode.cost.flops == work.ops
    t_bytes, t_ops = roofline.KERNEL_BOUNDS["fixed_order_matmul"](
        {"dims": (8, 2048, 8192), "dtype": "bfloat16"})
    assert t_bytes > t_ops                   # decode: bound by w's bytes


# ---------------------------------------------------------------------------
# The serving route
# ---------------------------------------------------------------------------


def _cfgs(**kw):
    ref = dataclasses.replace(ref_configs.reduced(
        ref_configs.get_config("llama3.2-1b")), compute_dtype="float32")
    port = dataclasses.replace(port_configs.reduced(
        port_configs.get_config("llama3.2-1b")), compute_dtype="float32",
        **kw)
    return ref, port


@pytest.fixture(scope="module")
def paired():
    jcfg, _ = _cfgs()
    jp = ref_lm.init(jcfg, jax.random.key(0))
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def count_gemm(monkeypatch):
    calls = []
    inner = gk.fixed_order_matmul_plain

    def plain(x, w):
        calls.append((tuple(x.shape), gk.w_layout(w)))
        return inner(x, w)

    monkeypatch.setattr(gk, "fixed_order_matmul_plain", plain)
    return calls


def test_serving_projections_take_the_gemm(paired, monkeypatch):
    """A prefill and a decode step with ``attn_impl="cuda"``: q, k, v, o,
    wi, wg and wo in every layer and the tied unembedding (the table's
    transpose, read as stored), each a 2-D product over the flattened
    rows; the logits agree with the JAX package's."""
    jp, pp = paired
    jcfg, pcfg = _cfgs(attn_impl="cuda")
    calls = count_gemm(monkeypatch)
    rng = np.random.RandomState(1)
    tokens = rng.randint(1, 128, (2, 12)).astype(np.int32)
    caches = port_lm.make_caches(pcfg, 2, 16, device="cpu")
    with torch.no_grad():
        logits, caches = port_lm.prefill_step(
            pp, pcfg, {"tokens": torch.from_numpy(tokens)}, caches)
    layer = 7 if pcfg.glu else 6
    assert len(calls) == pcfg.n_layers * layer + 1
    assert all(len(shape) == 2 for shape, _ in calls)
    assert calls[0][0] == (2 * 12, pcfg.d_model)
    assert calls[-1] == ((2, pcfg.d_model), "nk" if pcfg.tie_embeddings
                         else "kn")
    jcaches = ref_lm.make_caches(jcfg, 2, 16)
    want, _ = ref_lm.prefill_step(jp, jcfg, {"tokens": tokens}, jcaches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=2e-4)


def test_training_keeps_the_plain_product(monkeypatch):
    """With weights that need a gradient and autograd on, the route is off
    even with ``attn_impl="cuda"``: the FFN and the unembedding take
    torch's product and differentiate (the kernel has no backward); under
    no_grad the same calls take the GEMM."""
    from repro_torch.models import common, mlp

    _, pcfg = _cfgs(attn_impl="cuda")
    calls = count_gemm(monkeypatch)
    gen = torch.Generator().manual_seed(4)
    d, f = pcfg.d_model, pcfg.d_ff
    ffn = {k: torch.randn(shape, generator=gen).requires_grad_(True)
           for k, shape in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    embed = {"tok": torch.randn((pcfg.vocab, d), generator=gen)
             .requires_grad_(True)}
    x = torch.randn((2, 3, d), generator=gen)
    loss = (mlp.mlp_apply(ffn, pcfg, x).sum()
            + common.unembed(embed, pcfg, x).sum())
    loss.backward()
    assert calls == []
    assert all(t.grad is not None for t in list(ffn.values()) + [embed["tok"]])
    with torch.no_grad():
        mlp.mlp_apply(ffn, pcfg, x)
        common.unembed(embed, pcfg, x)
    assert [layout for _, layout in calls] == ["kn", "kn", "kn", "nk"]
