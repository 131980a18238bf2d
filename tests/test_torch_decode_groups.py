"""The decode kernel at every group size the reference takes, on the CPU.

``decode_attention`` takes any number G of query heads per KV head, as the
reference's ``decode_attention_pallas`` does (q (B, K, G, D)): a block
holds at most 8 query heads, so the heads of a larger group
(mistral-large-123b: 96 query heads over 8 KV heads, G 12) go to chunks of
at most 8, a block each.  Here:

* the wrapper on meta tensors (the dry run) at mistral-large's decode (G 12)
  and dbrx's (G 6) in all four cache layouts returns (B, 1, H, D) and
  charges row 5's cost; it refuses only what the kernel cannot launch;
* the Python plan of chunks, shared memory and splits against the
  constants and formulas of ``csrc/decode_attention.cu``, and the source's
  build in parts;
* the plain version (the CPU path) at G 12, 20 and 24 against the
  reference's Pallas decode kernel in interpret mode.

The kernel itself runs only on the card (``chip_smoke.py``'s ``kernels``
phase holds it against its plain version there).
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as ref_kernels
from repro_torch.kernels import build
from repro_torch.kernels.attention import kernel as port_attn
from repro_torch.kernels.registry import registry as port_registry
from repro_torch.launch import op_cost, roofline
from torch_testlib import f32

torch.set_num_threads(1)

port_registry_mod = importlib.import_module("repro_torch.kernels.registry")
SOURCE = (build.CSRC_DIR / "decode_attention.cu").read_text()
LAYOUTS = ("dense", "int8", "paged", "paged_int8")
# (B, T, H, K, D) of a decode tick at 8 slots of 1024 rows: mistral-large's
# G 12 and dbrx's G 6 (both D 128 over 8 KV heads)
GEOMETRIES = {"mistral-large-123b": (8, 1024, 96, 8, 128),
              "dbrx-132b": (8, 1024, 48, 8, 128)}
PAGE = 16


def _meta_call(dims, layout):
    """q, the cache of ``layout`` and its extras on meta, bf16 as served."""
    b, t, h, nkv, d = dims
    int8 = layout.endswith("int8")
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    q = torch.zeros(b, 1, h, d, dtype=torch.bfloat16, device="meta")
    kw = {}
    if layout.startswith("paged"):
        n_pages = b * t // PAGE
        k = torch.zeros(n_pages, PAGE, nkv, d, dtype=kv_dtype, device="meta")
        kw["tables"] = torch.zeros(b, t // PAGE, dtype=torch.int32,
                                   device="meta")
        scale_shape = (n_pages, PAGE)
    else:
        k = torch.zeros(b, t, nkv, d, dtype=kv_dtype, device="meta")
        scale_shape = (b, t)
    if int8:
        kw["ks"] = torch.zeros(scale_shape, device="meta")
        kw["vs"] = torch.zeros(scale_shape, device="meta")
    valid = torch.zeros(b, dtype=torch.int32, device="meta")
    return (q, k, k, valid), kw


def _row5_case(dims, layout):
    b, t, h, nkv, d = dims
    case = {"dims": dims, "valid": (t,) * b, "dtype": "bfloat16",
            "quant": layout.endswith("int8"), "softmax_mode": "exact"}
    if layout.startswith("paged"):
        case["paged"] = (b * t // PAGE, PAGE, t // PAGE)
    return case


class TestMetaAtLargeGroups:
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("arch", sorted(GEOMETRIES))
    def test_wrapper_serves_and_charges_row5(self, arch, layout):
        dims = GEOMETRIES[arch]
        args, kw = _meta_call(dims, layout)
        config = port_registry.default_config("decode_attention", *args,
                                              **kw)
        launches = port_attn.decode_attention_cuda.launches
        with op_cost.CostMode() as mode:
            out = port_attn.decode_attention_cuda(*args, **kw, **config)
        assert port_attn.decode_attention_cuda.launches == launches
        b, _, h, _, d = dims
        assert out.device.type == "meta" and out.shape == (b, 1, h, d)
        assert out.dtype == torch.bfloat16
        w = roofline.decode_work(_row5_case(dims, layout))
        c = mode.cost
        assert c.op_counts["kernel.decode_attention"] == 1
        assert (c.flops, c.bytes, c.dot_flops, c.transcendentals) == \
            (w.ops, w.nbytes, w.dot_ops, w.transcendentals)

    def test_refuses_only_what_the_kernel_cannot_launch(self):
        """Any G is served, at the same threads and shared memory as G 8;
        past 512 threads or a block's shared memory the meta call is refused
        as the card refuses it."""
        for h in (8, 12, 16, 24, 40, 96, 128):
            args, kw = _meta_call((2, 64, h, 1, 32), "dense")
            out = port_attn.decode_attention_cuda(*args, **kw, threads=512)
            assert out.shape[2] == h
        args, kw = _meta_call((2, 64, 12, 1, 32), "dense")
        with pytest.raises(ValueError, match="threads must be"):
            port_attn.decode_attention_cuda(*args, **kw, threads=544)
        args, kw = _meta_call(GEOMETRIES["mistral-large-123b"], "dense")
        with pytest.raises(ValueError, match="shared memory"):
            port_attn.decode_attention_cuda(*args, **kw, threads=512)


def _constant(name):
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE)
    assert len(found) == 1, name
    return int(found[0])


class TestPlanAgainstSource:
    def test_chunks_are_the_sources(self):
        """``decode_group_chunks`` is the source's (its line held by
        ``test_torch_attention.py``), read with the source's constant."""
        cap = _constant("kDecodeChunkG")
        assert cap == port_attn.DECODE_CHUNK_GROUP == 8
        for g in range(1, 129):
            assert port_attn.decode_group_chunks(g) == (g + cap - 1) // cap
        assert port_attn.decode_group_chunks(12) == 2
        assert port_attn.decode_group_chunks(6) == 1
        assert port_attn.decode_group_chunks(40) == 5

    def test_chunks_are_even_and_cover_the_group(self):
        """The kernel deals G heads to ``chunks`` blocks of
        ``ceil(G / chunks)`` heads, the last one the rest (its lines
        ``per_chunk``, ``g0``, ``Gc``): every head once, no chunk over the
        block's 8 heads, none empty."""
        text = " ".join(SOURCE.split())
        for line in ("const int per_chunk = kChunked ? (G + n_chunks - 1) / "
                     "n_chunks : G;",
                     "const int g0 = (bhc % n_chunks) * per_chunk;",
                     "const int Gc = kChunked ? min(per_chunk, G - g0) : G;",
                     "cfg.gridDim = dim3(B * a.K * chunks * splits, 1, 1);"):
            assert line in text
        for g in range(1, 129):
            chunks = port_attn.decode_group_chunks(g)
            per = -(-g // chunks)
            sizes = [min(per, g - c * per) for c in range(chunks)]
            assert sum(sizes) == g and min(sizes) >= 1
            assert max(sizes) <= port_attn.DECODE_CHUNK_GROUP

    @pytest.mark.parametrize("nkv,g,want", [
        (8, 4, 8),           # serve_lm: one chunk, 8 blocks a slot
        (8, 6, 8),           # dbrx: one chunk
        (16, 12, 4),         # two chunks: 32 blocks before splits
        (8, 40, 2),          # five chunks: 40 blocks
        (8, 24, 4),          # three chunks: 24 blocks
        (32, 20, 1),         # three chunks: 96 blocks
    ])
    def test_splits_count_chunks_as_blocks(self, nkv, g, want):
        # a cache of 8192 rows: 8 splits by rows, so the SMs bind
        assert port_attn.decode_kv_splits(nkv, 8192, 8, group=g) == want

    @pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                          torch.int8])
    @pytest.mark.parametrize("h", [24, 48, 96, 160])
    def test_legal_configs_at_large_groups(self, kv_dtype, h):
        """At G 3, 6, 12 and 20 the legalizer keeps every tuner point within
        the block's shared memory, counting chunks as blocks, and the plan
        capslint proves is the wrapper's."""
        spec = port_registry.get("decode_attention")
        q = torch.zeros(8, 1, h, 128, device="meta")
        # a cache long enough for every split count of the space
        k = torch.zeros(8, 4096, 8, 128, dtype=kv_dtype, device="meta")
        chunks = port_attn.decode_group_chunks(h // 8)
        for threads in spec.space["threads"] + (512,):
            for splits in spec.space["kv_splits"]:
                cfg = port_registry_mod._legalize_decode(
                    {"threads": threads, "kv_splits": splits}, q, k)
                assert 8 * chunks * cfg["kv_splits"] <= \
                    port_attn.H100_SMS or cfg["kv_splits"] == 1
                assert cfg["kv_splits"] * port_attn.DECODE_SPLIT_ROWS \
                    <= 4096
                smem = port_attn.decode_smem_bytes(
                    128, cfg["threads"], k.element_size(), cfg["kv_splits"])
                assert smem <= port_attn.MAX_DYNAMIC_SMEM
                assert port_registry_mod._legalize_decode(
                    dict(cfg), q, k) == cfg
                assert spec.launch_plan(cfg, q, k)["smem_bytes"] == smem


class TestPlainAtLargeGroups:
    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("h,nkv", [(24, 2), (40, 2), (12, 1), (24, 1)])
    def test_plain_vs_pallas_interpret(self, h, nkv, quant):
        """The wrapper on CPU tensors (the plain version) against the
        reference's decode kernel in interpret mode, which takes q as
        (B, K, G, D) for any G."""
        case = {"dims": (3, 64, h, nkv, 32), "valid": (64, 17, 0),
                "quant": quant, "seed": 5}
        spec = port_registry.get("decode_attention")
        args, kwargs = spec.make_example(case)
        want = ref_kernels.decode_attention(
            *(jnp.asarray(a.numpy()) for a in args),
            **{k: jnp.asarray(v.numpy()) for k, v in kwargs.items()
               if k in ("ks", "vs")})
        got = port_registry.call("decode_attention", *args, **kwargs)
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)
        assert not f32(got)[2].any()                 # valid 0 gives zeros


def test_decode_source_builds_in_eight_parts():
    """``build.compile_units`` compiles decode_attention.cu once per part
    (the chunked instances or not, a dense or a paged cache, the exact or
    the Eq. 2 exp), and every other source once; part p defines
    ``decode_part<p>``, the entry point (part 0) picks the part of a call
    by those three bits, the chunked instances only above 8 query heads per
    KV head, and the parts enter the library's content hash."""
    units = build.compile_units()
    parts = [flags for name, flags in units if name == "decode_attention.cu"]
    assert parts == [[f"-DFASTCAPS_DECODE_PART={p}"] for p in range(8)]
    assert sorted(name for name, flags in units if not flags) == sorted(
        n for n in build.SOURCES if n != "decode_attention.cu")
    text = " ".join(SOURCE.split())
    for p in range(8):
        assert f"int decode_part{p}(const DecodeLaunch& l);" in text
    assert ("return decode_by_types<(p & 4) != 0, (p & 2) != 0, (p & 1) != "
            "0>(l);") in text
    assert ("return parts[(l.a.G > kDecodeChunkG ? 4 : 0) + (paged ? 2 : 0) "
            "+ (taylor ? 1 : 0)](l);") in text
    for line in ("const int n_chunks = kChunked ? decode_group_chunks(G) : 1;",
                 "const int Gc = kChunked ? min(per_chunk, G - g0) : G;",
                 "const int chunks = kChunked ? decode_group_chunks(a.G) : 1;"):
        assert line in text
    assert text.index("#if FASTCAPS_DECODE_PART == 0 // q, out") \
        < text.index('extern "C" int decode_attention_launch(')
    before = build._source_hash()
    try:
        build.SOURCE_PARTS["decode_attention.cu"] = ("FASTCAPS_DECODE_PART",
                                                     4)
        assert build._source_hash() != before
    finally:
        build.SOURCE_PARTS["decode_attention.cu"] = ("FASTCAPS_DECODE_PART",
                                                     8)
