"""The kernels' grids, the tuner's timing and the tuned serve path, on the
CPU.

* Every ``launch_plan`` reports the grid its kernel's launcher in
  ``csrc/`` computes: the launchers' grid expressions are read out of the
  sources and evaluated here, as the limit constants are read.
* kernel-legality's ``over-grid`` code: a planted plan past each axis is
  flagged; flash attention's flattened grid proves the 524288-position
  bf16 case at ``q_block`` 8 (65536 q tiles, past the 65535 blocks the y
  axis held) and the float32 case of B * K = 131072 legal.
* The legalizers refuse what the wrappers refuse on every device, a cache
  that does not fit q; a flash group of more than 64 query heads per KV
  head is dealt to chunks (``flash_head_chunks``, read out of the source)
  and proven.
* ``tuning._time_call`` times ``iters`` back-to-back calls between one
  pair of CUDA events (stubbed here), and ``chip_smoke.py`` reports the
  tuner's repeat-to-repeat spread beside its gaps.
* ``chip_smoke.py``'s sorting of kernel-legality's scaled cases into
  launched, witnessed and unwitnessed (loaded from the script's source,
  which exits at import without a card) is deterministic on meta, and the
  inputs it makes for a scaled case have the shapes kernel-legality
  proved.
* An engine built with ``kernel_tune=True`` never measures on CPU tensors.
"""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.analysis.checkers.legality import KernelLegalityChecker
from repro_torch.kernels import build, limits, tuning
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.registry import KernelSpec, registry
from repro_torch.kernels.softmax.kernel import softmax_body, softmax_tile_rows

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "chip_smoke.py"
H100_GRID = (limits.MAX_GRID_X, limits.MAX_GRID_YZ, limits.MAX_GRID_YZ)


# ---------------------------------------------------------------------------
# the grids, read out of the sources
# ---------------------------------------------------------------------------


def source(name: str) -> str:
    return (build.CSRC_DIR / name).read_text()


def c_eval(expr: str, **env) -> int:
    """An integer C expression of the launchers (casts, member access and
    integer division) evaluated in Python."""
    expr = re.sub(r"\((?:long long|unsigned|int)\)", "", expr)
    expr = expr.replace("a.K", "K").replace("/", "//")
    return int(eval(expr, {}, env))


def grab(text: str, pattern: str) -> str:
    m = re.search(pattern, text)
    assert m, pattern
    return m.group(1)


def source_grid(name: str, args: tuple, kwargs: dict, config: dict) -> tuple:
    """The (x, y, z) blocks the launcher of kernel ``name`` computes for
    these arguments and this legalized config, from its source."""
    if name == "fused_routing":
        expr = grab(source("routing.cu"),
                    r"cfg\.gridDim = dim3\(([^,]+), 1, 1\);")
        return (c_eval(expr, batch=args[0].shape[0],
                       splits=config["i_splits"]), 1, 1)
    if name in ("taylor_softmax", "taylor_softmax_bwd"):
        text = source("softmax.cu")
        launcher = ("int launch_taylor_softmax_bwd(" if name.endswith("bwd")
                    else "int launch_taylor_softmax(")
        body_text = text[text.index(launcher):]
        body_text = body_text[:body_text.index("return (int)cudaGetLastError")]
        x = args[0]
        n, rows = x.shape[-1], x.numel() // x.shape[-1]
        threads, body = config["threads"], softmax_body(n)
        if body == "tile":
            operands = 2 if name.endswith("bwd") else 1
            threads = softmax_tile_rows(rows, n, operands * x.element_size(),
                                        threads)
            expr = grab(body_text, r"const int blocks = ([^;]+);")
            return (c_eval(expr, rows=rows, threads=threads), 1, 1)
        if body == "warp":
            per = c_eval(grab(body_text, r"int rows_per_block = ([^;]+);"),
                         threads=threads)
            expr = grab(body_text, r"\n\s+int blocks = (\(rows[^;]+);")
            return (c_eval(expr, rows=rows, rows_per_block=per), 1, 1)
        expr = grab(body_text, r"block_kernel<T><<<(\w+), threads")
        return (c_eval(expr, rows=rows), 1, 1)
    if name in ("flash_attention", "flash_attention_dequant"):
        text = source("flash_attention.cu")
        fn = text[text.index("inline long long flash_grid_x("):]
        n_qt = grab(fn, r"const long long n_qt = ([^;]+);")
        blocks = grab(fn, r"const long long blocks = ([^;]+);")
        q, k = args[0], args[1]
        chunks = source_flash_head_chunks(q.shape[2] // k.shape[2])
        assert text.count("const long long blocks = flash_grid_x(B, S, K * C, "
                          "q_block);") == 2
        env = dict(S=q.shape[1], B=q.shape[0], KC=k.shape[2] * chunks,
                   q_block=config["q_block"])
        env["n_qt"] = c_eval(n_qt, **env)
        # both bodies launch dim3((unsigned)blocks, 1, 1)
        assert text.count("const dim3 grid((unsigned)blocks, 1, 1);") == 2
        return (c_eval(blocks, **env), 1, 1)
    if name == "decode_attention":
        expr = grab(source("decode_attention.cu"),
                    r"cfg\.gridDim = dim3\(([^,]+), 1, 1\);")
        q, k = args[0], args[1]
        g = q.shape[2] // k.shape[2]
        chunk_g = int(grab(source("decode_attention.cu"),
                           r"constexpr int kDecodeChunkG = (\d+);"))
        chunks = -(-g // chunk_g) if g > chunk_g else 1
        return (c_eval(expr, B=q.shape[0], K=k.shape[2], chunks=chunks,
                       splits=config["kv_splits"]), 1, 1)
    if name == "fused_sampling":
        expr = grab(source("sampling.cu"),
                    r"cfg\.gridDim = dim3\(([^,]+), 1, 1\);")
        return (c_eval(expr, B=args[0].shape[0], cluster=config["cluster"]),
                1, 1)
    if name == "fixed_order_matmul":
        text = source("gemm.cu")
        consts = {c: int(grab(text, rf"constexpr int {c} = (\d+);"))
                  for c in ("kGemmBM", "kGemmF32Tile")}
        bf16 = args[0].dtype == torch.bfloat16
        launcher = text[text.index("int launch_gemm_bf16(" if bf16
                                   else "int launch_gemm_f32("):]
        x_expr, y_expr = re.search(r"const dim3 grid\(([^,]+),\s*([^;]+)\);",
                                   launcher).groups()
        n = args[1].shape[1]
        env = dict(consts, m=args[0].shape[0], n=n,
                   BN=source_gemm_block_n(n) if bf16 else None)
        return (c_eval(x_expr, **env), c_eval(y_expr.rstrip(")"), **env), 1)
    raise AssertionError(name)


def source_gemm_block_n(n: int) -> int:
    """``gemm_block_n`` of the GEMM source (the bf16 CTA's columns), its
    rules read out of the source and run here."""
    text = source("gemm.cu")
    fn = text[text.index("inline int gemm_block_n(int n) {"):]
    fn = fn[:fn.index("\n}")]
    for least, value in re.findall(r"if \(n >= ([^)]+)\) return (\d+);", fn):
        if n >= c_eval(least):
            return int(value)
    return int(grab(fn, r"\n  return (\d+);"))


def source_flash_head_chunks(g: int) -> int:
    """``flash_head_chunks`` of the flash source, its loop condition read
    out of the source and run here."""
    text = source("flash_attention.cu")
    fn = text[text.index("inline int flash_head_chunks(int g) {"):]
    cond = grab(fn, r"while \((.+)\) \+\+c;")
    rows = int(grab(text, r"constexpr int kFlashRows = (\d+);"))
    cond = cond.replace("||", " or ").replace("/", "//")
    c = 1
    while eval(cond, {}, {"g": g, "c": c, "kFlashRows": rows}):
        c += 1
    return c


def example_cases():
    out = []
    for name in registry.names():
        for i, case in enumerate(registry.get(name).example_cases):
            out.append(pytest.param(name, case, id=f"{name}-{i}"))
    return out


class TestPlanGrid:
    @pytest.mark.parametrize("name,case", example_cases())
    def test_plan_grid_is_the_sources(self, name, case):
        """At every example case, for every tuner candidate, on meta."""
        spec = registry.get(name)
        args, kwargs = spec.make_example(case)
        args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                     for a in args)
        kwargs = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
                  for k, v in kwargs.items()}
        for config in tuning.candidate_configs(spec, *args, **kwargs):
            plan = spec.launch_plan(dict(config), *args, **kwargs)
            assert tuple(plan["grid"]) == source_grid(name, args, kwargs,
                                                      config), config

    @pytest.mark.parametrize("n", [16, 100, 1000])
    def test_softmax_bodies(self, n):
        """Each of the softmax's three bodies (a row a thread, a warp, a
        block)."""
        spec = registry.get("taylor_softmax")
        x = torch.empty((3000, n), device="meta")
        for threads in (128, 1024):
            config = spec.legalize({"threads": threads}, x)
            plan = spec.launch_plan(dict(config), x)
            assert tuple(plan["grid"]) == source_grid(
                "taylor_softmax", (x,), {}, config)

    def test_decode_chunked_grid(self):
        """G 12: two chunks of the group a (slot, KV head)."""
        spec = registry.get("decode_attention")
        case = {"dims": (2, 64, 24, 2, 32), "valid": (64, 29)}
        args, kwargs = spec.make_example(case)
        config = registry.default_config("decode_attention", *args, **kwargs)
        plan = spec.launch_plan(dict(config), *args, **kwargs)
        assert plan["grid"] == (2 * 2 * 2 * config["kv_splits"], 1, 1)
        assert tuple(plan["grid"]) == source_grid("decode_attention", args,
                                                  kwargs, config)

    @pytest.mark.parametrize("g", [1, 8, 64, 65, 67, 96, 128, 130, 200])
    def test_flash_head_chunks_are_the_sources(self, g):
        chunks = attn_kernel.flash_head_chunks(g)
        assert chunks == source_flash_head_chunks(g)
        assert g % chunks == 0
        assert attn_kernel.flash_block_heads(g) == g // chunks <= 64
        assert chunks == 1 or g // (chunks - 1) > 64 or g % (chunks - 1)

    def test_decode_plan_names_its_instance(self):
        """The plan's ``chunked`` is the source's choice of the chunked
        instances (G > kDecodeChunkG)."""
        spec = registry.get("decode_attention")
        for h, want in ((8, False), (16, True)):
            case = {"dims": (2, 64, h, 1, 32), "valid": (64, 29)}
            args, kwargs = spec.make_example(case)
            config = registry.default_config("decode_attention", *args,
                                             **kwargs)
            plan = spec.launch_plan(dict(config), *args, **kwargs)
            assert plan["chunked"] is want
        assert ("parts[(l.a.G > kDecodeChunkG ? 4 : 0)"
                in " ".join(source("decode_attention.cu").split()))

    def test_flash_grid_limit_is_the_sources(self):
        text = source("flash_attention.cu")
        m = re.search(r"constexpr long long kFlashMaxGridX = (\d+)LL;", text)
        assert m and int(m.group(1)) == limits.MAX_GRID_X

    def test_flash_bodies_take_the_flattened_index(self):
        """Both bodies read their (batch, KV head) and q tile from
        flash_block, which walks axis x only."""
        text = source("flash_attention.cu")
        assert text.count("const FlashBlock fb = flash_block(S, K * C, "
                          "q_block);") == 2
        assert "blockIdx.y" not in text and "gridDim.y" not in text


# ---------------------------------------------------------------------------
# over-grid
# ---------------------------------------------------------------------------


def planted_spec(grid) -> KernelSpec:
    def plan(config, x, **kwargs):
        return {"threads": config["threads"], "cluster": 1, "grid": grid}

    return KernelSpec(
        name="planted", build=lambda: None, reference=lambda: None,
        space={"threads": (128,)}, tuned=("threads",),
        base_config={"threads": 128},
        legalize=lambda config, x, **kw: config, launch_plan=plan,
        make_example=lambda case, device="cpu": (
            (torch.zeros((4, 8), device=device),), {}),
        example_cases=({},))


class TestOverGrid:
    @pytest.mark.parametrize("grid", [
        (limits.MAX_GRID_X + 1, 1, 1), (1, limits.MAX_GRID_YZ + 1, 1),
        (1, 1, limits.MAX_GRID_YZ + 1), (0, 1, 1)],
        ids=["x", "y", "z", "empty"])
    def test_flags_a_planted_plan(self, grid):
        spec = planted_spec(grid)
        [(_, found)] = KernelLegalityChecker().prove(
            spec, (torch.zeros((4, 8), device="meta"),), {})
        assert [f.code for f in found] == ["over-grid"]
        assert "over-grid" in KernelLegalityChecker.codes

    def test_limits_themselves_pass(self):
        spec = planted_spec(H100_GRID)
        [(_, found)] = KernelLegalityChecker().prove(
            spec, (torch.zeros((4, 8), device="meta"),), {})
        assert found == []

    def test_every_registered_plan_reports_a_grid(self):
        for name in registry.names():
            spec = registry.get(name)
            args, kwargs = spec.make_example(spec.example_cases[0])
            config = registry.default_config(name, *args, **kwargs)
            grid = spec.launch_plan(dict(config), *args, **kwargs)["grid"]
            assert len(grid) == 3 and all(n >= 1 for n in grid), name

    def test_bf16_half_million_positions_proven_with_a_legal_grid(self):
        """The tensor-core body at S 524288, G 8 and q_block 8 (the
        long_500k bucket) is 65536 q tiles: one axis-x grid of 65536 blocks
        a (batch, KV head), which kernel-legality proves legal.  The
        unflattened grid (B * K, 65536) is what the card refused."""
        spec = registry.get("flash_attention")
        q = torch.empty((1, 524288, 8, 64), dtype=torch.bfloat16,
                        device="meta")
        k = torch.empty((1, 64, 1, 64), dtype=torch.bfloat16, device="meta")
        proven = KernelLegalityChecker().prove(
            spec, (q, k, k), {"causal": False}, example=False)
        configs = [c for c, _ in proven]
        assert {"q_block": 8} in configs
        assert all(found == [] for _, found in proven)
        plan = spec.launch_plan({"q_block": 8}, q, k, k)
        assert plan["grid"] == (65536, 1, 1)
        # the planted grid of the unflattened body is flagged
        old = planted_spec((1, 65536, 1))
        [(_, found)] = KernelLegalityChecker().prove(
            old, (torch.zeros((4, 8), device="meta"),), {})
        assert [f.code for f in found] == ["over-grid"]

    def test_float32_batch_of_heads_past_65535(self):
        """The FMA body at B * K = 131072 (the old grid's y axis)."""
        spec = registry.get("flash_attention")
        q = torch.empty((512, 16, 256, 16), device="meta")
        proven = KernelLegalityChecker().prove(spec, (q, q, q), {},
                                               example=False)
        assert proven and all(found == [] for _, found in proven)
        for config, _ in proven:
            grid = spec.launch_plan(dict(config), q, q, q)["grid"]
            assert grid == (-(-16 // config["q_block"]) * 512 * 256, 1, 1)


class TestLegalizeRefusesWhatTheWrapperRefuses:
    def test_flash_misfit_cache(self):
        spec = registry.get("flash_attention")
        q = torch.empty((2, 64, 8, 32), device="meta")
        k = torch.empty((2, 64, 3, 32), device="meta")
        with pytest.raises(ValueError, match="does not fit"):
            spec.legalize(dict(spec.base_config), q, k, k)
        assert KernelLegalityChecker().prove(spec, (q, k, k), {},
                                             example=False) == []
        with pytest.raises(ValueError):
            attn_kernel.flash_attention_cuda(q, k, k)

    def test_flash_group_past_a_block(self):
        """128 query heads over one KV head: two chunks of 64, a block each
        at q_block 1, proven; the wrapper takes q_block 1 and refuses 2."""
        spec = registry.get("flash_attention")
        q = torch.empty((1, 64, 128, 32), device="meta")
        k = torch.empty((1, 64, 1, 32), device="meta")
        assert spec.legalize(dict(spec.base_config), q, k, k) == {
            "q_block": 1}
        proven = KernelLegalityChecker().prove(spec, (q, k, k), {},
                                               example=False)
        assert proven and all(found == [] for _, found in proven)
        assert spec.launch_plan({"q_block": 1}, q, k, k)["grid"] == (
            64 * 2, 1, 1)
        assert attn_kernel.flash_attention_cuda(
            q, k, k, q_block=1).shape == q.shape
        with pytest.raises(ValueError, match="q_block"):
            attn_kernel.flash_attention_cuda(q, k, k, q_block=2)

    def test_flash_group_past_a_block_on_the_cpu(self):
        """A CPU call with more than 64 query heads a KV head gets the
        plain version through the registry."""
        rng = np.random.RandomState(0)
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for s in ((1, 5, 96, 16), (1, 7, 1, 16),
                                   (1, 7, 1, 16)))
        got = registry.call("flash_attention", q, k, v, causal=False)
        want = attn_kernel.flash_attention_plain(q, k, v, causal=False)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_dequant_misfit_cache(self):
        spec = registry.get("flash_attention_dequant")
        q = torch.empty((32, 64, 8, 32), device="meta")
        kq = torch.empty((32, 256, 32, 32), dtype=torch.int8, device="meta")
        s = torch.empty((32, 256), device="meta")
        with pytest.raises(ValueError, match="does not fit"):
            spec.legalize(dict(spec.base_config), q, kq, s, kq, s)

    def test_decode_misfit_cache(self):
        spec = registry.get("decode_attention")
        q = torch.empty((3, 1, 3, 32), device="meta")
        k = torch.empty((12, 16, 2, 32), device="meta")
        valid = torch.empty((3,), dtype=torch.int32, device="meta")
        tables = torch.empty((3, 4), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="does not fit"):
            spec.legalize(dict(spec.base_config), q, k, k, valid,
                          tables=tables)

    def test_registry_still_clean(self):
        from repro_torch.analysis.loader import Project

        checker = KernelLegalityChecker()
        found = list(checker.run(Project.load([ROOT / "tools"],
                                              root=ROOT / "tools")))
        assert found == []
        assert {n: c["scaled"] for n, c in checker.cases.items()} == {
            "decode_attention": 117, "flash_attention": 79,
            "flash_attention_dequant": 66, "fused_routing": 70,
            "fused_sampling": 47, "taylor_softmax": 40,
            "taylor_softmax_bwd": 56, "fixed_order_matmul": 32}
        assert {n: c["refused"] for n, c in checker.cases.items()} == {
            "decode_attention": 39, "flash_attention": 15,
            "flash_attention_dequant": 13, "fused_routing": 25,
            "fused_sampling": 0, "taylor_softmax": 0,
            "taylor_softmax_bwd": 0, "fixed_order_matmul": 0}


# ---------------------------------------------------------------------------
# the tuner's timing (M2)
# ---------------------------------------------------------------------------


class FakeEvent:
    log = []

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        self.at = len(FakeEvent.log)
        FakeEvent.log.append(("record", self))

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        # milliseconds: one per call between the two records
        return float(sum(1 for kind, _ in FakeEvent.log[self.at:end.at]
                         if kind == "call"))


class TestTimeCall:
    def test_iters_calls_between_one_event_pair(self, monkeypatch):
        FakeEvent.log = []
        monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

        def fn():
            FakeEvent.log.append(("call", None))

        t = tuning._time_call(fn, warmup=2, iters=7, repeats=3)
        kinds = [k for k, _ in FakeEvent.log]
        assert kinds[:2] == ["call", "call"]              # the warm-up
        timed = kinds[2:]
        assert timed == (["record"] + ["call"] * 7 + ["record"]) * 3
        assert t == pytest.approx(1e-3)                   # s a call
        FakeEvent.log = []
        times = tuning.repeat_times(fn, warmup=0, iters=4, repeats=5)
        assert times == pytest.approx([1e-3] * 5)
        assert [k for k, _ in FakeEvent.log].count("record") == 10

    def test_tuner_spread_beside_its_gaps(self):
        """Each candidate's (slowest - fastest) / median repeat, and a
        winner separated from the default only where their repeats do not
        overlap."""
        spread = SORTER["tuner_spread"]
        timings = {"q_block=64": 2e-6, "q_block=32": 1e-6}
        got = spread(timings, [[1.9e-6, 2e-6, 2.1e-6], [0.9e-6, 1e-6,
                                                         1.1e-6]],
                     {"q_block": 64}, {"q_block": 32})
        assert got["tuner_spread"] == pytest.approx({"q_block=64": 0.1,
                                                     "q_block=32": 0.2})
        assert got["tuner_spread_max"] == pytest.approx(0.2)
        assert got["tuner_default_over_winner"] == pytest.approx(2.0)
        assert got["tuner_separated"] is True
        got = spread(timings, [[0.8e-6, 2e-6, 3e-6], [0.9e-6, 1e-6, 1.1e-6]],
                     {"q_block": 64}, {"q_block": 32})
        assert got["tuner_separated"] is False
        got = spread(timings, [[1.9e-6, 2e-6, 2.1e-6], [0.9e-6, 1e-6,
                                                         1.1e-6]],
                     {"q_block": 64}, {"q_block": 64})
        assert got["tuner_separated"] is False
        with pytest.raises(SystemExit, match="not among"):
            spread(timings, [[1e-6], [1e-6]], {"q_block": 16},
                   {"q_block": 32})

    def test_autotune_passes_iters_to_the_timer(self, tmp_path):
        seen = []

        def timer(fn, warmup, iters):
            seen.append((warmup, iters))
            return 1.0

        spec = registry.get("taylor_softmax")
        x = torch.zeros((4, 16))
        cache = tuning.TuneCache(str(tmp_path / "autotune.json"))
        tuning.autotune(spec, (x,), {}, cache=cache, timer=timer)
        assert seen and set(seen) == {(3, 20)}


# ---------------------------------------------------------------------------
# chip_smoke.py's sorting of the scaled cases
# ---------------------------------------------------------------------------

SORT_NAMES = ("SCALED_MAX_BYTES", "SCALED_MAX_BOUND_MS", "SCALED_ROW_KEYS",
              "scaled_case", "arg_bytes", "plan_instance",
              "sort_scaled_cases", "fail", "scaled_inputs", "case_shape",
              "tuner_spread", "oracle64")


def _load_sorter():
    tree = ast.parse(SCRIPT.read_text())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name in SORT_NAMES)
            or (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) in SORT_NAMES
                        for t in node.targets))]
    # the script's inputs are made on meta here
    ns = {"torch": torch, "registry": registry, "DEVICE": "meta"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT),
                 "exec"), ns)
    assert all(name in ns for name in SORT_NAMES)
    return ns


SORTER = _load_sorter()

# per spec: launched, witnessed, unwitnessed, refused (the H100's grid
# limits; 1 GiB of arguments, a bound of 2 ms)
PINNED = {
    "decode_attention": (109, 8, 0, 39),
    "flash_attention": (62, 17, 0, 15),
    "flash_attention_dequant": (52, 14, 0, 13),
    "fused_routing": (65, 5, 0, 25),
    "fused_sampling": (47, 0, 0, 0),
    "taylor_softmax": (40, 0, 0, 0),
    "taylor_softmax_bwd": (55, 1, 0, 0),
    "fixed_order_matmul": (32, 0, 0, 0),
}


@pytest.fixture(scope="module")
def sorted_cases():
    return SORTER["sort_scaled_cases"](H100_GRID)


class TestScaledCaseSorting:
    def test_counts_pinned(self, sorted_cases):
        got = {}
        for name, s in sorted_cases.items():
            classes = [e["class"] for e in s["entries"]]
            got[name] = (classes.count("launched"), classes.count("witnessed"),
                         classes.count("unwitnessed"), s["refused"])
        assert got == PINNED

    def test_every_proven_case_sorted_once(self, sorted_cases):
        checker = KernelLegalityChecker()
        from repro_torch.analysis.loader import Project

        list(checker.run(Project.load([ROOT / "tools"], root=ROOT / "tools")))
        for name, s in sorted_cases.items():
            assert len(s["entries"]) == checker.cases[name]["scaled"]
            assert s["refused"] == checker.cases[name]["refused"]

    def test_launched_within_the_caps(self, sorted_cases):
        for s in sorted_cases.values():
            for e in s["entries"]:
                small = (e["bytes"] <= SORTER["SCALED_MAX_BYTES"]
                         and e["bound_ms"] <= SORTER["SCALED_MAX_BOUND_MS"])
                assert (e["class"] == "launched") == small

    def test_scaled_inputs_have_the_proven_shapes(self, sorted_cases):
        """Every proven scaled case's inputs, made as the card makes them
        (the registry's example at the scaled shapes, drawn by the device's
        generator; here on meta), have the shapes and types kernel-legality
        proved; scaled_inputs fails the run otherwise."""
        n = 0
        for name, s in sorted_cases.items():
            for e in s["entries"]:
                args, _ = SORTER["scaled_inputs"](name, e)
                assert args[0].device.type == "meta"
                n += 1
        assert n == sum(p[0] + p[1] + p[2] for p in PINNED.values())

    def test_float64_oracle_of_the_softmax_pair(self):
        """The float32 softmax and its backward get an oracle of their
        formula evaluated in float64 (rounded once to float32); it sits
        within float32's rounding of the plain versions, and differs from
        them, so it measures their own rounding.  Other kernels and types
        get none."""
        from repro_torch.kernels.softmax.ref import (taylor_softmax_bwd_ref,
                                                     taylor_softmax_ref)

        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.standard_normal((4096, 16)).astype(
            np.float32) * 5)
        g = torch.from_numpy(rng.standard_normal((4096, 16)).astype(
            np.float32))
        oracle = SORTER["oracle64"]
        for name, args, plain in (
                ("taylor_softmax", (x,), taylor_softmax_ref(x)),
                ("taylor_softmax_bwd", (x, g), taylor_softmax_bwd_ref(x, g))):
            got = oracle(name, args)
            assert got.dtype == torch.float32 and got.shape == x.shape
            torch.testing.assert_close(got, plain, rtol=0, atol=4e-6)
            assert (got != plain).any()
        assert oracle("taylor_softmax", (x.bfloat16(),)) is None
        assert oracle("flash_attention", (x, x, x)) is None

    def test_deterministic(self, sorted_cases):
        again = SORTER["sort_scaled_cases"](H100_GRID)
        for name in ("flash_attention", "decode_attention"):
            a = [(e["value"], e["bucket"], e["class"], e["bound_ms"])
                 for e in sorted_cases[name]["entries"]]
            b = [(e["value"], e["bucket"], e["class"], e["bound_ms"])
                 for e in again[name]["entries"]]
            assert a == b

    def test_smaller_card_limits_unwitness(self, sorted_cases):
        """A witnessed case needs its grid within the card's limits: on a
        card of 65535 blocks on x too, the big grids go unwitnessed."""
        small = SORTER["sort_scaled_cases"]((65535, 65535, 65535))
        for name in sorted_cases:
            big = [e for e in sorted_cases[name]["entries"]
                   if e["class"] == "witnessed"
                   and any(p["grid"][0] > 65535 for _, p in e["candidates"])]
            classes = {(e["value"], e["bucket"], str(e["case"])): e["class"]
                       for e in small[name]["entries"]}
            for e in big:
                assert classes[(e["value"], e["bucket"],
                                str(e["case"]))] == "unwitnessed"

    @pytest.mark.parametrize("case,value,bucket,want", [
        ({"dims": (4, 128, 8, 2, 32), "valid": (128, 64, 1, 97)}, 4, 6 + 0,
         {"dims": (6, 128, 8, 2, 32), "valid": (128, 64, 1, 97, 128, 64)}),
        ({"dims": (3, 64, 4, 2, 32), "valid": (49, 64, 8),
          "paged": (12, 16, 4)}, 4, 1,
         {"dims": (3, 64, 1, 2, 32), "valid": (16, 16, 8),
          "paged": (12, 16, 1)}),
        ({"dims": (3, 33), "temperature": (0.8, 0.9, 1.1)}, 3, 4,
         {"dims": (4, 33), "temperature": (0.8, 0.9, 1.1, 0.8)}),
    ])
    def test_scaled_case(self, case, value, bucket, want):
        assert SORTER["scaled_case"](case, value, bucket) == want

    def test_scaled_case_matches_the_meta_shapes(self):
        """The case whose bound is counted has the shapes kernel-legality
        proved (flash: q (B, S, H, D) and k (B, T, K, D))."""
        spec = registry.get("flash_attention")
        for case, value, bucket, args, _ in (
                KernelLegalityChecker.case_variants(spec)):
            if value is None:
                continue
            b, s, t, h, k, d = SORTER["scaled_case"](case, value,
                                                     bucket)["dims"]
            assert tuple(args[0].shape) == (b, s, h, d)
            assert tuple(args[1].shape) == (b, t, k, d)


# ---------------------------------------------------------------------------
# kernel_tune=True on CPU tensors
# ---------------------------------------------------------------------------


@pytest.fixture
def no_measuring(monkeypatch, tmp_path):
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path))

    def refuse(*a, **k):
        raise AssertionError("measured on CPU tensors")

    monkeypatch.setattr(tuning, "autotune", refuse)
    monkeypatch.setattr(tuning, "_time_call", refuse)
    return tmp_path


class TestTunedEngineOnTheCpu:
    def test_capsule_engine(self, no_measuring):
        from repro_torch import configs as cfg_lib
        from repro_torch.deploy import FastCapsPipeline
        from repro_torch.serving import ImageRequest

        cfg = cfg_lib.reduced(cfg_lib.get_config("capsnet-mnist"))
        deployed = FastCapsPipeline(cfg, device="cpu").build(
            seed=0).compile(routing="cuda")
        eng = deployed.serve(batch_size=4, kernel_tune=True)
        eng.warmup()
        rng = np.random.RandomState(0)
        done = eng.serve([ImageRequest(images=rng.rand(
            3, cfg.image_hw, cfg.image_hw, cfg.in_channels).astype(
                np.float32), rid=0)])
        assert len(done) == 1 and done[0].classes.shape == (3,)
        assert not (no_measuring / "autotune.json").exists()

    def test_serve_engine(self, no_measuring):
        import dataclasses

        from repro_torch import configs as cfg_lib
        from repro_torch.models import lm
        from repro_torch.serving import Request, ServeEngine

        cfg = dataclasses.replace(
            cfg_lib.reduced(cfg_lib.get_config("llama3.2-1b")),
            attn_impl="cuda")
        gen = torch.Generator().manual_seed(0)
        params = lm.init(cfg, gen, "cpu")
        eng = ServeEngine(cfg, params, n_slots=2, max_len=64,
                          decode_kernel=True, kernel_tune=True, device="cpu")
        done = eng.serve([Request(prompt=[1, 2, 3, 4, 5], max_new_tokens=3,
                                  rid=0)])
        assert len(done) == 1 and len(done[0].tokens) == 8
        assert not (no_measuring / "autotune.json").exists()

    def test_registry_call_under_tuning(self, no_measuring):
        x = torch.randn(4, 16)
        with tuning.tuning(True):
            y = registry.call("taylor_softmax", x)
        assert y.shape == x.shape
