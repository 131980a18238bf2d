"""Port parity for the attention kernels (``flash_attention``,
``decode_attention``) on the CPU.

The oracles of ``repro_torch.kernels.attention.ref`` are held against the
reference's on every example case (paged and int8 included); the wrappers,
which take their plain versions for CPU tensors, against the reference's
oracles on the dense cases at each case's ``atol`` (2e-5 exact, 5e-2 for the
Eq. 2 exp against the exact oracle); and the Taylor path against the
reference's Pallas kernels in interpret mode at 1e-4 (float32, one KV block,
so both compute the same sums in another order).  The CUDA kernels run only
on the card and are checked there by ``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as ref_kernels
from repro.kernels.attention import ref as jref
from repro.models import attention as ref_attention
from repro_torch import kernels as port_kernels
from repro_torch.kernels.attention import kernel as port_attn
from repro_torch.kernels.attention import ref as pref
from repro_torch.kernels.registry import registry as port_registry
from repro_torch.models import attention as port_attention
from torch_testlib import f32, rand, to_jax, to_torch

torch.set_num_threads(1)

ref_registry = importlib.import_module("repro.kernels.registry").registry
port_registry_mod = importlib.import_module("repro_torch.kernels.registry")
NAMES = ("flash_attention", "decode_attention")


def _cases(name, dense_only=False):
    out = []
    for i, case in enumerate(port_registry.get(name).example_cases):
        if dense_only and (case.get("paged") or case.get("quant")):
            continue
        out.append(pytest.param(i, id=f"{name}-case{i}"))
    return out


def _jax(x):
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    return x


def _example(name, idx):
    spec = port_registry.get(name)
    case = spec.example_cases[idx]
    args, kwargs = spec.make_example(case, device="cpu")
    return spec, case, args, kwargs


class TestRegistryEntries:
    @pytest.mark.parametrize("name", NAMES)
    def test_example_cases_copied_from_reference(self, name):
        assert (tuple(dict(c) for c in port_registry.get(name).example_cases)
                == tuple(dict(c) for c in ref_registry.get(name).example_cases))

    @pytest.mark.parametrize("name", NAMES)
    def test_ref_accepts_copied(self, name):
        assert (port_registry.get(name).ref_accepts
                == ref_registry.get(name).ref_accepts)

    @pytest.mark.parametrize("name", NAMES)
    def test_base_config_is_in_the_space(self, name):
        spec = port_registry.get(name)
        for key in spec.tuned:
            assert spec.base_config[key] in spec.space[key]
        assert spec.space["softmax_mode"] == ("exact", "taylor")


class TestOracles:
    @pytest.mark.parametrize("idx", _cases("flash_attention"))
    def test_flash_oracle_matches_reference(self, idx):
        _, case, args, kwargs = _example("flash_attention", idx)
        kw = {k: kwargs[k] for k in ("causal", "q_offset")}
        want = jref.attention_ref(*map(_jax, args), **kw)
        got = pref.attention_ref(*args, **kw)
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)

    @pytest.mark.parametrize("idx", _cases("decode_attention"))
    def test_decode_oracle_matches_reference(self, idx):
        """Every case, paged and int8 ones included: the inputs (int8 rows
        and scales too) are made once and handed to both oracles."""
        _, case, args, kwargs = _example("decode_attention", idx)
        extra = {k: kwargs[k] for k in ("tables", "ks", "vs") if k in kwargs}
        want = jref.decode_attention_ref(
            *map(_jax, args), **{k: _jax(v) for k, v in extra.items()})
        got = pref.decode_attention_ref(*args, **extra)
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)

    def test_attention_dequant_oracle_matches_reference(self):
        q = rand(3, (1, 32, 4, 16))
        kq, ks = port_attention.quantize_kv_rows(to_torch(rand(4, (1, 48, 2, 16))))
        vq, vs = port_attention.quantize_kv_rows(to_torch(rand(5, (1, 48, 2, 16))))
        want = jref.attention_dequant_ref(to_jax(q), *map(_jax, (kq, ks, vq, vs)),
                                          q_offset=16)
        got = pref.attention_dequant_ref(to_torch(q), kq, ks, vq, vs,
                                         q_offset=16)
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)

    def test_quantize_kv_rows_matches_reference(self):
        x = rand(7, (3, 5, 2, 16), scale=2.0)
        q, s = port_attention.quantize_kv_rows(to_torch(x))
        jq, js = ref_attention.quantize_kv_rows(to_jax(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
        np.testing.assert_allclose(
            f32(port_attention.dequantize_kv(q, s, torch.float32)),
            f32(ref_attention.dequantize_kv(jq, js, jnp.float32)), atol=1e-7)


class TestPlainVersions:
    @pytest.mark.parametrize("idx", _cases("flash_attention"))
    def test_flash_plain_vs_reference_oracle(self, idx):
        spec, case, args, kwargs = _example("flash_attention", idx)
        got = port_registry.call("flash_attention", *args, **kwargs)
        want = jref.attention_ref(*map(_jax, args), causal=kwargs["causal"],
                                  q_offset=kwargs["q_offset"])
        assert got.shape == args[0].shape and got.dtype == args[0].dtype
        np.testing.assert_allclose(f32(got), f32(want), atol=case["atol"])

    @pytest.mark.parametrize("idx", _cases("decode_attention", dense_only=True))
    def test_decode_plain_vs_reference_oracle(self, idx):
        spec, case, args, kwargs = _example("decode_attention", idx)
        got = port_registry.call("decode_attention", *args, **kwargs)
        want = jref.decode_attention_ref(*map(_jax, args))
        assert got.shape == args[0].shape
        np.testing.assert_allclose(f32(got), f32(want), atol=case["atol"])

    @pytest.mark.parametrize("name", NAMES)
    def test_wrapper_on_cpu_launches_nothing(self, name):
        spec, case, args, kwargs = _example(name, 0)
        before = spec.build().launches
        port_registry.call(name, *args, **kwargs)
        assert spec.build().launches == before

    def test_flash_taylor_vs_pallas_interpret(self):
        """One KV block in the Pallas kernel: its online softmax is the
        plain version's single pass (float32 both)."""
        q, k, v = (rand(s, shape, 1.0) for s, shape in
                   ((20, (1, 128, 4, 32)), (21, (1, 128, 2, 32)),
                    (22, (1, 128, 2, 32))))
        want = ref_kernels.flash_attention(to_jax(q), to_jax(k), to_jax(v),
                                           causal=True, softmax_mode="taylor")
        got = port_kernels.flash_attention(to_torch(q), to_torch(k),
                                           to_torch(v), causal=True,
                                           softmax_mode="taylor")
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-4)

    def test_decode_taylor_vs_pallas_interpret(self):
        q, k, v = (rand(s, shape, 1.0) for s, shape in
                   ((30, (5, 1, 4, 32)), (31, (5, 128, 2, 32)),
                    (32, (5, 128, 2, 32))))
        valid = np.asarray((100, 128, 64, 1, 27), np.int32)
        want = ref_kernels.decode_attention(
            to_jax(q), to_jax(k), to_jax(v), jnp.asarray(valid),
            softmax_mode="taylor")
        got = port_kernels.decode_attention(
            to_torch(q), to_torch(k), to_torch(v), torch.from_numpy(valid),
            softmax_mode="taylor")
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-4)

    def test_decode_valid_zero_gives_zeros_and_long_valid_clips(self):
        q, k, v = (to_torch(rand(s, shape)) for s, shape in
                   ((1, (2, 1, 4, 16)), (2, (2, 8, 2, 16)), (3, (2, 8, 2, 16))))
        out = port_kernels.decode_attention(q, k, v,
                                            torch.tensor([0, 9], dtype=torch.int32))
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        full = port_kernels.decode_attention(q, k, v,
                                             torch.tensor([8, 8], dtype=torch.int32))
        torch.testing.assert_close(out[1], full[1], atol=0, rtol=0)

    def test_flash_bf16_plain_rounds_once(self):
        q, k, v = (rand(s, shape) for s, shape in
                   ((40, (1, 64, 4, 16)), (41, (1, 64, 2, 16)), (42, (1, 64, 2, 16))))
        got = port_kernels.flash_attention(*(to_torch(x, "bfloat16") for x in (q, k, v)))
        want = jref.attention_ref(*(to_jax(x, "bfloat16") for x in (q, k, v)))
        assert got.dtype == torch.bfloat16
        # float32 inside both; the bf16 output rounds at 2^-8
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-2)


class TestWrapperChecks:
    def test_decode_paged_and_int8_raise_on_every_device(self):
        spec = port_registry.get("decode_attention")
        for idx, case in enumerate(spec.example_cases):
            if not (case.get("paged") or case.get("quant")):
                continue
            args, kwargs = spec.make_example(case, device="cpu")
            with pytest.raises(NotImplementedError, match="paged slice"):
                port_registry.call("decode_attention", *args, **kwargs)
        q = torch.zeros(1, 1, 2, 16, device="meta")
        with pytest.raises(NotImplementedError):
            port_attn.decode_attention_cuda(q, q, q, q, ks=q)

    def test_flash_rejects_bad_shapes_and_offsets(self):
        q = torch.zeros(1, 4, 4, 16)
        k = torch.zeros(1, 4, 3, 16)
        with pytest.raises(ValueError, match="KV"):
            port_attn.flash_attention_cuda(q, k, k)
        with pytest.raises(ValueError, match="q_offset"):
            port_attn.flash_attention_cuda(q, q[:, :, :2], q[:, :, :2],
                                           q_offset=-1)
        with pytest.raises(ValueError, match="softmax_mode"):
            port_attn.flash_attention_cuda(q, q, q, softmax_mode="fast")
        with pytest.raises(ValueError, match=r"\(B, S, H, D\)"):
            port_attn.flash_attention_cuda(q[0], q, q)

    def test_meta_device_is_refused(self):
        q = torch.zeros(1, 4, 4, 16, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            port_attn.flash_attention_cuda(q, q, q)
        with pytest.raises(ValueError, match="unsupported device"):
            port_attn.decode_attention_cuda(
                q[:, :1], q, q, torch.zeros(1, dtype=torch.int32,
                                            device="meta"))

    def test_decode_rejects_float_lengths_and_mixed_devices(self):
        q, k = torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16)
        with pytest.raises(ValueError, match="integers"):
            port_attn.decode_attention_cuda(q, k, k, torch.zeros(2))
        with pytest.raises(ValueError, match="tensors on"):
            port_attn.decode_attention_cuda(
                q, k, k, torch.zeros(2, dtype=torch.int32, device="meta"))

    def test_launch_counters_exist(self):
        assert isinstance(port_attn.flash_attention_cuda.launches, int)
        assert isinstance(port_attn.decode_attention_cuda.launches, int)


class TestLegalize:
    @pytest.mark.parametrize("h,k,s,asked,want", [
        (32, 8, 1024, 64, 16),     # llama: G = 4 -> 16 positions, 64 rows
        (16, 8, 192, 64, 32),      # qwen3: G = 2
        (8, 8, 512, 64, 64),       # MHA
        (32, 8, 5, 64, 8),         # short prompt: no tile past next_pow2(S)
        (32, 8, 1024, 12, 8),      # a request is rounded down to a power of 2
        (4, 1, 64, 8, 8),
    ])
    def test_flash_q_block(self, h, k, s, asked, want):
        q, kv = torch.zeros(1, s, h, 16), torch.zeros(1, s, k, 16)
        cfg = port_registry_mod._legalize_flash({"q_block": asked}, q, kv)
        assert cfg == {"q_block": want}
        assert port_registry_mod._legalize_flash(dict(cfg), q, kv) == cfg

    @pytest.mark.parametrize("d,asked,want", [(64, 256, 256), (128, 256, 192),
                                              (32, 100, 96), (16, 9999, 512)])
    def test_decode_threads_fit_shared_memory(self, d, asked, want):
        q, k = torch.zeros(2, 1, 8, d), torch.zeros(2, 16, 2, d)
        cfg = port_registry_mod._legalize_decode({"threads": asked}, q, k)
        assert cfg == {"threads": want}
        assert (port_attn.decode_smem_bytes(d, want)
                <= port_attn.MAX_DYNAMIC_SMEM)

    @pytest.mark.parametrize("source,constant,name", [
        ("flash_attention.cu", "kFlashRows", "FLASH_ROWS"),
        ("decode_attention.cu", "kDecodeMaxG", "DECODE_MAX_GROUP"),
        ("decode_attention.cu", "kDecodeTile", "DECODE_TILE"),
    ])
    def test_geometry_matches_cuda_source(self, source, constant, name):
        """The registry plans block sizes from the wrapper module's copy of
        the kernels' geometry; it must be the sources' own."""
        import re

        from repro_torch.kernels import build

        text = (build.CSRC_DIR / source).read_text()
        found = re.findall(rf"constexpr int {constant} = (\d+);", text)
        assert found == [str(getattr(port_attn, name))]

    def test_default_configs(self):
        spec = port_registry.get("flash_attention")
        args, kwargs = spec.make_example(spec.example_cases[0])
        assert port_registry.default_config("flash_attention", *args,
                                            **kwargs) == {"q_block": 32}
        spec = port_registry.get("decode_attention")
        args, kwargs = spec.make_example(spec.example_cases[0])
        assert port_registry.default_config("decode_attention", *args,
                                            **kwargs) == {"threads": 256}
