"""Port parity for the attention kernels (``flash_attention``,
``flash_attention_dequant``, ``decode_attention``) on the CPU.

The oracles of ``repro_torch.kernels.attention.ref`` are held against the
reference's on every example case (paged and int8 included); the wrappers,
which take their plain versions for CPU tensors, against the reference's
oracles on every case at each case's ``atol`` (2e-5 exact, 5e-2 for the
Eq. 2 exp against the exact oracle); and against the reference's Pallas
kernels in interpret mode: the Taylor paths at 1e-4 (float32, one KV block,
so both compute the same sums in another order) and the dequantizing flash
kernel on its four cases at 2e-5.  The CUDA kernels run only on the card and
are checked there by ``chip_smoke.py``; ``TestTensorCoreNumerics`` emulates
the rounding of the flash kernels' bf16 tensor-core body here and holds it
against the Pallas kernels and the float32 oracle.
"""

import dataclasses
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as ref_kernels
from repro.kernels.attention import ref as jref
from repro.models import attention as ref_attention
from repro_torch import configs as port_configs
from repro_torch import kernels as port_kernels
from repro_torch.kernels.attention import kernel as port_attn
from repro_torch.core import approx_math as port_approx
from repro_torch.kernels.attention import ref as pref
from repro_torch.kernels.registry import registry as port_registry
from repro_torch.models import attention as port_attention
from repro_torch.models import lm as port_lm
from torch_testlib import f32, rand, to_jax, to_torch

torch.set_num_threads(1)

ref_registry = importlib.import_module("repro.kernels.registry").registry
port_registry_mod = importlib.import_module("repro_torch.kernels.registry")
NAMES = ("flash_attention", "flash_attention_dequant", "decode_attention")


def _cases(name, dense_only=False):
    out = []
    for i, case in enumerate(port_registry.get(name).example_cases):
        if dense_only and (case.get("paged") or case.get("quant")):
            continue
        out.append(pytest.param(i, id=f"{name}-case{i}"))
    return out


def _jax(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:           # numpy has no bfloat16
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
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
        """The reference's cases, in its order; decode then has the port's
        own cases at the group sizes the reference's do not reach."""
        own = (port_registry_mod.PORT_DECODE_CASES
               if name == "decode_attention" else ())
        assert (tuple(dict(c) for c in port_registry.get(name).example_cases)
                == tuple(dict(c) for c in ref_registry.get(name).example_cases)
                + tuple(dict(c) for c in own))

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

    @pytest.mark.parametrize("idx", _cases("decode_attention"))
    def test_decode_plain_vs_reference_oracle(self, idx):
        """Every case, paged and int8 ones included: the plain version
        gathers the pages through the tables and dequantizes the rows."""
        spec, case, args, kwargs = _example("decode_attention", idx)
        got = port_registry.call("decode_attention", *args, **kwargs)
        extra = {k: _jax(kwargs[k]) for k in ("tables", "ks", "vs")
                 if kwargs.get(k) is not None}
        want = jref.decode_attention_ref(*map(_jax, args), **extra)
        assert got.shape == args[0].shape
        np.testing.assert_allclose(f32(got), f32(want), atol=case["atol"])

    @pytest.mark.parametrize("idx", _cases("flash_attention_dequant"))
    def test_flash_dequant_plain_vs_reference_oracle(self, idx):
        spec, case, args, kwargs = _example("flash_attention_dequant", idx)
        got = port_kernels.flash_attention_dequant(*args, **kwargs)
        want = jref.attention_dequant_ref(
            *map(_jax, args), causal=kwargs["causal"],
            q_offset=kwargs["q_offset"])
        assert got.shape == args[0].shape and got.dtype == args[0].dtype
        np.testing.assert_allclose(f32(got), f32(want), atol=case["atol"])

    @pytest.mark.parametrize("idx", _cases("flash_attention_dequant"))
    def test_flash_dequant_vs_pallas_interpret(self, idx):
        """The reference registry's dequantizing Pallas kernel, run in
        interpret mode, on the same int8 rows and scales."""
        spec, case, args, kwargs = _example("flash_attention_dequant", idx)
        want = ref_registry.call("flash_attention_dequant",
                                 *map(_jax, args), tune=False, **kwargs)
        got = port_registry.call("flash_attention_dequant", *args, **kwargs)
        np.testing.assert_allclose(f32(got), f32(want), atol=case["atol"])

    @pytest.mark.parametrize("quant", [False, True])
    def test_paged_taylor_vs_pallas_interpret(self, quant):
        """The paged bodies with the Eq. 2 exp, shuffled tables and -1
        sentinels past each slot's last page (clipped for the reference,
        as its engine passes them)."""
        case = {"dims": (4, 64, 4, 2, 32), "valid": (64, 17, 0, 33),
                "paged": (16, 16, 4), "shuffled": True, "quant": quant,
                "softmax_mode": "taylor", "seed": 3}
        args, kwargs = port_registry.get("decode_attention").make_example(
            case)
        assert (kwargs["tables"] < 0).any()
        ref_kw = {k: _jax(v) for k, v in kwargs.items()
                  if k in ("ks", "vs")}
        want = ref_kernels.decode_attention(
            *map(_jax, args), tables=_jax(kwargs["tables"].clamp(0, 15)),
            softmax_mode="taylor", **ref_kw)
        got = port_kernels.decode_attention(*args, **kwargs)
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-4)
        assert not f32(got)[2].any()               # valid 0 gives zeros

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
        """The paged and int8 bodies are served: on CPU tensors by the
        plain version (equal to the oracle), while a device the port does
        not serve raises for them as for the dense body, and malformed
        tables or scales raise on every device."""
        spec = port_registry.get("decode_attention")
        for idx, case in enumerate(spec.example_cases):
            if not (case.get("paged") or case.get("quant")):
                continue
            args, kwargs = spec.make_example(case, device="cpu")
            got = port_registry.call("decode_attention", *args, **kwargs)
            want = spec.ref_call(*args, **kwargs)
            np.testing.assert_allclose(f32(got), f32(want), atol=case["atol"])
        # on the meta device (a dry run) a float32 cache with scales is
        # refused as on the card; a paged call returns q's shape and
        # launches nothing
        q = torch.zeros(1, 1, 2, 16, device="meta")
        k = torch.zeros(1, 4, 1, 16, device="meta")
        s = torch.zeros(1, 4, device="meta")
        valid = torch.zeros(1, dtype=torch.int32, device="meta")
        with pytest.raises(TypeError, match="int8 cache"):
            port_attn.decode_attention_cuda(q, k, k, valid, ks=s, vs=s)
        launches = port_attn.decode_attention_cuda.launches
        out = port_attn.decode_attention_cuda(
            q, k, k, valid, tables=torch.zeros(1, 2, dtype=torch.int32,
                                               device="meta"))
        assert out.device.type == "meta" and out.shape == q.shape
        assert port_attn.decode_attention_cuda.launches == launches
        q, k = torch.zeros(1, 1, 2, 16), torch.zeros(1, 4, 1, 16)
        valid = torch.ones(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="come together"):
            port_attn.decode_attention_cuda(q, k, k, valid,
                                            ks=torch.ones(1, 4))
        with pytest.raises(ValueError, match="scales must be"):
            port_attn.decode_attention_cuda(q, k, k, valid,
                                            ks=torch.zeros(1, 3),
                                            vs=torch.zeros(1, 3))
        with pytest.raises(ValueError, match="tables must be"):
            port_attn.decode_attention_cuda(q, k, k, valid,
                                            tables=torch.zeros(2, 2))

    def test_flash_dequant_checks(self):
        q = torch.zeros(1, 4, 4, 16)
        kq = torch.zeros(1, 4, 2, 16, dtype=torch.int8)
        s = torch.ones(1, 4)
        with pytest.raises(ValueError, match="scales must be"):
            port_attn.flash_attention_dequant_cuda(q, kq, s[:, :3], kq, s)
        with pytest.raises(ValueError, match="page_size"):
            port_attn.flash_attention_dequant_cuda(q, kq, s, kq, s,
                                                   page_size=0)
        metas = [x.to("meta") for x in (q, kq, s, kq, s)]
        with pytest.raises(ValueError, match="q_block 64"):   # as the card
            port_attn.flash_attention_dequant_cuda(*metas)
        out = port_attn.flash_attention_dequant_cuda(*metas, q_block=32)
        assert out.device.type == "meta" and out.shape == q.shape
        out = port_attn.flash_attention_dequant_cuda(q, kq, s, kq, s)
        assert out.shape == q.shape and not out.any()

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
        """A meta call (a dry run) is refused where the card refuses it and
        for mixed devices; otherwise it returns a meta output and launches
        nothing (``tests/test_torch_roofline.py`` holds its cost)."""
        q = torch.zeros(1, 4, 4, 16, device="meta")
        k = torch.zeros(1, 4, 4, 16)
        kv1 = torch.zeros(1, 4, 1, 16, device="meta")
        with pytest.raises(ValueError, match="tensors on"):
            port_attn.flash_attention_cuda(q, k, k)
        with pytest.raises(ValueError, match="head dim"):
            port_attn.flash_attention_cuda(*(torch.zeros(
                1, 4, 4, 24, device="meta"),) * 3)
        q16 = torch.zeros(1, 1, 16, 16, device="meta")
        valid1 = torch.zeros(1, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="threads must be"):
            port_attn.decode_attention_cuda(q16, kv1, kv1, valid1,
                                            threads=544)
        assert port_attn.decode_attention_cuda(      # G 16: two chunks
            q16, kv1, kv1, valid1).shape == q16.shape
        launches = (port_attn.flash_attention_cuda.launches,
                    port_attn.decode_attention_cuda.launches)
        out = port_attn.flash_attention_cuda(q, q, q, q_block=16)
        assert out.device.type == "meta" and out.shape == q.shape
        out = port_attn.decode_attention_cuda(
            q[:, :1], q, q, torch.zeros(1, dtype=torch.int32, device="meta"))
        assert out.device.type == "meta" and out.shape == (1, 1, 4, 16)
        assert launches == (port_attn.flash_attention_cuda.launches,
                            port_attn.decode_attention_cuda.launches)

    def test_decode_rejects_float_lengths_and_mixed_devices(self):
        q, k = torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16)
        with pytest.raises(ValueError, match="integers"):
            port_attn.decode_attention_cuda(q, k, k, torch.zeros(2))
        with pytest.raises(ValueError, match="tensors on"):
            port_attn.decode_attention_cuda(
                q, k, k, torch.zeros(2, dtype=torch.int32, device="meta"))

    def test_launch_counters_exist(self):
        assert isinstance(port_attn.flash_attention_cuda.launches, int)
        assert isinstance(port_attn.flash_attention_dequant_cuda.launches,
                          int)
        assert isinstance(port_attn.decode_attention_cuda.launches, int)
        assert (sorted(port_attn.decode_attention_cuda.launches_by_body)
                == sorted(port_attn.DECODE_BODIES))
        for wrapper in (port_attn.flash_attention_cuda,
                        port_attn.flash_attention_dequant_cuda):
            assert (sorted(wrapper.launches_by_body)
                    == sorted(("tensor_core", "fma")))
            assert all(isinstance(n, int)
                       for n in wrapper.launches_by_body.values())

    def test_tensor_core_body_refuses_misaligned_rows(self):
        """The tensor-core body's 16-byte copies need aligned inputs: a
        contiguous view at an odd storage offset is refused before any
        launch, an allocation passes."""
        buf = torch.zeros(1 + 4 * 16, dtype=torch.bfloat16)
        odd = buf[1:].view(1, 1, 4, 16)
        assert odd.is_contiguous() and odd.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            port_attn._check_aligned("flash_attention", odd)
        port_attn._check_aligned("flash_attention",
                                 torch.zeros(1, 1, 4, 16,
                                             dtype=torch.bfloat16))

    @pytest.mark.parametrize("dtype,body", [(torch.bfloat16, "tensor_core"),
                                            (torch.float32, "fma")])
    def test_flash_body_follows_the_query_type(self, dtype, body):
        """bf16 q takes the tensor-core body, float32 q the FMA body, for
        both flash wrappers; a CPU tensor takes the plain version and counts
        no launch of either body."""
        assert port_attn.flash_body(dtype) == body
        q = torch.zeros(1, 8, 4, 16, dtype=dtype)
        k = torch.zeros(1, 8, 2, 16, dtype=dtype)
        kq = torch.zeros(1, 8, 2, 16, dtype=torch.int8)
        s = torch.ones(1, 8)
        for wrapper, args in ((port_attn.flash_attention_cuda, (q, k, k)),
                              (port_attn.flash_attention_dequant_cuda,
                               (q, kq, s, kq, s))):
            before = dict(wrapper.launches_by_body)
            assert wrapper(*args).dtype == dtype
            assert wrapper.launches_by_body == before


class TestRefuseGradient:
    """The attention kernels have no backward: each wrapper raises
    ``RuntimeError`` for an input that needs a gradient with autograd on,
    on the CPU too (where its plain version could differentiate), as rows
    1-2 do and as the reference's Pallas kernels refuse ``jax.grad``."""

    @staticmethod
    def _args(name, grad_on):
        spec = port_registry.get(name)
        case = next(c for c in spec.example_cases
                    if name != "decode_attention" or not c.get("paged"))
        args, kwargs = spec.make_example(case, device="cpu")
        args = list(args)
        args[0] = args[0].float().requires_grad_(grad_on == "q")
        if grad_on == "k":
            i = 1 if name != "flash_attention_dequant" else 2   # k or ks
            args[i] = args[i].float().requires_grad_(True)
        return spec, args, kwargs

    @pytest.mark.parametrize("grad_on", ["q", "k"])
    @pytest.mark.parametrize("name", NAMES)
    def test_wrapper_raises_for_an_input_that_needs_a_gradient(self, name,
                                                               grad_on):
        spec, args, kwargs = self._args(name, grad_on)
        wrapper = spec.build()
        with pytest.raises(RuntimeError, match="no backward.*attn_impl"):
            wrapper(*args, **kwargs)
        with pytest.raises(RuntimeError, match="no backward"):
            port_registry.call(name, *args, **kwargs)
        with torch.no_grad():
            wrapper(*args, **kwargs)            # no gradient: served

    def test_self_attention_cuda_refuses_to_train(self):
        """``attn_impl="cuda"`` under autograd raises; ``chunked`` trains."""
        cfg = port_configs.reduced(port_configs.get_config("llama3.2-1b"))
        pp = port_lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.ones((1, 8), dtype=torch.int32),
                 "labels": torch.ones((1, 8), dtype=torch.int32)}
        for p in (pp["units"]["block"]["attn"]["wq"],):
            p.requires_grad_(True)
        with pytest.raises(RuntimeError, match="flash_attention has no "
                                               "backward"):
            port_lm.loss_fn(pp, dataclasses.replace(cfg, attn_impl="cuda"),
                            batch)
        loss, _ = port_lm.loss_fn(pp, cfg, batch)
        loss.backward()
        assert pp["units"]["block"]["attn"]["wq"].grad.abs().sum() > 0


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
        """A bf16 cache, one split: whole warps, at most 512 threads, and no
        more warps than the block's shared memory holds (two staged K and V
        tiles a warp)."""
        q = torch.zeros(2, 1, 8, d, dtype=torch.bfloat16)
        k = torch.zeros(2, 64, 2, d, dtype=torch.bfloat16)
        cfg = port_registry_mod._legalize_decode(
            {"threads": asked, "kv_splits": 1}, q, k)
        assert cfg == {"threads": want, "kv_splits": 1}
        assert (port_attn.decode_smem_bytes(d, want, 2, 1)
                <= port_attn.MAX_DYNAMIC_SMEM)

    @pytest.mark.parametrize("source,constant,name", [
        ("flash_attention.cu", "kFlashRows", "FLASH_ROWS"),
        ("flash_attention.cu", "kFlashKv", "FLASH_KV_TILE"),
        ("decode_attention.cu", "kDecodeChunkG", "DECODE_CHUNK_GROUP"),
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

    @pytest.mark.parametrize("t,asked,want", [(192, 64, 64), (100, 64, 50),
                                              (256, 16, 16), (7, 8, 7)])
    def test_flash_dequant_page_size_divides_t(self, t, asked, want):
        q = torch.zeros(1, 32, 8, 32)
        kq = torch.zeros(1, t, 2, 32, dtype=torch.int8)
        cfg = port_registry_mod._legalize_flash_dequant(
            {"q_block": 64, "page_size": asked}, q, kq)
        assert cfg["page_size"] == want and cfg["q_block"] == 16
        assert port_registry_mod._legalize_flash_dequant(dict(cfg), q,
                                                         kq) == cfg

    def test_default_configs(self):
        spec = port_registry.get("flash_attention")
        args, kwargs = spec.make_example(spec.example_cases[0])
        assert port_registry.default_config("flash_attention", *args,
                                            **kwargs) == {"q_block": 32}
        spec = port_registry.get("decode_attention")
        args, kwargs = spec.make_example(spec.example_cases[0])
        # 4 slots x 2 KV heads of 128 rows: one split (a split is planned
        # for at least DECODE_SPLIT_ROWS rows)
        assert port_registry.default_config("decode_attention", *args,
                                            **kwargs) == {"threads": 256,
                                                          "kv_splits": 1}


# ---------------------------------------------------------------------------
# The tensor-core body's numerics
# ---------------------------------------------------------------------------


def _tensor_core_body(q, k, v, causal=True, q_offset=0, softmax_mode="exact",
                      ks=None, vs=None):
    """The flash kernels' bf16 tensor-core body (``csrc/flash_attention.cu``,
    ``flash_attention_kernel_tc``) in plain PyTorch, float32 output before
    its rounding.  bf16 q against bf16 or int8 K (exact in float32) with
    float32 sums, the scale applied after the dot (int8: the column's ks
    first); the online softmax over KV tiles of ``FLASH_KV_TILE`` rows; p
    (int8: times vs) split into bf16 hi and lo for the two PV products."""
    b, s, h, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    scores = torch.einsum("bskgd,btkd->bkgst",
                          q.float().reshape(b, s, nkv, h // nkv, d), k.float())
    if ks is not None:
        scores = scores * ks.float()[:, None, None, None, :]
    scores = scores * (1.0 / math.sqrt(d))
    kpos = torch.arange(t)
    mask = (kpos[None, :] <= torch.arange(s)[:, None] + q_offset) if causal \
        else torch.ones(s, t, dtype=torch.bool)

    def exp(x):
        return (port_approx.taylor_exp(x, range_reduce=True)
                if softmax_mode == "taylor" else torch.exp(x))

    m = torch.full(scores.shape[:-1], pref.NEG_INF)
    l = torch.zeros(scores.shape[:-1])
    acc = torch.zeros(scores.shape[:-1] + (d,))
    for t0 in range(0, t, port_attn.FLASH_KV_TILE):
        sl = slice(t0, t0 + port_attn.FLASH_KV_TILE)
        mk = mask[:, sl]
        sc = torch.where(mk, scores[..., sl], pref.NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = exp(m - m_new)
        p = torch.where(mk, exp(sc - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        if vs is not None:
            p = p * vs.float()[:, None, None, None, sl]
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        vt = v[:, sl].float()
        acc = (acc * alpha[..., None]
               + torch.einsum("bkgst,btkd->bkgsd", p_hi, vt)
               + torch.einsum("bkgst,btkd->bkgsd", p_lo, vt))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


# (dims (B, S, T, H, K, D), causal, q_offset, softmax_mode, atol): bf16
# inputs, the tolerances chip_smoke.py holds the card's bf16 cases to
TC_FLASH_CASES = [
    pytest.param((2, 128, 128, 8, 4, 32), True, 0, "exact", 1e-2, id="causal"),
    pytest.param((1, 64, 192, 4, 2, 16), False, 0, "exact", 1e-2,
                 id="noncausal-d16"),
    pytest.param((1, 64, 192, 4, 2, 64), True, 128, "exact", 1e-2,
                 id="offset-d64"),
    pytest.param((1, 64, 64, 2, 1, 128), True, 0, "exact", 1e-2, id="d128"),
    # hubert-xlarge's head dim (stored at 128 columns in shared memory; the
    # scores read the 80 real columns and the padded output columns are
    # never stored, so the emulation is D = 80's)
    pytest.param((2, 100, 100, 4, 4, 80), False, 0, "exact", 1e-2,
                 id="noncausal-d80"),
    pytest.param((1, 128, 128, 4, 2, 32), True, 0, "taylor", 5e-2,
                 id="taylor"),
]
TC_DEQUANT_CASES = [
    pytest.param((1, 64, 128, 4, 2, 32), True, 0, "exact", 1e-2, id="causal"),
    pytest.param((1, 64, 192, 4, 2, 32), True, 128, "taylor", 5e-2,
                 id="offset-taylor"),
    pytest.param((2, 64, 128, 8, 2, 32), False, 0, "exact", 1e-2,
                 id="noncausal"),
]


def _tc_inputs(dims, quant, seed=60):
    b, s, t, h, k, d = dims
    q = to_torch(rand(seed, (b, s, h, d)), "bfloat16")
    if not quant:
        return q, tuple(to_torch(rand(seed + i, (b, t, k, d)), "bfloat16")
                        for i in (1, 2))
    kq, ks = port_attention.quantize_kv_rows(to_torch(rand(seed + 1, (b, t, k, d))))
    vq, vs = port_attention.quantize_kv_rows(to_torch(rand(seed + 2, (b, t, k, d))))
    return q, (kq, ks, vq, vs)


class TestTensorCoreNumerics:
    """The bf16 tensor-core body's rounding, emulated on the CPU, meets the
    tolerances the card's bf16 cases are held to."""

    @pytest.mark.parametrize("dims,causal,q_offset,mode,atol", TC_FLASH_CASES)
    def test_flash_vs_pallas_interpret(self, dims, causal, q_offset, mode,
                                       atol):
        q, (k, v) = _tc_inputs(dims, quant=False)
        got = _tensor_core_body(q, k, v, causal, q_offset, mode)
        want = ref_kernels.flash_attention(
            *(_jax(x.float()).astype(jnp.bfloat16) for x in (q, k, v)),
            causal=causal, q_offset=q_offset, softmax_mode=mode)
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(f32(got.to(torch.bfloat16)), f32(want),
                                   atol=atol)

    @pytest.mark.parametrize("dims,causal,q_offset,mode,atol",
                             TC_DEQUANT_CASES)
    def test_dequant_vs_pallas_interpret(self, dims, causal, q_offset, mode,
                                         atol):
        q, (kq, ks, vq, vs) = _tc_inputs(dims, quant=True)
        got = _tensor_core_body(q, kq, vq, causal, q_offset, mode, ks=ks,
                                vs=vs)
        want = ref_registry.call(
            "flash_attention_dequant", _jax(q.float()).astype(jnp.bfloat16),
            *map(_jax, (kq, ks, vq, vs)), tune=False, causal=causal,
            q_offset=q_offset, softmax_mode=mode)
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(f32(got.to(torch.bfloat16)), f32(want),
                                   atol=atol)

    @pytest.mark.parametrize("dims,causal,q_offset,mode,atol", TC_FLASH_CASES)
    def test_flash_within_1e3_of_float32_before_rounding(
            self, dims, causal, q_offset, mode, atol):
        """Before the output's bf16 rounding the body stays within 1e-3 of
        float32 attention on the same bf16 inputs (the oracle; with the
        Eq. 2 exp, the float32 plain version of that mode): the split p
        costs far less than the 2^-8 the rounding then adds."""
        q, (k, v) = _tc_inputs(dims, quant=False)
        got = _tensor_core_body(q, k, v, causal, q_offset, mode)
        args = tuple(x.float() for x in (q, k, v))
        want = (pref.attention_ref(*args, causal=causal, q_offset=q_offset)
                if mode == "exact" else port_attn.flash_attention_plain(
                    *args, causal=causal, q_offset=q_offset,
                    softmax_mode=mode))
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-3)

    @pytest.mark.parametrize("dims,causal,q_offset,mode,atol",
                             TC_DEQUANT_CASES)
    def test_dequant_within_1e3_of_float32_before_rounding(
            self, dims, causal, q_offset, mode, atol):
        q, (kq, ks, vq, vs) = _tc_inputs(dims, quant=True)
        got = _tensor_core_body(q, kq, vq, causal, q_offset, mode, ks=ks,
                                vs=vs)
        if mode == "exact":
            want = pref.attention_dequant_ref(q.float(), kq, ks, vq, vs,
                                              causal=causal, q_offset=q_offset)
        else:
            want = port_attn.flash_attention_dequant_plain(
                q.float(), kq, ks, vq, vs, causal=causal, q_offset=q_offset,
                softmax_mode=mode)
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-3)

    def test_split_p_beats_a_single_bf16_p(self):
        """The hi + lo split keeps p to about 2^-16 relative: replacing it
        by p_hi alone moves the float32 output by far more."""
        q, (k, v) = _tc_inputs((1, 64, 64, 4, 2, 32), quant=False, seed=70)
        oracle = pref.attention_ref(*(x.float() for x in (q, k, v)))
        split = _tensor_core_body(q, k, v)
        b, s, h, d = q.shape
        scores = torch.einsum("bskgd,btkd->bkgst",
                              q.float().reshape(b, s, 2, 2, d), k.float())
        scores = scores / math.sqrt(d)
        mask = torch.arange(64)[None, :] <= torch.arange(64)[:, None]
        p = torch.softmax(torch.where(mask, scores, pref.NEG_INF), dim=-1)
        single = torch.einsum("bkgst,btkd->bkgsd",
                              p.to(torch.bfloat16).float(), v.float())
        single = single.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)
        err_split = float((split - oracle).abs().max())
        err_single = float((single - oracle).abs().max())
        assert err_split < 1e-5 < err_single


# ---------------------------------------------------------------------------
# The decode kernel's split-KV partition and combine, modelled on the CPU
# ---------------------------------------------------------------------------


def _join(states, mode):
    """The kernel's log-sum-exp join of (m, l, acc) states, in order."""
    mt = states[0][0]
    for m, _, _ in states[1:]:
        mt = torch.maximum(mt, m)
    lt = torch.zeros_like(mt)
    at = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = port_attn._exp(m - mt, mode)
        lt = lt + l * f
        at = at + acc * f[..., None]
    return mt, lt, at


def _split_kv_model(q, k, v, kv_valid_len, tables=None, ks=None, vs=None,
                    softmax_mode="exact", kv_splits=1, warps=4):
    """``decode_attention_kernel`` (``csrc/decode_attention.cu``) in plain
    PyTorch: split s of a slot owns the logical rows [s * per, s * per +
    per), per = ceil(n / kv_splits) rounded up to the tile; the block's
    warps take its tiles in turn with an online softmax each (scores
    scaled by the row's K scale, p by its V scale for PV); the warps are
    joined in warp order, the splits in rank order."""
    if tables is not None:
        k, v = port_attn._paged_rows(k, tables), port_attn._paged_rows(v, tables)
        if ks is not None:
            ks, vs = (port_attn._paged_rows(ks, tables),
                      port_attn._paged_rows(vs, tables))
    b, _, h, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    tile = port_attn.DECODE_TILE
    qs = q.float().reshape(b, nkv, h // nkv, d) * (1.0 / math.sqrt(d))
    out = torch.zeros(b, nkv, h // nkv, d)
    empty = (torch.full((nkv, h // nkv), pref.NEG_INF),
             torch.zeros(nkv, h // nkv), torch.zeros(nkv, h // nkv, d))
    for bi in range(b):
        n = max(0, min(int(kv_valid_len[bi]), t))
        per = -(-(-(-n // kv_splits)) // tile) * tile
        splits = []
        for s in range(kv_splits):
            r0 = min(n, s * per)
            r1 = min(n, r0 + per)
            n_tiles = -(-(r1 - r0) // tile)
            states = []
            for w in range(warps):
                m, l, acc = empty
                for j in range(w, n_tiles, warps):
                    rows = slice(r0 + j * tile, min(r0 + (j + 1) * tile, r1))
                    sc = torch.einsum("kgd,rkd->kgr", qs[bi],
                                      k[bi, rows].float())
                    if ks is not None:
                        sc = sc * ks[bi, rows].float()
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    alpha = port_attn._exp(m - m_new, softmax_mode)
                    p = port_attn._exp(sc - m_new[..., None], softmax_mode)
                    l = l * alpha + p.sum(dim=-1)
                    if vs is not None:
                        p = p * vs[bi, rows].float()
                    acc = (acc * alpha[..., None]
                           + torch.einsum("kgr,rkd->kgd", p,
                                          v[bi, rows].float()))
                    m = m_new
                states.append((m, l, acc))
            splits.append(_join(states, softmax_mode))
        _, lt, at = _join(splits, softmax_mode)
        out[bi] = at / torch.clamp(lt, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


# (name, case, atol): the decode layouts at a small size, 4 slots of up to
# 256 rows over 2 KV heads; lengths at a tile's edges, a full slot, an
# empty one, and lengths shorter than one split
_SPLIT_LAYOUTS = [
    ("dense", {"dims": (4, 256, 8, 2, 32)}, 2e-5),
    ("dense-bf16", {"dims": (4, 256, 8, 2, 32), "dtype": "bfloat16"}, 1e-2),
    ("int8", {"dims": (4, 256, 8, 2, 32), "quant": True}, 2e-5),
    ("paged", {"dims": (4, 256, 8, 2, 32), "paged": (64, 16, 16),
               "shuffled": True}, 2e-5),
    ("paged-int8-bf16", {"dims": (4, 256, 8, 2, 32), "paged": (64, 16, 16),
                         "shuffled": True, "quant": True,
                         "dtype": "bfloat16"}, 1e-2),
]
_SPLIT_VALID = {"edges": (256, 33, 1, 0), "short": (7, 31, 32, 65)}
_SPLIT_CACHE = {}


def _jax_exact(x):
    """A tensor as a JAX array of the same type (bf16 through float32,
    which holds it exactly)."""
    if x.dtype == torch.bfloat16:
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return _jax(x)


def _split_case(layout, valid, mode):
    name, case, atol = {c[0]: c for c in _SPLIT_LAYOUTS}[layout]
    case = dict(case, valid=_SPLIT_VALID[valid], softmax_mode=mode, seed=9)
    args, kwargs = port_registry.get("decode_attention").make_example(case)
    key = (layout, valid, mode)
    if key not in _SPLIT_CACHE:      # the Pallas kernel, once per inputs
        ref_kw = {k: _jax(kwargs[k]) for k in ("ks", "vs") if k in kwargs}
        if "tables" in kwargs:
            n_pages = args[1].shape[0]
            ref_kw["tables"] = _jax(kwargs["tables"].clamp(0, n_pages - 1))
        _SPLIT_CACHE[key] = f32(ref_kernels.decode_attention(
            *map(_jax_exact, args), softmax_mode=mode, **ref_kw))
    return args, kwargs, atol, _SPLIT_CACHE[key]


class TestSplitKvModel:
    @pytest.mark.parametrize("kv_splits", port_registry.get(
        "decode_attention").space["kv_splits"])
    @pytest.mark.parametrize("valid", sorted(_SPLIT_VALID))
    @pytest.mark.parametrize("layout", [c[0] for c in _SPLIT_LAYOUTS])
    def test_exact_vs_oracle_and_pallas_interpret(self, layout, valid,
                                                  kv_splits):
        args, kwargs, atol, pallas = _split_case(layout, valid, "exact")
        kw = {k: v for k, v in kwargs.items() if k != "softmax_mode"}
        got = _split_kv_model(*args, **kw, kv_splits=kv_splits)
        want = pref.decode_attention_ref(*args, **kw)
        assert got.dtype == args[0].dtype
        np.testing.assert_allclose(f32(got), f32(want), atol=atol)
        np.testing.assert_allclose(f32(got), pallas, atol=atol)
        if valid == "edges":
            assert not f32(got)[3].any()              # valid 0 gives zeros

    @pytest.mark.parametrize("kv_splits", port_registry.get(
        "decode_attention").space["kv_splits"])
    @pytest.mark.parametrize("layout", ["dense", "paged-int8-bf16"])
    def test_taylor_vs_oracle_and_pallas_interpret(self, layout, kv_splits):
        """The Eq. 2 exp, in every online-softmax step and in both joins,
        within 5e-2 of the exact oracle and of the Pallas kernel's own
        Eq. 2 body."""
        args, kwargs, _, pallas = _split_case(layout, "edges", "taylor")
        got = _split_kv_model(*args, **kwargs, kv_splits=kv_splits)
        kw = {k: v for k, v in kwargs.items() if k != "softmax_mode"}
        np.testing.assert_allclose(
            f32(got), f32(pref.decode_attention_ref(*args, **kw)), atol=5e-2)
        np.testing.assert_allclose(f32(got), pallas, atol=5e-2)

    @pytest.mark.parametrize("kv_splits", [1, 2, 4, 8])
    def test_dense_and_paged_take_the_same_sums(self, kv_splits):
        """The partition is over logical rows: the paged body's rows are
        the dense body's, so the model gives the same bits."""
        case = {"dims": (4, 256, 8, 2, 32), "valid": (256, 100, 3, 77),
                "paged": (64, 16, 16), "shuffled": True, "seed": 4}
        args, kwargs = port_registry.get("decode_attention").make_example(
            case)
        q, kp, vp, valid = args
        tables = kwargs.pop("tables")
        dense_k = port_attn._paged_rows(kp, tables)
        dense_v = port_attn._paged_rows(vp, tables)
        paged = _split_kv_model(q, kp, vp, valid, tables=tables,
                                kv_splits=kv_splits)
        dense = _split_kv_model(q, dense_k, dense_v, valid,
                                kv_splits=kv_splits)
        assert torch.equal(paged, dense)


class TestDecodePlanner:
    @pytest.mark.parametrize("source_constant,name", [
        ("kDecodeStages", "DECODE_STAGES"),
        ("kDecodeRowPad", "DECODE_ROW_PAD"),
        ("kDecodeMaxSplits", "DECODE_MAX_SPLITS"),
        ("kDecodeMaxThreads", "DECODE_MAX_THREADS"),
        ("kDecodeMaxSmem", "MAX_DYNAMIC_SMEM"),
    ])
    def test_constants_match_cuda_source(self, source_constant, name):
        import re

        from repro_torch.kernels import build

        text = (build.CSRC_DIR / "decode_attention.cu").read_text()
        found = re.findall(rf"constexpr int {source_constant} = (\d+);",
                           text)
        assert found == [str(getattr(port_attn, name))]

    def test_smem_formula_matches_cuda_source(self):
        from repro_torch.kernels import build

        text = " ".join((build.CSRC_DIR / "decode_attention.cu")
                        .read_text().split())
        for line in (
                "return 2LL * kDecodeTile * (d * kv_bytes + kDecodeRowPad) "
                "+ 2LL * kDecodeTile * 4;",
                "return kDecodeStages * decode_stage_bytes(d, kv_bytes) + "
                "4LL * kDecodeChunkG * kDecodeTile;",
                "return 4LL * kDecodeChunkG * d + warps * decode_warp_bytes(d, "
                "kv_bytes) + 4LL * splits * kDecodeChunkG * (d + 2);",
                "return (g + kDecodeChunkG - 1) / kDecodeChunkG;"):
            assert line in text

    @pytest.mark.parametrize("d", port_attn.HEAD_DIMS)
    @pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16,
                                          torch.int8])
    def test_every_legal_config_fits_shared_memory(self, d, kv_dtype):
        spec = port_registry.get("decode_attention")
        q = torch.zeros(8, 1, 16, d, device="meta")
        # a cache long enough for every split count of the space
        k = torch.zeros(8, 4096, 8, d, dtype=kv_dtype, device="meta")
        for threads in spec.space["threads"] + (512,):
            for splits in spec.space["kv_splits"]:
                cfg = port_registry_mod._legalize_decode(
                    {"threads": threads, "kv_splits": splits}, q, k)
                assert 1 <= cfg["kv_splits"] <= splits
                assert cfg["threads"] % 32 == 0 and cfg["threads"] <= threads
                assert port_attn.decode_smem_bytes(
                    d, cfg["threads"], k.element_size(), cfg["kv_splits"]
                ) <= port_attn.MAX_DYNAMIC_SMEM
                assert port_registry_mod._legalize_decode(
                    dict(cfg), q, k) == cfg

    @pytest.mark.parametrize("nkv,t,want", [
        (8, 1024, 2),          # serve_lm: 512 rows a split
        (8, 512, 1),           # qwen3 widths
        (8, 4096, 8),          # a long cache: 8 splits of 512 rows
        (32, 4096, 4),         # 32 heads: one slot's 128 blocks
        (128, 4096, 1),        # 128 heads fill the card alone
        (8, 64, 1),
        (1, 16, 1),
    ])
    def test_default_splits_fill_the_card(self, nkv, t, want):
        """A split gets at least DECODE_SPLIT_ROWS rows and one slot's
        blocks never outnumber the SMs, whatever the batch."""
        assert port_attn.decode_kv_splits(nkv, t, 8) == want
        assert port_attn.decode_kv_splits(nkv, t, 8, n_sm=66) <= want
