"""The counting rule ``chip_smoke.py`` applies to every profiler trace, on
the CPU.

``torch.profiler`` now and then drops kernel events from a trace on the
card: all of them, or some (8 of 20 launches of the routing kernel in one
trace, the host's 20 launch calls all there).  A device time divided by
the calls then reads low.  ``chip_smoke.trace_rule`` counts the events a
trace holds against the launches the traced calls made (each wrapper's
``launches`` counter, the host's launch calls for every kernel) and gives
None with ``trace_dropped`` for a trace that lacks any; it divides device
time by the events seen.  The rule and its helper are loaded from the
script's source, without the card the script itself insists on.

The serving paths ``chip_smoke.py`` runs on the card for ROADMAP §C 1-5
are held against the JAX reference on the CPU, at a small size, by:

1. the host spill and prefix eviction under preemption:
   ``test_torch_paged_engine.py`` (``test_spill_and_resume_match_reference``,
   ``test_pressure_matches_reference_and_generate``: preemption, spill and
   eviction in one serve, and ``generate()`` equal to its tokens);
2. ``generate()`` and the priority, interleave and SLO-batching
   schedulers: ``test_torch_lm_engine.py``
   (``test_greedy_tokens_equal_reference_kernel_engine``, every scheduler)
   and ``test_torch_paged_engine.py``;
3. the vlm cross path with image features and the gates at 0.5:
   ``test_torch_vlm.py`` (``TestForward``, with
   ``test_kernel_path_prefill_and_decode_match_reference`` through the
   flash and decode kernels' plain versions);
4. the moe scatter dispatch equal to the one-hot one, and moe and vlm
   disaggregated: ``test_torch_moe.py`` (``test_moe_apply_matches_reference``
   for both dispatches) and ``test_torch_family_engine.py``
   (``test_disaggregated_matches_generate_under_every_transport``,
   ``test_ragged_moe_serving_equals_per_request_generate``);
5. the ssm and hybrid handoffs over every transport, bf16 parameters and
   the launcher: ``test_torch_recurrent.py``
   (``test_disaggregated_matches_unified``,
   ``test_handoff_carries_float32_state``,
   ``test_bf16_compute_matches_reference``,
   ``test_serves_the_recurrent_families_on_the_cpu``,
   ``test_refuses_the_encoder``) and ``test_torch_family_engine.py``.
"""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
NAMES = ("trace_rule", "expected_launches", "NOT_KERNELS", "KERNEL_EVENT")

ROUTING = "void fastcaps::fused_routing_kernel<float, true, 1>(float const*)"
SOFTMAX = "void fastcaps::taylor_softmax_tile_kernel<float, 1>(float const*)"
SOFTMAX_BWD = "void fastcaps::taylor_softmax_bwd_tile_kernel<float>(float*)"
ADD = "void at::native::vectorized_elementwise_kernel<4, add>"
COPY = "Memcpy DtoD (Device -> Device)"


def _load():
    """The rule's functions and constants from the script's source alone
    (the script exits at import without a CUDA device)."""
    tree = ast.parse(SCRIPT.read_text())
    keep = [node for node in tree.body
            if (isinstance(node, ast.FunctionDef) and node.name in NAMES)
            or (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) in NAMES
                        for t in node.targets))]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(SCRIPT),
                 "exec"), ns)
    assert all(name in ns for name in NAMES)
    return ns


RULE = _load()
trace_rule = RULE["trace_rule"]
expected_launches = RULE["expected_launches"]


def test_a_full_trace_gives_device_time_over_the_events_seen():
    rows = [(ROUTING, 20, 226.0), (ADD, 20, 42.0), (COPY, 20, 30.0)]
    ms, info = trace_rule(rows, {"": 40, "fused_routing_kernel": 20,
                                 "Memcpy": 20}, n_calls=20)
    assert not info["trace_dropped"]
    assert ms[ROUTING] == pytest.approx(0.0113)
    assert ms[ADD] == pytest.approx(0.0021)
    assert ms[COPY] == pytest.approx(0.0015)
    assert info["events"] == {"": 40, "fused_routing_kernel": 20,
                              "Memcpy": 20}
    assert info["ms_per_launch"]["fused_routing_kernel"] == pytest.approx(
        0.0113)
    # every kernel: (226 + 42) us over 40 launches
    assert info["ms_per_launch"][""] == pytest.approx(0.0067)


def test_a_trace_missing_events_gives_none_and_trace_dropped():
    """The card's partial trace: 8 of 20 routing events (90.3 us), which
    the old rule read as 0.0045 ms a call against a full trace's 0.0113."""
    rows = [(ROUTING, 8, 90.31)]
    ms, info = trace_rule(rows, {"": 20, "fused_routing_kernel": 20},
                          n_calls=20)
    assert ms is None and info["trace_dropped"]
    assert info["events"] == {"": 8, "fused_routing_kernel": 8}
    assert info["launches"] == {"": 20, "fused_routing_kernel": 20}
    assert "ms_per_launch" not in info


def test_a_dropped_library_kernel_drops_the_trace():
    """The wrapper's own events are all there, another kernel's are not:
    the host's launch calls see it."""
    rows = [(ROUTING, 20, 226.0), (ADD, 12, 25.0)]
    ms, info = trace_rule(rows, {"": 40, "fused_routing_kernel": 20},
                          n_calls=20)
    assert ms is None and info["trace_dropped"]


@pytest.mark.parametrize("expected", [{"": 1}, {"": 0}, {}])
def test_an_empty_trace_gives_none(expected):
    ms, info = trace_rule([], expected, n_calls=1)
    assert ms is None and info["trace_dropped"]


def test_copies_are_no_kernel_launches_and_count_when_asked():
    """``x.clone()``: one copy a call and no kernel launch."""
    ms, info = trace_rule([(COPY, 20, 30.0)], {"": 0, "Memcpy": 20},
                          n_calls=20)
    assert not info["trace_dropped"] and ms[COPY] == pytest.approx(0.0015)
    ms, info = trace_rule([(COPY, 19, 28.5)], {"": 0, "Memcpy": 20},
                          n_calls=20)
    assert ms is None and info["trace_dropped"]


def test_a_kernel_launched_twice_a_call():
    """Per call the trace's device time over the calls, per launch over
    the events."""
    ms, info = trace_rule([(SOFTMAX, 40, 120.0)],
                          {"": 40, "taylor_softmax": 40}, n_calls=20)
    assert ms[SOFTMAX] == pytest.approx(0.006)
    assert info["ms_per_launch"]["taylor_softmax"] == pytest.approx(0.003)


def test_expected_launches_from_the_counters():
    """Each wrapper's counter growth under its kernel's name fragment; a
    fragment inside another wrapper's kernel name (the forward softmax's
    in the backward's) expects that wrapper's launches too."""
    names = list(RULE["KERNEL_EVENT"])
    before = dict.fromkeys(names, 5)
    after = dict(before, taylor_softmax=8, taylor_softmax_bwd=7,
                 fused_routing=6)
    want = expected_launches(before, after, host_calls=11)
    assert want == {"": 11, "taylor_softmax": 5, "taylor_softmax_bwd": 2,
                    "fused_routing_kernel": 1}
    rows = [(SOFTMAX, 3, 9.0), (SOFTMAX_BWD, 2, 8.0), (ROUTING, 1, 11.0),
            (ADD, 5, 10.0)]
    ms, info = trace_rule(rows, want, n_calls=1)
    assert not info["trace_dropped"]
    assert info["ms_per_launch"]["taylor_softmax_bwd"] == pytest.approx(
        0.004)
    short = [(SOFTMAX, 3, 9.0), (SOFTMAX_BWD, 1, 4.0), (ROUTING, 1, 11.0),
             (ADD, 6, 12.0)]
    assert trace_rule(short, want, n_calls=1)[0] is None


def test_the_flash_wrappers_share_one_fragment():
    names = list(RULE["KERNEL_EVENT"])
    before = dict.fromkeys(names, 0)
    after = dict(before, flash_attention=16, flash_attention_dequant=4)
    assert expected_launches(before, after, host_calls=20) == {
        "": 20, "flash_attention_kernel": 20}
