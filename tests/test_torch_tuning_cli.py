"""The tuner's command line, ``python -m repro_torch.kernels.tuning``, on the
CPU.

``--selfcheck --device cpu`` runs the wrappers' plain versions (the
kernels run only on the card, where ``chip_smoke.py``'s ``tuning`` phase
runs the same command line); ``--pretune`` times kernels and takes the card
only, so its cache path is tested here with a stub timer.  The default
device is the card, and a host without one raises instead of moving to the
CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.registry import registry
from repro_torch.kernels.softmax import ref as softmax_ref

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path))
    monkeypatch.delenv(tuning.TUNE_ENV, raising=False)
    return tmp_path


def entries(cache_dir):
    return json.loads((cache_dir / "autotune.json").read_text())["entries"]


class TestSelfcheck:
    def test_module_command_line_on_the_cpu(self, cache_dir):
        """``python -m``: this module also runs as ``__main__`` there, and
        every spec's example cases agree with their plain versions."""
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.kernels.tuning",
             "--selfcheck", "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": str(REPO / "src")})
        assert proc.returncode == 0, proc.stdout + proc.stderr
        n_cases = sum(len(registry.get(n).example_cases)
                      for n in registry.names())
        assert proc.stdout.count(": ok") == n_cases
        assert "FAIL" not in proc.stdout

    def test_disagreement_fails(self, monkeypatch, capsys):
        monkeypatch.setattr(softmax_ref, "taylor_softmax_ref",
                            lambda x: torch.zeros_like(x))
        assert tuning.main(["--selfcheck", "--device", "cpu"]) == 1
        out = capsys.readouterr().out
        assert "taylor_softmax case#0" in out and "FAILED" in out

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tuning.main(["--selfcheck"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tuning.main(["--pretune", "all"])


def stub_timer(fn, warmup, iters):
    """Runs the candidate once (the plain version, on the CPU) and gives
    each a distinct time, so the cache path is exercised without a card."""
    fn()
    stub_timer.calls += 1
    return 1.0 / stub_timer.calls


stub_timer.calls = 0


def pretune(names, force=False):
    return tuning._pretune(registry, names, torch.device("cpu"), warmup=0,
                           iters=1, force=force, timer=stub_timer)


class TestPretune:
    def test_writes_a_cache_entry_per_case(self, cache_dir, capsys):
        assert pretune(["taylor_softmax"]) == 0
        spec = registry.get("taylor_softmax")
        keys = {tuning.cache_key_for(spec, spec.make_example(c)[0])
                for c in spec.example_cases}
        got = entries(cache_dir)
        assert set(got) == keys
        for key, entry in got.items():
            assert key.startswith("taylor_softmax|cpu|")
            assert tuning.config_label(entry["config"]) in entry["timings"]
        assert str(cache_dir) in capsys.readouterr().out

    def test_cached_unless_forced(self, cache_dir, capsys):
        assert pretune(["fused_sampling"]) == 0
        capsys.readouterr()
        assert pretune(["fused_sampling"]) == 0
        n = len(registry.get("fused_sampling").example_cases)
        assert capsys.readouterr().out.count(": cached") == n
        assert pretune(["fused_sampling"], force=True) == 0
        assert ": cached" not in capsys.readouterr().out

    def test_the_cpu_is_refused(self, cache_dir, capsys):
        """The CPU has no kernel to time: ``--pretune`` takes the card."""
        with pytest.raises(SystemExit) as e:
            tuning.main(["--pretune", "taylor_softmax", "--device", "cpu"])
        assert e.value.code == 2
        assert "on the card" in capsys.readouterr().err
        assert not (cache_dir / "autotune.json").exists()

    def test_unknown_kernel_is_refused(self, cache_dir):
        with pytest.raises(ValueError, match="unknown kernel"):
            tuning.main(["--pretune", "nope", "--device", "cpu"])

    def test_no_action_prints_help(self, capsys):
        assert tuning.main([]) == 0
        assert "--pretune" in capsys.readouterr().out

    def test_winner_is_a_legal_candidate(self, cache_dir):
        assert pretune(["fused_routing"]) == 0
        spec = registry.get("fused_routing")
        for case in spec.example_cases:
            args, kwargs = spec.make_example(case)
            entry = entries(cache_dir)[tuning.cache_key_for(spec, args)]
            assert entry["config"] in tuning.candidate_configs(
                spec, *args, **kwargs)
