"""The command's exits where a cell cannot run."""

import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT


def _run(cwd, *args):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_no_card_no_result(no_card):
    p = _run(ROOT, "--workload", "ground16_f64.wf", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_unknown_workload(no_card):
    p = _run(ROOT, "--workload", "nope", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode == 2 and not p.stdout.strip()


def test_bare_checkout_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files:
    no program to run, so no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, "--workload", "ground16_f64.wf", "--seed", "1",
             "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and not p.stdout.strip()
