"""The command exits non-zero and prints no result where it cannot measure: without a CUDA
card, and in a directory that holds only ``BENCHMARK.json`` and the benchmark's files."""

import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

ARGS = ["port_bench/run.py", "--workload", "xxl-t2a-5s", "--seed", str(2 ** 31 + 11),
        "--seconds", "1", "--trace", "0"]


def no_result(proc):
    return proc.returncode != 0 and '"correct"' not in proc.stdout


def test_no_card():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, *ARGS], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)
    assert no_result(proc), proc.stdout
    assert "no CUDA card" in proc.stderr


def test_only_the_benchmark(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("on a card the import of the program is what stops it: checked here only")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert no_result(proc), proc.stdout
